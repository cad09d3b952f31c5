"""The lattice stencil PCG through the hand-written CUDA kernel.

The whole fixed-iteration, DCT-preconditioned CG of
:func:`.stencil.cg_solve` in one launch of ``csrc/stencil_pcg.cu``: one
block a (chain, row) field, every iteration on chip. It replaces no Pallas
kernel (the JAX package leaves its stencil solve to XLA).
:func:`.stencil.cg_solve` takes it for float32 CUDA tensors whose lattice
:func:`fits` (:func:`.stencil.takes_kernel`); every other solve stays in
torch. A field's bits depend on its own inputs alone: the same at every
chain count and from launch to launch.
"""

import ctypes

import torch

from .. import _build

#: the kernel's largest lattice side (``kMaxSide`` of the source): the
#: field and both DCT bases live in one SM's shared memory
MAX_SIDE = 100

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def fits(rows, cols):
    """Whether a ``rows`` x ``cols`` lattice fits the kernel's on-chip
    budget."""
    return 1 <= rows <= MAX_SIDE and 1 <= cols <= MAX_SIDE


def load():
    """The kernel's library, built first if needed (``nvcc``, seconds)."""
    lib = _build.load('stencil_pcg')
    lib.stencil_pcg_launch.argtypes = _ARGTYPES
    lib.stencil_pcg_launch.restype = ctypes.c_int
    return lib


def stencil_pcg_cuda(spec, fixed, rhs, x0, omega, tau, iters,
                     return_resid=False):
    """:func:`.stencil.cg_solve` (``band=None``) in one kernel launch.

    ``rhs``/``x0`` (chains, rows, n), ``omega`` (chains, n), ``tau``
    (chains,) or a scalar, ``fixed`` the lattice's arrays
    (:func:`.stencil.setup`), all float32 on one CUDA device; the lattice
    must :func:`fit <fits>`. Raises on anything else. Returns ``x`` or,
    with ``return_resid=True``, ``(x, rel)`` with ``rel`` (chains,) the
    largest ``||r|| / ||b||`` of a chain's rows. Each launch adds one to
    ``stencil_pcg_cuda.counter`` on the card (:class:`.._build.
    LaunchCounter`), so a launch recorded into a captured step counts at
    every replay; the first launch on a device must come before any
    capture.
    """
    dev = rhs.device
    if dev.type != 'cuda':
        raise ValueError(f'the stencil PCG kernel runs on CUDA, not {dev}')
    if not fits(spec.rows, spec.cols):
        raise ValueError(
            f'a {spec.rows} x {spec.cols} lattice exceeds the kernel\'s '
            f'{MAX_SIDE} x {MAX_SIDE}'
        )
    if rhs.dim() != 3 or rhs.shape[-1] != spec.n:
        raise ValueError(f'expected rhs (chains, rows, {spec.n})')
    chains, rows, n = rhs.shape
    # the fixed arrays the kernel reads
    shapes = {'lat_deg': (spec.rows, spec.cols),
              'lat_dct_r': (spec.rows, spec.rows),
              'lat_dct_c': (spec.cols, spec.cols),
              'lat_sym': (spec.rows, spec.cols)}
    tau = torch.as_tensor(tau, device=dev)
    if tau.dim() == 0:
        tau = tau.expand(chains)
    tensors = {'rhs': (rhs, rhs.shape), 'x0': (x0, rhs.shape),
               'omega': (omega, (chains, n)), 'tau': (tau, (chains,))}
    tensors.update({k: (fixed[k], shape) for k, shape in shapes.items()})
    for name, (t, shape) in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(
                f'the stencil PCG kernel takes float32, got {name} '
                f'{t.dtype}'
            )
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, rhs on {dev}')
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f'{name} has shape {tuple(t.shape)}, expected {tuple(shape)}'
            )
    if int(iters) < 0:
        raise ValueError('iters must not be negative')
    args = [t.contiguous() for t, _ in tensors.values()]
    x = torch.empty_like(args[0])
    rel = (torch.empty((chains, rows), device=dev, dtype=torch.float32)
           if return_resid else None)
    lib = load()
    launches = stencil_pcg_cuda.counter.pointer(dev)
    with torch.cuda.device(dev):
        err = lib.stencil_pcg_launch(
            *(a.data_ptr() for a in args), x.data_ptr(),
            None if rel is None else rel.data_ptr(), launches, chains, rows,
            spec.rows, spec.cols, int(iters), int(spec.max_neighbors == 8),
            float(spec.rho), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, 'stencil_pcg', err)
    if return_resid:
        return x, torch.amax(rel, dim=-1)
    return x


stencil_pcg_cuda.counter = _build.LaunchCounter('stencil_pcg')
