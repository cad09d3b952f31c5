"""Eigenbasis CG solve through the hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_cg.py``
(``icar_cg_solve_fused``, ``cg_impl='pallas'``): the whole fixed-iteration
PCG of :func:`.cg.icar_cg_solve_spectral` in one cooperative launch of
``csrc/icar_cg.cu``. The kernel treats every chain's rows as one
(chains * rows, n) batch against one U, tiles each product over the card's
SMs and keeps its vectors in a scratch buffer that this wrapper allocates.
A chain's outputs are bit-identical from launch to launch and whatever
the other chains or the chain count are. On a CPU tensor the wrapper runs
the plain torch solve.
"""

import ctypes

import torch

from .. import _build
from .cg import icar_cg_solve_spectral

#: the kernel indexes its (chains * rows, n) vectors with 32-bit integers
MAX_ELEMENTS = 2 ** 31 - 1

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _library():
    lib = _build.load('icar_cg')
    lib.icar_cg_launch.argtypes = _ARGTYPES
    lib.icar_cg_launch.restype = ctypes.c_int
    lib.icar_cg_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.icar_cg_scratch_floats.restype = ctypes.c_longlong
    return lib


def icar_cg_solve_cuda(rhs, warm_spec, omega, tau, eigvecs, eigvals, iters,
                       return_resid=False):
    """:func:`.cg.icar_cg_solve_spectral` with the CUDA kernel.

    ``rhs``/``warm_spec`` (chains, rows, n), ``omega`` (chains, n),
    ``tau`` (chains,). CUDA tensors go through the kernel (float32
    only, fewer than 2**31 elements in ``rhs``); CPU tensors through the
    plain solve. Each launch of the kernel adds one to
    ``icar_cg_solve_cuda.counter`` on the card (:class:`.._build.
    LaunchCounter`), so a launch recorded into a captured step counts at
    every replay. A stream capture takes the
    cooperative launch as it is (a cooperative kernel node; CUDA 12.8 on
    the H100). The first launch on a device makes the occupancy query
    and the shared-memory attribute call and caches the grid; the graph
    runner's warm-up step makes that launch outside the capture.
    """
    if rhs.device.type == 'cpu':
        return icar_cg_solve_spectral(
            rhs, warm_spec, omega, tau, eigvecs, eigvals, iters,
            return_resid=return_resid,
        )
    if rhs.device.type != 'cuda':
        raise ValueError(f'unsupported device: {rhs.device}')
    if rhs.dtype != torch.float32:
        raise TypeError(
            f'the CUDA CG kernel takes float32, got {rhs.dtype}; run '
            'float64 on the CPU'
        )
    if rhs.dim() != 3:
        raise ValueError('expected rhs (chains, rows, n)')
    chains, rows, n = rhs.shape
    if rhs.numel() > MAX_ELEMENTS:
        raise ValueError(
            f'rhs has {rhs.numel()} elements; the kernel indexes at most '
            f'{MAX_ELEMENTS}'
        )
    if warm_spec.shape != rhs.shape or omega.shape != (chains, n):
        raise ValueError('warm_spec/omega shapes do not match rhs')
    if tuple(eigvecs.shape) != (n, n) or tuple(eigvals.shape) != (n,):
        raise ValueError('eigvecs/eigvals shapes do not match rhs')
    if int(iters) < 0:
        raise ValueError('iters must not be negative')
    dev = rhs.device

    def f32(t):
        return torch.as_tensor(t, device=dev).to(torch.float32).contiguous()

    u, s = f32(eigvecs), f32(eigvals)
    rhs_c, x0, om = f32(rhs), f32(warm_spec), f32(omega)
    tau_c = f32(torch.as_tensor(tau).expand(chains))
    x_site = torch.empty_like(rhs_c)
    x_spec = torch.empty_like(rhs_c)
    rel = torch.empty(chains, device=dev, dtype=torch.float32)
    lib = _library()
    scratch = torch.empty(
        lib.icar_cg_scratch_floats(chains, rows, n), device=dev,
        dtype=torch.float32,
    )
    launches = icar_cg_solve_cuda.counter.pointer(dev)
    with torch.cuda.device(dev):
        err = lib.icar_cg_launch(
            u.data_ptr(), s.data_ptr(), rhs_c.data_ptr(), x0.data_ptr(),
            om.data_ptr(), tau_c.data_ptr(), x_site.data_ptr(),
            x_spec.data_ptr(), rel.data_ptr(), scratch.data_ptr(), launches,
            chains, rows, n, int(iters),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, 'icar_cg', err)
    if return_resid:
        return x_site, x_spec, rel
    return x_site, x_spec


icar_cg_solve_cuda.counter = _build.LaunchCounter('icar_cg')
