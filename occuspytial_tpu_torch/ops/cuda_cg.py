"""Eigenbasis CG solve through the hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_cg.py``
(``icar_cg_solve_fused``, ``cg_impl='pallas'``): the whole fixed-iteration
PCG of :func:`.cg.icar_cg_solve_spectral` in one cooperative launch of
``csrc/icar_cg.cu``. The kernel treats every chain's rows as one
(chains * rows, n) batch against one U, tiles each product over the card's
SMs on ``wgmma`` fed by TMA and keeps its vectors in a scratch buffer that
this wrapper allocates. Its products read U and U' K-major, each split
into a TF32 head and remainder (:func:`k3_operands`, made once per
sampler). A chain's outputs are bit-identical from launch to launch and
whatever the other chains or the chain count are. On a CPU tensor the
wrapper runs the plain torch solve.
"""

import ctypes

import torch

from .. import _build
from .cg import icar_cg_solve_spectral

#: the kernel indexes its (chains * rows, n) vectors with 32-bit integers
MAX_ELEMENTS = 2 ** 31 - 1

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def row_stride(n):
    """The kernel's row stride for rows of length ``n``: ``n`` rounded up
    to 4 floats, the 16 bytes TMA needs between rows."""
    return (int(n) + 3) // 4 * 4


def _from_bits(bits):
    """float32 numbers from their bits held in int64 (0 .. 2**32 - 1)."""
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_split(x):
    """``x`` (float32) as head + remainder, both TF32 numbers (the low 13
    mantissa bits clear), by the kernel's integer arithmetic on the bits:
    the head is ``x`` rounded to nearest at 10 mantissa bits, the
    remainder ``x - head`` (exact in float32) cut to 10 bits, so that
    ``|x - head - remainder| <= 2**-22 |x|``."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    head = _from_bits((bits + 0x1000) & 0xFFFFE000)
    rest = (x - head).view(torch.int32).to(torch.int64) & 0xFFFFE000
    return head, _from_bits(rest)


def k3_operands(eigvecs):
    """The eigenbasis as K3's products read it: a (4, n, ld) float32
    tensor on ``eigvecs``' device holding the TF32 head of U, its
    remainder, the head of U' and its remainder (:func:`tf32_split`),
    each row zero-padded to ``ld = row_stride(n)``. ``p U'`` reads U as
    its K-major operand and ``w U`` reads U'. Made once per sampler
    (``LogitICARGibbs`` keeps it in ``fixed['k3_operands']`` on the
    card), else by :func:`icar_cg_solve_cuda` at every call."""
    u = eigvecs.to(torch.float32)
    n = u.shape[0]
    out = torch.zeros((4, n, row_stride(n)), dtype=torch.float32,
                      device=u.device)
    for i, m in enumerate((u, u.T)):
        head, rest = tf32_split(m)
        out[2 * i, :, :n] = head
        out[2 * i + 1, :, :n] = rest
    return out


def _strided(t, ld):
    """``t`` (..., n) as the kernel reads it: 16-byte aligned at row
    stride ``ld``, zero-padded; copied only when it is not so already."""
    n = t.shape[-1]
    if ld == n and t.data_ptr() % 16 == 0:
        return t
    out = torch.zeros(t.shape[:-1] + (ld,), dtype=t.dtype, device=t.device)
    out[..., :n] = t
    return out


def _library():
    lib = _build.load('icar_cg')
    lib.icar_cg_launch.argtypes = _ARGTYPES
    lib.icar_cg_launch.restype = ctypes.c_int
    lib.icar_cg_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.icar_cg_scratch_floats.restype = ctypes.c_longlong
    return lib


def icar_cg_solve_cuda(rhs, warm_spec, omega, tau, eigvecs, eigvals, iters,
                       return_resid=False, operands=None):
    """:func:`.cg.icar_cg_solve_spectral` with the CUDA kernel.

    ``rhs``/``warm_spec`` (chains, rows, n), ``omega`` (chains, n),
    ``tau`` (chains,). CUDA tensors go through the kernel (float32
    only, fewer than 2**31 elements in ``rhs``); CPU tensors through the
    plain solve, which ignores ``operands``. ``operands`` is
    :func:`k3_operands` of ``eigvecs``, made here when not given (the
    same bits either way). Each launch of the kernel adds one to
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

    ld = row_stride(n)
    if operands is None:
        operands = k3_operands(torch.as_tensor(eigvecs, device=dev))
    elif (tuple(operands.shape) != (4, n, ld)
          or operands.dtype != torch.float32 or operands.device != dev
          or not operands.is_contiguous()):
        raise ValueError(
            f'operands must be k3_operands(eigvecs): (4, {n}, {ld}) '
            f'contiguous float32 on {dev}'
        )
    s = _strided(f32(eigvals), ld)
    rhs_c = _strided(f32(rhs), ld)
    x0 = _strided(f32(warm_spec), ld)
    om = _strided(f32(omega), ld)
    tau_c = f32(torch.as_tensor(tau).expand(chains))
    x_site = torch.empty((chains, rows, ld), device=dev, dtype=torch.float32)
    x_spec = torch.empty_like(x_site)
    rel = torch.empty(chains, device=dev, dtype=torch.float32)
    lib = _library()
    scratch = torch.empty(
        lib.icar_cg_scratch_floats(chains, rows, n), device=dev,
        dtype=torch.float32,
    )
    launches = icar_cg_solve_cuda.counter.pointer(dev)
    with torch.cuda.device(dev):
        err = lib.icar_cg_launch(
            operands.data_ptr(), s.data_ptr(), rhs_c.data_ptr(),
            x0.data_ptr(), om.data_ptr(), tau_c.data_ptr(),
            x_site.data_ptr(), x_spec.data_ptr(), rel.data_ptr(),
            scratch.data_ptr(), launches, chains, rows, n, int(iters),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, 'icar_cg', err)
    if ld != n:
        x_site = x_site[..., :n].contiguous()
        x_spec = x_spec[..., :n].contiguous()
    if return_resid:
        return x_site, x_spec, rel
    return x_site, x_spec


icar_cg_solve_cuda.counter = _build.LaunchCounter('icar_cg')
