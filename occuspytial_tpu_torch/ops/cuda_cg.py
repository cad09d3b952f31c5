"""Eigenbasis CG solve through the hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_cg.py``
(``icar_cg_solve_fused``, ``cg_impl='pallas'``): the whole fixed-iteration
PCG of :func:`.cg.icar_cg_solve_spectral` in one launch of
``csrc/icar_cg.cu``, one block per chain with the chain's rows in shared
memory. On a CPU tensor the wrapper runs the plain torch solve.
"""

import ctypes

import torch

from .. import _build
from .cg import icar_cg_solve_spectral

#: rows per chain the kernel is instantiated for
MAX_ROWS = 8

#: dynamic shared memory a block may use on Hopper (227 KB), less the
#: kernel's static reduction scratch
_SMEM_LIMIT = 232448 - 2048

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def shared_bytes(rows, n):
    """Dynamic shared memory the kernel needs for ``rows`` rows of n."""
    return (5 * rows + 3) * n * 4


def icar_cg_solve_cuda(rhs, warm_spec, omega, tau, eigvecs, eigvals, iters,
                       return_resid=False):
    """:func:`.cg.icar_cg_solve_spectral` with the CUDA kernel.

    ``rhs``/``warm_spec`` (chains, rows, n), ``omega`` (chains, n),
    ``tau`` (chains,). CUDA tensors go through the kernel (float32
    only); CPU tensors through the plain solve. Each kernel launch adds
    one to ``icar_cg_solve_cuda.launches``.
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
    chains, rows, n = rhs.shape
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f'rows per chain must lie in [1, {MAX_ROWS}]')
    if shared_bytes(rows, n) > _SMEM_LIMIT:
        raise ValueError(
            f'n={n} with {rows} rows needs {shared_bytes(rows, n)} bytes '
            f'of shared memory per block; the kernel holds at most '
            f'{_SMEM_LIMIT}'
        )
    if warm_spec.shape != rhs.shape or omega.shape != (chains, n):
        raise ValueError('warm_spec/omega shapes do not match rhs')
    dev = rhs.device

    def f32(t):
        return torch.as_tensor(t, device=dev).to(torch.float32).contiguous()

    u, s = f32(eigvecs), f32(eigvals)
    rhs_c, x0, om = f32(rhs), f32(warm_spec), f32(omega)
    tau_c = f32(torch.as_tensor(tau).expand(chains))
    x_site = torch.empty_like(rhs_c)
    x_spec = torch.empty_like(rhs_c)
    rel = torch.empty(chains, device=dev, dtype=torch.float32)
    lib = _build.load('icar_cg')
    lib.icar_cg_launch.argtypes = _ARGTYPES
    lib.icar_cg_launch.restype = ctypes.c_int
    err = lib.icar_cg_launch(
        u.data_ptr(), s.data_ptr(), rhs_c.data_ptr(), x0.data_ptr(),
        om.data_ptr(), tau_c.data_ptr(), x_site.data_ptr(),
        x_spec.data_ptr(), rel.data_ptr(), chains, rows, n, int(iters),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, 'icar_cg', err)
    icar_cg_solve_cuda.launches += 1
    if return_resid:
        return x_site, x_spec, rel
    return x_site, x_spec


icar_cg_solve_cuda.launches = 0
