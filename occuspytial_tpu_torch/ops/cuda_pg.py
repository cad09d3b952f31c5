"""Pólya-Gamma PG(1, z) through the hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_pg.py``: both of its
option names (``pg_method='pallas'`` for ``_pg_kernel`` and
``'pallas_packed'`` for ``_pg_kernel_grouped``) map to the one kernel in
``csrc/pg_devroye.cu``, one thread per (chain, lane), whose counter-based
stream keeps the per-chain key contract of both. The z-dependent mixture
quantities are computed here with torch ops, as ``_pg_inputs`` does in
XLA. On a CPU tensor the wrapper runs the plain sampler
:func:`.polyagamma.pg_devroye`, which draws the same uniforms.
"""

import ctypes

import torch

from .. import _build
from .polyagamma import pg_devroye, pg_inputs

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def pg_devroye_cuda(subkeys, z):
    """Exact PG(1, z) draws for ``z`` (chains, m) with chain b's
    uniforms from ``subkeys[b]`` (int64 words, see ``rng.pg_uniforms``).

    CUDA tensors go through the kernel (float32 only); CPU tensors
    through the plain sampler. Each kernel launch adds one to
    ``pg_devroye_cuda.launches``.
    """
    if z.device.type == 'cpu':
        return pg_devroye(subkeys, z)
    if z.device.type != 'cuda':
        raise ValueError(f'unsupported device: {z.device}')
    if z.dtype != torch.float32:
        raise TypeError(
            f'the CUDA PG kernel takes float32, got {z.dtype}; run '
            'float64 on the CPU'
        )
    if z.dim() != 2 or subkeys.shape != (z.shape[0], 2):
        raise ValueError('expected z (chains, m) and subkeys (chains, 2)')
    c, ratio, k_exp = (t.contiguous() for t in pg_inputs(z))
    # each uint32 key word as the int32 of the same bit pattern (the
    # kernel reads uint32)
    sk = subkeys.to(z.device)
    keys32 = torch.where(sk >= 2 ** 31, sk - 2 ** 32, sk).to(
        torch.int32).contiguous()
    return launch(keys32, c, ratio, k_exp)


def launch(keys32, c, ratio, k_exp):
    """One launch of the kernel on prepared inputs: int32 key words
    (chains, 2) and the contiguous float32 (chains, m) mixture inputs of
    :func:`.polyagamma.pg_inputs`. Returns the draws."""
    chains, m = c.shape
    for t in (c, ratio, k_exp):
        if (t.shape != c.shape or t.dtype != torch.float32
                or t.device != c.device or not t.is_contiguous()):
            raise ValueError('inputs must be contiguous float32 (chains, m)')
    if (keys32.shape != (chains, 2) or keys32.dtype != torch.int32
            or keys32.device != c.device or not keys32.is_contiguous()):
        raise ValueError('keys32 must be contiguous int32 (chains, 2)')
    out = torch.empty_like(c)
    lib = _build.load('pg_devroye')
    lib.pg_devroye_launch.argtypes = _ARGTYPES
    lib.pg_devroye_launch.restype = ctypes.c_int
    err = lib.pg_devroye_launch(
        keys32.data_ptr(), c.data_ptr(), ratio.data_ptr(),
        k_exp.data_ptr(), out.data_ptr(), chains, m,
        torch.cuda.current_stream(c.device).cuda_stream,
    )
    _build.check(lib, 'pg_devroye', err)
    pg_devroye_cuda.launches += 1
    return out


pg_devroye_cuda.launches = 0
