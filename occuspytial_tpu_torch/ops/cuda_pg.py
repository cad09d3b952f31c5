"""Pólya-Gamma PG(1, z) through the hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_pg.py``: both of its
option names (``pg_method='pallas'`` for ``_pg_kernel`` and
``'pallas_packed'`` for ``_pg_kernel_grouped``) map to the one kernel in
``csrc/pg_devroye.cu``, whose counter-based stream keeps the per-chain key
contract of both. The kernel takes ``z`` and the key words as they are:
the mixture quantities that ``_pg_inputs`` computes in XLA
(:func:`.polyagamma.pg_inputs` here) are computed inside it, in the form
of :func:`.polyagamma.mass_texpon_erfcx`, so a draw is one launch with no
torch op before it. On a CPU tensor the wrapper runs the plain sampler
:func:`.polyagamma.pg_devroye`, which draws the same uniforms.
"""

import ctypes

import torch

from .. import _build
from .polyagamma import pg_devroye

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


def pg_devroye_cuda(subkeys, z, lanes=None):
    """Exact PG(1, z) draws for ``z`` (chains, m) with chain b's
    uniforms from ``subkeys[b]`` (int64 words, see ``rng.pg_uniforms``).
    ``lanes`` (m,) int64 on the device of z, optional: column j draws as
    global lane ``lanes[j]`` (one launch draws a band's site and visit
    lanes as the whole field would); without it column j is lane j.

    CUDA tensors go through the kernel (float32 only); CPU tensors
    through the plain sampler. Each launch of the kernel adds one to
    ``pg_devroye_cuda.counter`` on the card (:class:`.._build.
    LaunchCounter`), so a launch recorded into a captured step counts at
    every replay. The launch goes on the current stream, so a stream
    capture takes it as it is.
    """
    if z.device.type == 'cpu':
        return pg_devroye(subkeys, z, lanes)
    if z.device.type != 'cuda':
        raise ValueError(f'unsupported device: {z.device}')
    if z.dtype != torch.float32:
        raise TypeError(
            f'the CUDA PG kernel takes float32, got {z.dtype}; run '
            'float64 on the CPU'
        )
    if z.dim() != 2 or subkeys.shape != (z.shape[0], 2):
        raise ValueError('expected z (chains, m) and subkeys (chains, 2)')
    if subkeys.dtype != torch.int64 or subkeys.device != z.device:
        raise ValueError('subkeys must be int64 words on the device of z')
    if z.numel() >= 2 ** 31:
        raise ValueError('z must hold fewer than 2**31 elements')
    if lanes is not None:
        if (lanes.dtype != torch.int64 or lanes.device != z.device
                or lanes.shape != (z.shape[1],)):
            raise ValueError('lanes must be (m,) int64 on the device of z')
        lanes = lanes.contiguous()
    chains, m = z.shape
    # z is contiguous on the sampler's path, and the kernel reads the key
    # words through their row stride (they are a slice of the step's
    # words), so no kernel runs here
    z = z.contiguous()
    if subkeys.stride(1) != 1:
        subkeys = subkeys.contiguous()
    out = torch.empty_like(z)
    launches = pg_devroye_cuda.counter.pointer(z.device)
    lib = _build.load('pg_devroye')
    lib.pg_devroye_launch.argtypes = _ARGTYPES
    lib.pg_devroye_launch.restype = ctypes.c_int
    with torch.cuda.device(z.device):
        err = lib.pg_devroye_launch(
            subkeys.data_ptr(), subkeys.stride(0),
            None if lanes is None else lanes.data_ptr(), z.data_ptr(),
            out.data_ptr(), chains, m, launches,
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    _build.check(lib, 'pg_devroye', err)
    return out


pg_devroye_cuda.counter = _build.LaunchCounter('pg_devroye')
