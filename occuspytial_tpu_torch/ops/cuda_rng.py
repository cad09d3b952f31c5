"""The Threefry draw plan through the hand-written CUDA kernel.

``threefry_plan_kernel`` in ``csrc/pg_devroye.cu`` computes the word plane
of one :class:`..rng.DrawPlan` call in one launch, with the file's one
Threefry-2x32 function, where the plain version (:func:`..rng.
threefry2x32` in int64 torch ops, which ``DrawPlan`` runs on CPU keys) is
some 170 kernels over the whole plane. The words are the same, bit for
bit.
"""

import ctypes

import torch

from .. import _build, rng

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

#: the grid's y dimension holds at most 65,535 blocks
_MAX_CHAINS = 65535


def threefry_plan(keys, x1, step):
    """(chains, 2 * counters) int64 words: columns 2j and 2j + 1 of row b
    are the two words of ``threefry(keys[b], (step, x1[j]))``.

    ``keys`` (chains, 2) int64 key words on a CUDA device, each chain's
    pair adjacent (the rows may be a strided slice, as a subkey slice of
    a step's words is); ``x1`` (counters,) contiguous int64 counters on
    the same device; ``step`` a Python int or a 0-d int64 tensor there
    (read by the kernel, so a captured graph that advances it in place
    draws each step's words). Each launch adds one to
    ``threefry_plan.counter`` on the card (:class:`.._build.
    LaunchCounter`); the launch goes on the current stream.
    """
    if keys.dtype != torch.int64 or x1.dtype != torch.int64:
        raise TypeError(f'keys and counters must be int64, got {keys.dtype} '
                        f'and {x1.dtype}')
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.stride(1) != 1:
        raise ValueError('keys must be (chains, 2) with each chain\'s two '
                         f'words adjacent, got {tuple(keys.shape)} strides '
                         f'{keys.stride()}')
    if x1.dim() != 1 or not x1.is_contiguous():
        raise ValueError('counters must be one contiguous (counters,) row')
    chains, n_ctr = keys.shape[0], x1.shape[0]
    # a block of the grid's y dimension a chain
    if chains > _MAX_CHAINS or n_ctr >= 2 ** 31 - 256:
        raise ValueError(f'the plan takes at most {_MAX_CHAINS} chains and '
                         f'fewer than 2**31 counters, got {chains} and '
                         f'{n_ctr}')
    dev = keys.device
    if dev.type != 'cuda' or x1.device != dev:
        raise ValueError(f'keys and counters must be on one CUDA device, '
                         f'got {dev} and {x1.device}')
    step = rng._step_word(step, keys)
    if isinstance(step, torch.Tensor):
        step_ptr, step_host = step.data_ptr(), 0
    else:
        step_ptr, step_host = None, step & rng.MASK
    out = torch.empty((chains, 2 * n_ctr), dtype=torch.int64, device=dev)
    launches = threefry_plan.counter.pointer(dev)
    lib = _build.load('pg_devroye')
    lib.threefry_plan_launch.argtypes = _ARGTYPES
    lib.threefry_plan_launch.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = lib.threefry_plan_launch(
            keys.data_ptr(), keys.stride(0), x1.data_ptr(), n_ctr, chains,
            step_ptr, step_host, out.data_ptr(), launches,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, 'pg_devroye', err)
    return out


threefry_plan.counter = _build.LaunchCounter('threefry_plan')
