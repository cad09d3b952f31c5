"""Carry the JAX package's sampler state across to the port.

The sampler's "weights" are its fixed arrays, which the port builds from
numpy exactly as the JAX package does, and its carry. A JAX carry is
``(keys, states)``: per-chain typed threefry keys and a dict of batched
state arrays; its ``save_carry`` writes ``__keys__`` (the (chains, 2)
uint32 key data) and one array per state entry to an ``.npz``. The port
uses the key data directly as its chain key words (both are Threefry-2x32
keys), so a JAX run's state continues in the port, with the port's own
stream from those keys.
"""

import numpy as np
import torch

from ._device import resolve_device
from .models.base import Carry


def carry_from_jax(key_words, states, device=None, dtype=torch.float32,
                   step=0):
    """The port's :class:`~.models.base.Carry` from a JAX carry given as
    numpy arrays: ``key_words`` (chains, 2) uint32 (``jax.random.
    key_data`` of the carry's keys) and ``states`` name -> (chains, ...)
    array. Floating entries become ``dtype`` on ``device`` (``None``
    means ``'cuda'``, and raises without it)."""
    device = resolve_device(device)
    words = np.asarray(key_words)
    if words.ndim != 2 or words.shape[1] != 2:
        raise ValueError(
            f'expected (chains, 2) key words, got shape {words.shape}'
        )
    keys = torch.as_tensor(
        words.astype(np.uint32).astype(np.int64), device=device
    )
    out = {}
    for name, val in states.items():
        arr = np.asarray(val)
        t = torch.tensor(arr, device=device)
        out[name] = t.to(dtype) if arr.dtype.kind == 'f' else t
    return Carry(keys, out, int(step))
