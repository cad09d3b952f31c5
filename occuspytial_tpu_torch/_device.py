"""Device and dtype resolution shared by the port's entry points."""

import numpy as np
import torch


def resolve_device(device=None):
    """The torch device an entry point runs on.

    ``None`` means ``'cuda'``: the port runs on the card unless the caller
    asks for the CPU (``device='cpu'``, as the tests do). Without CUDA the
    default raises instead of falling back.

    On CUDA this also turns TF32 off for matrix products and convolutions,
    so every float32 ``torch.matmul`` on the card is a true float32
    product, as on the CPU reference.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to run the '
                'plain PyTorch path on the CPU'
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def resolve_dtype(dtype):
    """A torch floating dtype from a torch dtype, numpy dtype or name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    out = {'float32': torch.float32, 'float64': torch.float64}.get(name)
    if out is None:
        raise ValueError(f'unsupported dtype: {dtype!r}')
    return out
