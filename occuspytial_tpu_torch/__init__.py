"""occuspytial_tpu_torch: the occupancy Gibbs samplers in PyTorch and CUDA.

The PyTorch port of ``occuspytial_tpu`` (which stays the JAX reference).
Entry points run on the CUDA card unless the caller passes
``device='cpu'``; the Pólya-Gamma draw and the eigenbasis CG solve have
hand-written CUDA kernels (``csrc/``) beside their plain torch versions.
This package imports no JAX and nothing of ``occuspytial_tpu``.
"""

from .chain import Chain
from .data import Data, OccupancyData, pack_detection_data
from .models import (
    LogitICARGibbs,
    LogitRSRGibbs,
    ProbitICARGibbs,
    ProbitRSRGibbs,
)
from .posterior import PosteriorParameter

__all__ = (
    'LogitICARGibbs',
    'LogitRSRGibbs',
    'ProbitICARGibbs',
    'ProbitRSRGibbs',
    'Data',
    'OccupancyData',
    'pack_detection_data',
    'PosteriorParameter',
    'Chain',
)

__version__ = '0.1.0'
