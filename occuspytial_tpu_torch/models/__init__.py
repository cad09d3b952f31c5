"""Gibbs samplers of the port."""

from .logit import LogitICARGibbs, LogitRSRGibbs
from .probit import ProbitICARGibbs, ProbitRSRGibbs

__all__ = (
    'LogitICARGibbs', 'LogitRSRGibbs', 'ProbitICARGibbs', 'ProbitRSRGibbs',
)
