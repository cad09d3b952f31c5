"""Gibbs samplers of the port."""

from .logit import LogitICARGibbs

__all__ = ('LogitICARGibbs',)
