"""One-sided truncated-normal draws by the inverse-CDF method.

Port of the JAX package's ``ops/truncnorm.py`` (reference
gibbs/probit.py:11-24): N(loc, 1) truncated to (0, inf) or (-inf, 0),
elementwise and branch-free, computed through ``log_ndtr`` so that far
tails do not saturate the CDF in float32. The probit samplers' latent
utility updates use :func:`truncnorm_sign`.

Every function takes its uniforms ``u`` as an argument. ``jax.random.
uniform`` draws them from [0, 1), the port's :func:`..rng.uniform` from
(0, 1]; both ends give finite draws here (the clamp in
:func:`_safe_ndtri_exp` catches ``log1p(-1) = -inf`` and ``log(0)``).
"""

import torch
from torch.special import log_ndtr, ndtri


def _safe_ndtri_exp(log_q):
    """``ndtri(exp(log_q))`` clamped into the open unit interval: in
    float32 ``exp(log_q)`` reaches exactly 0 or 1 beyond ~5.3 sigma, where
    ndtri is infinite. The clamp truncates draws there (~8 sigma in
    float64)."""
    q = torch.exp(log_q)
    eps = torch.finfo(q.dtype).eps
    return ndtri(torch.clamp(q, eps, 1.0 - eps))


def truncnorm_positive(loc, u):
    """w ~ N(loc, 1) truncated to (0, inf): with the quantile function
    of the lower-truncated tail, ``loc - ndtri(ndtr(loc) (1 - u))``, in
    log space."""
    return loc - _safe_ndtri_exp(log_ndtr(loc) + torch.log1p(-u))


def truncnorm_negative(loc, u):
    """w ~ N(loc, 1) truncated to (-inf, 0): ``loc + ndtri(ndtr(-loc)
    u)``, in log space."""
    return loc + _safe_ndtri_exp(log_ndtr(-loc) + torch.log(u))


def truncnorm_sign(loc, positive, u):
    """N(loc, 1) truncated to (0, inf) where ``positive``, else to
    (-inf, 0), from one uniform per element."""
    tiny = torch.finfo(u.dtype).tiny
    log_pos = log_ndtr(loc) + torch.log1p(-u)
    log_neg = log_ndtr(-loc) + torch.log(torch.clamp(u, min=tiny))
    draw_pos = loc - _safe_ndtri_exp(log_pos)
    draw_neg = loc + _safe_ndtri_exp(log_neg)
    return torch.where(positive, draw_pos, draw_neg)
