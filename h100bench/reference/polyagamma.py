"""PG(1, z) by Devroye's exact rejection method, in plain torch ops.

A frozen rewrite of the documented sampler (Polson, Scott & Windle 2013,
Algorithm 1, as the samplers run it): per lane at most 64 rounds of 9
uniforms; a truncated-exponential tail on (t, inf) or, on (0, t], the
squeeze sampler (c < 1/t) or the Michael-Schucany-Haas inverse-Gaussian
transform (c >= 1/t); the branch is drawn with the mixture weight until
a proposal of the body is refused, and then kept; the alternating series
decides over 4 terms; the draw is x / 4. A lane's value is its first
accepted proposal.
"""

import math

import torch

from .threefry import pg_uniforms

T = 0.64
_HALF_PI_SQ = math.pi * math.pi / 8.0
_ROUNDS = 64
_TERMS = 4


def _mass_texpon(c):
    """P(truncated-exponential branch) for c = |z| / 2."""
    k = _HALF_PI_SQ + 0.5 * c * c
    log_p = torch.log(math.pi / (2.0 * k)) - k * T
    rt = 1.0 / math.sqrt(T)
    a1 = rt * (T * c - 1.0)
    a2 = -rt * (T * c + 1.0)
    log_q = math.log(2.0) + torch.logaddexp(
        -c + torch.special.log_ndtr(a1), c + torch.special.log_ndtr(a2))
    return torch.exp(log_p - torch.logaddexp(log_p, log_q))


def _series_accept(x, v):
    small = x <= T
    a0 = (0.5 * math.pi) * torch.exp(torch.where(
        small,
        1.5 * torch.log(2.0 / (math.pi * x)) - 0.5 / x,
        -(math.pi * math.pi / 8.0) * x))
    q = torch.exp(torch.where(small, -4.0 / x, -(math.pi * math.pi) * x))
    s, y, term, qp = a0, v * a0, a0, torch.ones_like(x)
    acc = torch.zeros_like(x, dtype=torch.bool)
    rej = torch.zeros_like(acc)
    for n in range(1, _TERMS + 1):
        qp = qp * q
        term = term * ((2.0 * n + 1.0) / (2.0 * n - 1.0)) * qp
        if n % 2 == 1:
            s = s - term
            acc = acc | (~rej & (y <= s))
        else:
            s = s + term
            rej = rej | (~acc & (y > s))
    return acc | ~(acc | rej)


def pg_draw(subkeys, z):
    """PG(1, z) for ``z`` (chains, m) in z's dtype; chain b's uniforms
    from ``subkeys[b]``."""
    chains, m = z.shape
    c = 0.5 * torch.abs(z).reshape(-1)
    ratio = _mass_texpon(c)
    k_exp = _HALF_PI_SQ + 0.5 * c * c
    x = torch.full_like(c, T)
    done = torch.zeros_like(c, dtype=torch.bool)
    committed = torch.zeros_like(done)
    is_exp = torch.zeros_like(done)
    for k in range(_ROUNDS):
        idx = torch.nonzero(~done).reshape(-1)
        if idx.numel() == 0:
            break
        ca = c[idx]
        u = pg_uniforms(subkeys, k, idx, m, z.dtype)
        squeeze = ca < (1.0 / T)
        mu = 1.0 / torch.clamp(ca, min=1e-30)
        half_csq = 0.5 * ca * ca
        exp_a = torch.where(committed[idx], is_exp[idx], u[0] < ratio[idx])
        x_exp = T + (-torch.log(u[1])) / k_exp[idx]
        e1, e2 = -torch.log(u[2]), -torch.log(u[3])
        t1 = 1.0 + T * e1
        x_sq = T / (t1 * t1)
        ok_sq = (e1 * e1 <= 2.0 * e2 / T) & (
            u[4] < torch.exp(-x_sq * half_csq))
        nrm = torch.sqrt(-2.0 * torch.log(u[5])) * torch.cos(
            (2.0 * math.pi) * u[6])
        mu_y = mu * nrm * nrm
        x_ig = mu + 0.5 * mu * (mu_y - torch.sqrt(4.0 * mu_y + mu_y * mu_y))
        x_ig = torch.where(u[7] > mu / (mu + x_ig), mu * mu / x_ig, x_ig)
        x_body = torch.where(squeeze, x_sq, x_ig)
        ok_body = torch.where(squeeze, ok_sq, x_ig <= T)
        x_new = torch.where(exp_a, x_exp, x_body)
        valid = exp_a | ok_body
        accepted = valid & _series_accept(x_new, u[8])
        x[idx] = torch.where(accepted, x_new, x[idx])
        done[idx] = accepted
        committed[idx] = ~valid
        is_exp[idx] = exp_a
    return (0.25 * x).reshape(chains, m)
