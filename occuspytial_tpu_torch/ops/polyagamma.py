"""Pólya-Gamma PG(1, z) sampling in plain torch ops.

Port of the JAX package's ``ops/polyagamma.py``: the mixture weights
(``_mass_texpon``), the alternating-series test (``_series_accept``),
``pg_mean``/``pg_var`` and the truncated sum-of-gammas sampler
``pg_gamma``. The exact sampler :func:`pg_devroye` is Devroye's
rejection method as the TPU kernel runs it (``ops/pallas_pg.py:
_run_rejection``): at most 64 rounds of 9 uniforms each, an exponential
tail or a squeeze/inverse-Gaussian body chosen by c < 1/t, a sticky branch
choice, a 4-term ratio-recurrence series test and output ``x / 4``. A
lane's value freezes at its first acceptance, so rounds over the lanes
not yet accepted give what one thread per lane looping on its own gives:
this is
the plain version of the CUDA kernel in :mod:`.cuda_pg`, which draws the
same uniforms (:func:`occuspytial_tpu_torch.rng.pg_uniforms`).

All samplers take per-chain ``subkeys`` (chains, 2) and ``z`` (chains,
m); every draw of chain b depends on ``subkeys[b]`` alone.
"""

import math

import torch

from .. import rng

# Devroye's threshold separating the two proposal branches
_T = 0.64
_HALF_PI_SQ = math.pi * math.pi / 8.0
# each round accepts with probability > 0.5 per lane; 64 rounds bound the
# per-lane failure probability below 1e-19
_MAX_ROUNDS = 64
# series terms: the bracket width after 4 terms is ~3e-27 of the bound
# at the worst point x = t, far below float32 resolution
_N_SERIES = 4


def _rdiv(num, den):
    """``num / den`` for a Python number ``num`` as a true division
    (``float / tensor`` in torch multiplies by a reciprocal, which rounds
    differently from the JAX reference and the kernel). The numerator is
    filled on ``den``'s device: a host scalar copied to the card would
    synchronise the stream."""
    return torch.div(torch.full_like(den, num), den)


def _mass_texpon(c):
    """P(choose the truncated-exponential branch) for |z|/2 = c
    (Polson, Scott & Windle 2013, Algorithm 1)."""
    k = _HALF_PI_SQ + 0.5 * c * c
    log_p = torch.log(_rdiv(math.pi, 2.0 * k)) - k * _T
    rt = 1.0 / math.sqrt(_T)
    a1 = rt * (_T * c - 1.0)
    a2 = -rt * (_T * c + 1.0)
    log_q = math.log(2.0) + torch.logaddexp(
        -c + torch.special.log_ndtr(a1), c + torch.special.log_ndtr(a2)
    )
    return torch.exp(log_p - torch.logaddexp(log_p, log_q))


def _log_ndtr_erfcx(x):
    """log Phi(x): for x < 0 as log(erfcx(-x / sqrt 2) / 2) - x^2 / 2,
    which keeps its digits where Phi(x) underflows."""
    neg = x < 0
    xn = torch.where(neg, x, torch.zeros_like(x))
    xp = torch.where(neg, torch.zeros_like(x), x)
    lo = torch.log(0.5 * torch.special.erfcx(-xn * math.sqrt(0.5))) \
        - 0.5 * xn * xn
    hi = torch.log1p(-0.5 * torch.erfc(xp * math.sqrt(0.5)))
    return torch.where(neg, lo, hi)


def _logaddexp_log1p(a, b):
    return torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))


def mass_texpon_erfcx(c):
    """:func:`_mass_texpon` as the CUDA kernel computes it
    (``csrc/pg_devroye.cu:mass_texpon``): the same formula with
    ``log_ndtr`` and ``logaddexp`` written out in ``erfcx``, ``erfc``,
    ``log1p`` and ``exp``, the functions CUDA's math library has. Kept in
    torch ops so that the CPU tests hold the kernel's arithmetic."""
    k = _HALF_PI_SQ + 0.5 * c * c
    log_p = torch.log(_rdiv(math.pi, 2.0 * k)) - k * _T
    rt = 1.0 / math.sqrt(_T)
    a1 = rt * (_T * c - 1.0)
    a2 = -rt * (_T * c + 1.0)
    log_q = math.log(2.0) + _logaddexp_log1p(
        -c + _log_ndtr_erfcx(a1), c + _log_ndtr_erfcx(a2)
    )
    return torch.exp(log_p - _logaddexp_log1p(log_p, log_q))


def pg_inputs(z):
    """The z-dependent mixture quantities ``(c, ratio, k_exp)``."""
    c = 0.5 * torch.abs(z)
    ratio = _mass_texpon(c)
    k_exp = _HALF_PI_SQ + 0.5 * c * c
    return c, ratio, k_exp


def _series_accept(x, v):
    """Devroye's alternating-series accept/reject decision.

    Terms by the exact ratio recurrence a_{n+1}/a_n = ((2n+3)/(2n+1))
    q^{n+1}, q = exp(-4/x) (x <= t) or exp(-pi^2 x) (x > t); a lane still
    undecided after the last term is accepted (the bracket is below
    float resolution there).
    """
    small = x <= _T
    log_small_base = 1.5 * torch.log(_rdiv(2.0, math.pi * x))
    a0 = (0.5 * math.pi) * torch.exp(
        torch.where(
            small,
            log_small_base - _rdiv(0.5, x),
            -(math.pi * math.pi / 8.0) * x,
        )
    )
    q = torch.exp(torch.where(small, _rdiv(-4.0, x), -(math.pi * math.pi) * x))
    s = a0
    y = v * a0
    term = a0
    qp = torch.ones_like(x)
    accepted = torch.zeros_like(x, dtype=torch.bool)
    rejected = torch.zeros_like(x, dtype=torch.bool)
    for n in range(1, _N_SERIES + 1):
        qp = qp * q
        term = term * ((2.0 * n + 1.0) / (2.0 * n - 1.0)) * qp
        if n % 2 == 1:
            s = s - term
            accepted = accepted | (~rejected & (y <= s))
        else:
            s = s + term
            rejected = rejected | (~accepted & (y > s))
    return accepted | ~(accepted | rejected)


def _rejection(c, ratio, k_exp, planes):
    """Masked Devroye rejection rounds over the lanes of ``c``.

    ``planes(k, idx)`` gives round k's (9, len(idx)) uniforms for the
    flat lane indices ``idx``. Each round proposes only for the lanes not
    yet accepted (at most 64 rounds); a lane's value is its first
    accepted proposal, so this equals running every lane every round.
    Returns the PG(1, z) draws ``x / 4`` in the shape of ``c``. The
    active set is read back once per round: this plain version is the
    kernel's reference, not the card's path.
    """
    shape = c.shape
    c, ratio, k_exp = c.reshape(-1), ratio.reshape(-1), k_exp.reshape(-1)
    x = torch.full_like(c, _T)
    done = torch.zeros_like(c, dtype=torch.bool)
    committed = torch.zeros_like(done)
    is_exp = torch.zeros_like(done)
    for k in range(_MAX_ROUNDS):
        idx = torch.nonzero(~done).reshape(-1)
        if idx.numel() == 0:
            break
        ca = c[idx]
        uni = planes(k, idx)
        use_squeeze = ca < (1.0 / _T)
        mu = _rdiv(1.0, torch.clamp(ca, min=1e-30))
        half_csq = 0.5 * ca * ca
        exp_a = torch.where(committed[idx], is_exp[idx], uni[0] < ratio[idx])

        # branch A: exponential tail on (t, inf)
        x_exp = _T + (-torch.log(uni[1])) / k_exp[idx]

        # branch B1: squeeze sampler for the truncated IG body (c < 1/t)
        e1 = -torch.log(uni[2])
        e2 = -torch.log(uni[3])
        ok_sq = e1 * e1 <= 2.0 * e2 / _T
        t1 = 1.0 + _T * e1
        x_sq = _rdiv(_T, t1 * t1)
        ok_sq = ok_sq & (uni[4] < torch.exp(-x_sq * half_csq))

        # branch B2: Michael-Schucany-Haas IG transform (c >= 1/t)
        nrm = torch.sqrt(-2.0 * torch.log(uni[5])) * torch.cos(
            (2.0 * math.pi) * uni[6]
        )
        y0 = nrm * nrm
        mu_y = mu * y0
        x_ig = mu + 0.5 * mu * (mu_y - torch.sqrt(4.0 * mu_y + mu_y * mu_y))
        flip = uni[7] > mu / (mu + x_ig)
        x_ig = torch.where(flip, mu * mu / x_ig, x_ig)
        ok_ig = x_ig <= _T

        x_body = torch.where(use_squeeze, x_sq, x_ig)
        ok_body = torch.where(use_squeeze, ok_sq, ok_ig)
        x_new = torch.where(exp_a, x_exp, x_body)
        valid = exp_a | ok_body
        accepted = valid & _series_accept(x_new, uni[8])

        x[idx] = torch.where(accepted, x_new, x[idx])
        done[idx] = accepted
        committed[idx] = ~valid
        is_exp[idx] = exp_a
    return (0.25 * x).reshape(shape)


def pg_devroye(subkeys, z, lanes=None):
    """Exact PG(1, z) draws for ``z`` (chains, m), chain b's uniforms
    from ``subkeys[b]`` (see :func:`occuspytial_tpu_torch.rng.pg_uniforms`).
    ``lanes`` (m,) int64, optional: column j draws as global lane
    ``lanes[j]`` (the lane table of the CUDA kernel)."""
    c, ratio, k_exp = pg_inputs(z)
    return _rejection(
        c, ratio, k_exp,
        lambda k, idx: rng.pg_uniforms(subkeys, k, z.shape[-1], z.dtype,
                                       lanes=idx, table=lanes),
    )


def pg_gamma(subkeys, z, trunc=64, lanes=None):
    """PG(1, z) via the truncated sum-of-gammas series plus the exact
    tail mean (fixed work, no rejection). Column j draws words ``j * trunc
    + t``; with ``lanes`` (m,) int64, words ``lanes[j] * trunc + t`` (a
    band of a 2-D run draws its global lanes, as :func:`pg_devroye`)."""
    chains, m = z.shape
    a = torch.abs(z) / (2.0 * math.pi)
    k_idx = torch.arange(1, trunc + 1, dtype=z.dtype, device=z.device)
    denom = (k_idx - 0.5) ** 2 + a[..., None] ** 2
    if lanes is None:
        w = rng.words(subkeys, 0, 0, m * trunc)
    else:
        w = rng.lane_words(subkeys, 0, 0, lanes, trunc)
    w = w.reshape(chains, m, trunc)
    g = -torch.log(rng.uniform(w, z.dtype))
    series = torch.sum(g / denom, dim=-1)
    a_safe = torch.clamp(a, min=1e-12)
    full = torch.where(
        a < 1e-6,
        math.pi * math.pi / 2.0 * (1.0 - (math.pi * a) ** 2 / 3.0),
        math.pi * torch.tanh(math.pi * a_safe) / (2.0 * a_safe),
    )
    tail_mean = full - torch.sum(1.0 / denom, dim=-1)
    return (series + tail_mean) / (2.0 * math.pi * math.pi)


def random_polyagamma(keys, z, method='devroye', trunc=64):
    """The method dispatcher of the JAX ``random_polyagamma`` (the
    reference's entry point): ``'devroye'`` (exact) or ``'gamma'`` (the
    truncated series, ``trunc`` terms), per-chain ``keys`` (chains, 2)."""
    if method == 'devroye':
        return pg_devroye(keys, z)
    if method == 'gamma':
        return pg_gamma(keys, z, trunc=trunc)
    raise ValueError(f'unknown PG sampling method: {method!r}')


def pg_mean(z):
    """E[PG(1, z)] = tanh(z/2) / (2 z), with the z->0 limit 1/4."""
    z = torch.as_tensor(z)
    zs = torch.where(torch.abs(z) < 1e-6, torch.ones_like(z), z)
    return torch.where(
        torch.abs(z) < 1e-6,
        0.25 - z * z / 48.0,
        torch.tanh(zs / 2.0) / (2.0 * zs),
    )


def pg_var(z):
    """Var[PG(1, z)]; the z->0 limit is 1/24."""
    z = torch.as_tensor(z)
    zs = torch.where(torch.abs(z) < 1e-3, torch.ones_like(z), z)
    sech2 = 1.0 / torch.cosh(zs / 2.0) ** 2
    v = (torch.sinh(zs) - zs) * sech2 / (4.0 * zs ** 3)
    return torch.where(
        torch.abs(z) < 1e-3, torch.full_like(z, 1.0 / 24.0), v
    )
