"""Rank-normalised split-chain bulk ESS (Vehtari, Gelman, Simpson,
Carpenter & Buerkner 2021), frozen here so that the yardstick does not
move with the program: Geyer's initial positive sequence from the
(rho_0, rho_1) pair, one trailing positive even term, the initial
monotone sequence with both members of a capped pair set to the pair
mean, as Stan and arviz compute it."""

import numpy as np
from scipy.special import ndtri
from scipy.stats import rankdata


def _split(x):
    m, n = x.shape
    half = n // 2
    return np.vstack([x[:, :half], x[:, n - half:]])


def _z_scale(x):
    ranks = rankdata(x, method='average').reshape(x.shape)
    return ndtri((ranks - 3.0 / 8.0) / (x.size + 1.0 / 4.0))


def _autocov(x):
    m, n = x.shape
    x = x - x.mean(axis=1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, size, axis=1)
    return np.fft.irfft(f * np.conj(f), size, axis=1)[:, :n].real / n


def _ess(x):
    m, n = x.shape
    if n < 4 or np.allclose(x, x.ravel()[0]):
        return np.nan
    acov = _autocov(x)
    mean_var = acov[:, 0].mean() * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus == 0:
        return np.nan
    rho = np.zeros(n)
    rho[0] = 1.0
    even = 1.0
    odd = 1.0 - (mean_var - acov[:, 1].mean()) / var_plus
    rho[1] = odd
    t = 1
    while t < n - 3 and (even + odd) > 0.0:
        even = 1.0 - (mean_var - acov[:, t + 1].mean()) / var_plus
        odd = 1.0 - (mean_var - acov[:, t + 2].mean()) / var_plus
        if (even + odd) >= 0:
            rho[t + 1] = even
            rho[t + 2] = odd
        t += 2
    max_t = t - 2
    if even > 0:
        rho[max_t + 1] = even
    t = 1
    while t <= max_t - 2:
        if (rho[t + 1] + rho[t + 2]) > (rho[t - 1] + rho[t]):
            rho[t + 1] = (rho[t - 1] + rho[t]) / 2.0
            rho[t + 2] = rho[t + 1]
        t += 2
    total = m * n
    tau = -1.0 + 2.0 * rho[:max_t + 1].sum() + rho[max_t + 1]
    return total / max(tau, 1.0 / np.log10(total))


def ess_bulk(x):
    """Bulk ESS of (chains, draws) samples, pooled over the chains."""
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    return _ess(_z_scale(_split(x)))


def min_ess(draws):
    """(smallest bulk ESS, its component label) over every scalar
    component of ``draws``: name -> (chains, draws[, dim])."""
    worst = (np.inf, None)
    for name, arr in draws.items():
        arr = np.asarray(arr)
        cols = arr[..., None] if arr.ndim == 2 else arr
        for j in range(cols.shape[2]):
            e = ess_bulk(cols[:, :, j])
            label = name if arr.ndim == 2 else f'{name}[{j}]'
            if not np.isfinite(e):
                e = 0.0
            if e < worst[0]:
                worst = (float(e), label)
    return worst
