"""Synthetic-data simulation and RNG helpers.

API-parity with reference utils.py (``get_generator``,
``rand_precision_mat``, ``make_data``) with the libpysal lattice-weights
dependency replaced by the direct stencil assembly in
:mod:`occuspytial_tpu_torch.ops.icar`. Simulation is host-side numpy (it runs
once, outside the hot loop); the samplers themselves consume the output
via :func:`occuspytial_tpu_torch.data.pack_detection_data`.

``make_data``'s *random draw sequence* is pinned to the reference's
(same generator calls in the same order), so a given ``random_state``
gives the same arrays as the JAX package's ``make_data``.
"""

import numpy as np
from scipy.linalg import pinvh

from .ops.icar import lattice_precision


def get_generator(random_state=None):
    """numpy Generator over SFC64 (reference utils.py:7-35)."""
    return np.random.default_rng(np.random.SFC64(random_state))


def rand_precision_mat(lat_row, lat_col, max_neighbors=8, rho=1):
    """Random spatial precision matrix from a rectangular lattice.

    Same contract as reference utils.py:38-103: Q = diag(rowsums) - rho*A
    over a rook (4) or queen (8) adjacency; returns scipy COO.
    """
    return lattice_precision(lat_row, lat_col, max_neighbors, rho)


def _sigmoid(x):
    """Logistic CDF via the stable log-sum-exp route."""
    return np.exp(-np.logaddexp(0.0, -x))


def _resolve_survey_design(n, min_v, max_v, ns):
    """Default and validate the survey-design knobs of ``make_data``."""
    if n < 150:
        raise ValueError(f'need n >= 150 sites, got n={n}')
    min_v = 2 if min_v is None else min_v
    if min_v < 1:
        raise ValueError(f'need min_v >= 1 visit, got {min_v}')
    max_v = n // 10 if max_v is None else max_v
    if max_v < 2:
        raise ValueError(f'need max_v >= 2 visits, got {max_v}')
    if max_v > n:
        raise ValueError(f'need max_v <= n, got {max_v} > {n}')
    ns = n // 2 if ns is None else ns
    if ns == 0:
        raise ValueError('need a positive number of surveyed sites ns')
    if ns > n:
        raise ValueError(f'need ns <= n, got {ns} > {n}')
    return min_v, max_v, ns


def make_data(
    n=150,
    min_v=None,
    max_v=None,
    ns=None,
    p=3,
    q=3,
    tau_range=(0.25, 1.5),
    max_neighbors=8,
    random_state=None,
):
    """Generate a random single-season occupancy dataset.

    Contract of reference utils.py:106-294 (same defaults, same
    validation branches, same returned tuple
    ``(Q, W, X, y, alpha, beta, tau, z)`` with W/y dicts keyed by
    surveyed-site index, and the same pinned draw order — see module
    docstring).
    """
    min_v, max_v, ns = _resolve_survey_design(n, min_v, max_v, ns)
    rng = get_generator(random_state)

    surveyed_sites = rng.choice(range(n), size=ns, replace=False)
    visits_per_site = rng.integers(min_v, max_v, size=ns, endpoint=True)

    alpha = rng.standard_normal(q)
    beta = rng.standard_normal(p)
    tau = rng.uniform(*tau_range)

    # lattice shape: a random factorization n = row * col with row >= 3
    row = rng.choice([f for f in range(3, n) if n % f == 0])
    col = n // row

    Q = rand_precision_mat(
        row, col, max_neighbors=max_neighbors
    ).astype(float)
    # spatial field from the ICAR pseudo-covariance (the reference's
    # cond=1e-5 cutoff under old-scipy semantics is rtol in new scipy)
    q_pinv = pinvh(Q.toarray(), rtol=1e-5)
    eta = rng.multivariate_normal(np.zeros(n), q_pinv / tau, method='eigh')

    X = rng.uniform(-2, 2, n * p).reshape(n, -1)
    X[:, 0] = 1

    # NOTE the sign: the reference simulates psi = sigmoid(X beta - eta)
    # (its expression is `-logaddexp(0, -X @ beta + eta)`); pinned.
    psi = _sigmoid(X @ beta - eta)
    z = rng.binomial(1, p=psi, size=n)

    W, y = {}, {}
    for site, visits in zip(surveyed_sites, visits_per_site):
        w_site = rng.uniform(-2, 2, size=visits * q).reshape(visits, -1)
        w_site[:, 0] = 1
        detect = _sigmoid(w_site @ alpha)
        W[int(site)] = w_site
        y[int(site)] = rng.binomial(1, z[site] * detect)

    return Q, W, X, y, alpha, beta, tau, z
