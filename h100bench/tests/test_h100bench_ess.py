"""The frozen ESS against series whose ESS is known."""

import numpy as np

from h100bench.ess import ess_bulk, min_ess


def _ar1(rho, chains, draws, seed):
    rng = np.random.default_rng(seed)
    x = np.empty((chains, draws))
    x[:, 0] = rng.standard_normal(chains) / np.sqrt(1 - rho ** 2)
    for t in range(1, draws):
        x[:, t] = rho * x[:, t - 1] + rng.standard_normal(chains)
    return x


def test_independent_draws_count_whole():
    x = np.random.default_rng(0).standard_normal((8, 4000))
    assert abs(ess_bulk(x) / x.size - 1.0) < 0.05


def test_ar1_ess_is_n_times_one_minus_rho_over_one_plus_rho():
    rho = 0.8
    x = _ar1(rho, 16, 4000, 1)
    want = x.size * (1 - rho) / (1 + rho)
    assert abs(ess_bulk(x) / want - 1.0) < 0.1


def test_min_ess_names_the_worst_component():
    rng = np.random.default_rng(2)
    draws = {'alpha': rng.standard_normal((4, 2000, 2)),
             'tau': _ar1(0.95, 4, 2000, 3)}
    worst, label = min_ess(draws)
    assert label == 'tau'
    assert worst == ess_bulk(draws['tau'])


def test_constant_series_counts_zero():
    worst, _ = min_ess({'tau': np.ones((2, 100))})
    assert worst == 0.0
