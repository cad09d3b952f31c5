"""The port's host-side numpy/scipy modules against the JAX package's.

The port keeps its own copies of the data, ICAR setup, diagnostics,
posterior, chain and state modules (it imports nothing of the JAX
package); on the same inputs they must give identical results.
"""

import numpy as np
import pytest

from occuspytial_tpu import chain as jchain
from occuspytial_tpu import diagnostics as jdg
from occuspytial_tpu.models import state as jstate
from occuspytial_tpu.ops import icar as jicar
from occuspytial_tpu_torch import chain as tchain
from occuspytial_tpu_torch import diagnostics as tdg
from occuspytial_tpu_torch.data import Data
from occuspytial_tpu_torch.models import state as tstate
from occuspytial_tpu_torch.ops import icar as ticar
from occuspytial_tpu_torch.posterior import PosteriorParameter


def _ar1(seed, chains=4, draws=400, rho=0.7):
    gen = np.random.default_rng(seed)
    x = np.zeros((chains, draws))
    for t in range(1, draws):
        x[:, t] = rho * x[:, t - 1] + gen.normal(size=chains)
    return x


@pytest.mark.parametrize('fn', [
    'ess_bulk', 'ess_tail', 'ess_mean', 'rhat', 'mcse_mean', 'mcse_sd',
    'hdi',
])
def test_diagnostics_match_jax_package(fn):
    x = _ar1(3)
    np.testing.assert_array_equal(
        np.asarray(getattr(tdg, fn)(x)), np.asarray(getattr(jdg, fn)(x))
    )


@pytest.mark.parametrize('rows,cols,nb', [(10, 15, 8), (6, 7, 4)])
def test_icar_setup_matches_jax_package(rows, cols, nb):
    q_t = ticar.lattice_precision(rows, cols, nb)
    q_j = jicar.lattice_precision(rows, cols, nb)
    np.testing.assert_array_equal(q_t.toarray(), q_j.toarray())
    dense = ticar.to_dense(q_t)
    for a, b in zip(ticar.icar_spectral(dense), jicar.icar_spectral(dense)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        ticar.psd_sqrt_factor(dense + np.eye(dense.shape[0])),
        jicar.psd_sqrt_factor(dense + np.eye(dense.shape[0])),
    )
    ticar.verify_spatial_precision(q_t)
    with pytest.raises(ValueError):
        ticar.verify_spatial_precision(dense + np.eye(dense.shape[0]))
    with pytest.raises(ValueError):
        ticar.lattice_precision(3, 3, 6)


def test_chain_and_state_match_jax_package():
    params = {'alpha': 2, 'tau': 1}
    a, b = tchain.Chain(params, 5), jchain.Chain(params, 5)
    block = {'alpha': np.arange(6.0).reshape(3, 2), 'tau': [1.0, 2.0, 3.0]}
    a.extend(block)
    b.extend(block)
    a.append({'alpha': [9.0, 9.0], 'tau': 4.0})
    b.append({'alpha': [9.0, 9.0], 'tau': 4.0})
    np.testing.assert_array_equal(a.full, b.full)
    with pytest.raises(ValueError):
        a.extend({'alpha': np.zeros((2, 2)), 'tau': [0.0, 0.0]})
    a.expand(3)
    assert (a.size, len(a)) == (8, 4)
    s = tstate.FixedState(x=1)
    with pytest.raises(KeyError):
        s.x = 2
    assert repr(tstate.State(a=1)) == repr(jstate.State(a=1))


def test_posterior_summary_and_data_container():
    gen = np.random.default_rng(0)
    post = PosteriorParameter({
        'alpha': gen.normal(size=(2, 50, 2)),
        'tau': gen.gamma(2.0, size=(2, 50)),
    })
    table = post.summary
    assert list(table.index) == ['alpha[0]', 'alpha[1]', 'tau']
    assert np.isclose(table.loc['tau', 'mean'], post['tau'].mean())
    d = Data({0: np.ones((2, 3)), 4: np.zeros((1, 3))})
    assert d.visits([0, 4]) == (2, 1) and d[[0, 4]].shape == (3, 3)
    with pytest.raises(TypeError):
        Data([1, 2])
