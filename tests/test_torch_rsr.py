"""The port's LogitRSRGibbs against the JAX package's.

From one JAX state (loaded into the port through its carry format) and
the same noise (made with jax.random on the keys each JAX update would
use, then passed to the port), every RSR update agrees to 1e-4 of the
largest entry (float32 with sums in other orders). The Moran basis is
host numpy in both packages and must be bit-identical on the dense path;
the sparse Lanczos path starts ARPACK from a random vector, so there the
basis is compared as a subspace. Posterior means are held against the
JAX sampler's by the z-test of tests/test_torch_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from occuspytial_tpu.models.logit import LogitRSRGibbs as JaxRSR
from occuspytial_tpu.ops import icar as jicar
from occuspytial_tpu.ops import mvnorm as jmv
from occuspytial_tpu_torch import LogitRSRGibbs
from occuspytial_tpu_torch import diagnostics as dg
from occuspytial_tpu_torch.convert import carry_from_jax
from occuspytial_tpu_torch.ops import icar as ticar
from occuspytial_tpu_torch.ops import mvnorm as tmv
from occuspytial_tpu_torch.utils import make_data

# the tensors here are small: one intra-op thread is faster than many,
# and the suite already runs in parallel worker processes
torch.set_num_threads(1)

ARGS = dict(n=150, ns=100, p=3, q=2, random_state=10)
Q_DIM = 15


@pytest.fixture(scope='module')
def data():
    return make_data(**ARGS)


@pytest.fixture(scope='module')
def pair(data):
    Q, W, X, y = data[:4]
    return (
        JaxRSR(Q, W, X, y, random_state=3, q=Q_DIM),
        LogitRSRGibbs(Q, W, X, y, random_state=3, q=Q_DIM, device='cpu'),
    )


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _start(js):
    """A JAX carry's chain-0 state (jnp) and the same state in the port."""
    keys, states = js.init_carry(chains=1)
    jstate = {k: v[0] for k, v in states.items()}
    carry = carry_from_jax(
        np.asarray(jax.random.key_data(keys)),
        {k: np.asarray(v) for k, v in states.items()}, device='cpu',
    )
    return jstate, carry.states


def _omega(n, seed):
    return np.random.default_rng(seed).uniform(0.05, 0.3, n).astype(
        np.float32
    )


@pytest.mark.parametrize('kw', [dict(r=0.5), dict(r=0.2),
                                dict(num_eigs=15), dict(num_eigs=40)])
def test_moran_basis_is_bit_identical(data, kw):
    Q, X = data[0], data[2]
    for q in (Q, Q.toarray()):
        k_t, q_t = ticar.moran_basis(X, q, **kw)
        k_j, q_j = jicar.moran_basis(X, q, **kw)
        np.testing.assert_array_equal(k_t, k_j)
        np.testing.assert_array_equal(q_t, q_j)
    with pytest.raises(ValueError):
        ticar.moran_basis(X, Q, r=1.5)


@pytest.mark.parametrize('kw', [dict(num_eigs=12), dict(r=0.5)])
def test_moran_basis_lanczos_spans_the_jax_subspace(data, kw, monkeypatch):
    """A sparse Q from _MORAN_LANCZOS_THRESHOLD sites goes matrix-free
    (eigsh from a random start vector); the threshold is lowered to this
    150-site problem in both packages. Same basis size, same subspace,
    same spectrum as the JAX package's."""
    Q, X = data[0], data[2]
    monkeypatch.setattr(ticar, '_MORAN_LANCZOS_THRESHOLD', X.shape[0])
    monkeypatch.setattr(jicar, '_MORAN_LANCZOS_THRESHOLD', X.shape[0])
    assert sps.issparse(Q)
    k_t, q_t = ticar.moran_basis(X, Q, **kw)
    k_j, q_j = jicar.moran_basis(X, Q, **kw)
    assert k_t.shape == k_j.shape and k_t.shape[1] > 0
    np.testing.assert_allclose(k_t.T @ k_t, np.eye(k_t.shape[1]), atol=1e-8)
    # the projectors onto the two bases agree
    np.testing.assert_allclose(k_t @ (k_t.T @ k_j), k_j, atol=1e-6)
    np.testing.assert_allclose(np.linalg.eigvalsh(q_t),
                               np.linalg.eigvalsh(q_j), rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(q_t, q_t.T)
    # the dense path spans the same subspace
    k_d, _ = ticar.moran_basis(X, Q.toarray(), **kw)
    np.testing.assert_allclose(k_t @ (k_t.T @ k_d), k_d, atol=1e-6)


def test_rsr_mvnorm_matches_jax(pair):
    _, ps = pair
    f = {k: v.numpy() for k, v in ps.fixed.items()}
    n, q = f['K'].shape
    gen = np.random.default_rng(4)
    b = gen.normal(size=(3, q)).astype(np.float32)
    omega = gen.uniform(0.05, 0.3, (3, n)).astype(np.float32)
    tau = np.asarray([0.5, 3.0, 40.0], np.float32)
    keys = jax.random.split(jax.random.key(6), 3)
    want, e1, e2 = [], [], []
    for i, key in enumerate(keys):
        want.append(np.asarray(jmv.rsr_mvnorm(
            key, jnp.asarray(b[i]), jnp.asarray(omega[i]), tau[i],
            jnp.asarray(f['Q_rsr']), jnp.asarray(f['K']),
            jnp.asarray(f['sqrt_factor']),
        )))
        k1, k2 = jax.random.split(key)
        e1.append(np.asarray(jax.random.normal(k1, (n,), jnp.float32)))
        e2.append(np.asarray(jax.random.normal(k2, (q,), jnp.float32)))
    got = tmv.rsr_mvnorm(
        _t(b), _t(omega), _t(tau), ps.fixed['Q_rsr'], ps.fixed['K'],
        ps.fixed['sqrt_factor'], _t(np.stack(e1)), _t(np.stack(e2)),
    )
    _close(got, np.stack(want))
    # without given noise it draws its own, with the right shape
    gen_t = torch.Generator().manual_seed(0)
    own = tmv.rsr_mvnorm(_t(b), _t(omega), _t(tau), ps.fixed['Q_rsr'],
                         ps.fixed['K'], ps.fixed['sqrt_factor'],
                         generator=gen_t)
    assert own.shape == (3, q) and bool(torch.isfinite(own).all())


def test_fixed_arrays_equal_jax(pair):
    js, ps = pair
    assert ps.q_dim == js.q_dim == Q_DIM
    assert sorted(ps.fixed) == sorted(js.fixed)
    assert 'Q' not in ps.fixed
    for name, want in js.fixed.items():
        want = np.asarray(want)
        got = ps.fixed[name].numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_defaults_and_guards(pair, data):
    """The RSR eta draw overrides the ICAR one: no blocked solve, no
    cold-start solver check (there is no dense Q to check against), no
    warm-start state, even where the site count resolves solver='cg'."""
    js, ps = pair
    assert (ps.spatial_sweeps, ps.blocked, ps.pg_method) == (2, True,
                                                             'devroye')
    assert not ps._solves_lambda
    Q, W, X, y = data[:4]
    s = LogitRSRGibbs(Q, W, X, y, random_state=3, q=Q_DIM, solver='cg',
                      solver_check_tol=1e-12, device='cpu')
    carry = s.init_carry(2)
    assert not s._solver_checked
    assert sorted(carry.states) == sorted(js.init_carry(2)[1])
    assert carry.states['eta'].shape == (2, Q_DIM)
    post = s.sample(3, chains=2, progressbar=False)
    assert np.isfinite(post['beta']).all()
    # the unported full-rank solvers do not concern RSR
    assert LogitRSRGibbs(Q, W, X, y, q=Q_DIM, solver='graph',
                         device='cpu').solver == 'graph'
    assert LogitRSRGibbs(Q, W, X, y, q=Q_DIM, spatial_sweeps=3,
                         device='cpu').spatial_sweeps == 3


def test_update_tau_matches_jax(pair):
    js, ps = pair
    jstate, pstate = _start(js)
    key = jax.random.key(11)
    want = js._update_tau(key, jstate['eta'], js.fixed)
    g = jax.random.gamma(key, js.fixed['tau_shape'], dtype=jnp.float32)
    got = ps._update_tau(pstate['eta'], ps.fixed, _t(g)[None])
    _close(got, np.asarray(want)[None])


def test_update_eta_and_beta_match_jax(pair):
    js, ps = pair
    jstate, pstate = _start(js)
    omega = _omega(js.n, 1)
    tau = jstate['tau']
    key = jax.random.key(21)
    je, jsp = js._update_eta(key, jstate, jnp.asarray(omega), tau,
                             js.fixed)
    k1, k2 = jax.random.split(key)
    eps1 = jax.random.normal(k1, (js.n,), jnp.float32)
    eps2 = jax.random.normal(k2, (js.q_dim,), jnp.float32)
    pe, psp = ps._update_eta(pstate, _t(omega)[None], _t(tau)[None],
                             ps.fixed, _t(eps1)[None], _t(eps2)[None])
    _close(pe, np.asarray(je)[None])
    _close(psp, np.asarray(jsp)[None])
    key = jax.random.key(22)
    want = js._update_beta(key, jstate, jnp.asarray(omega), jsp, js.fixed)
    eps = jax.random.normal(key, (js.n_beta,), jnp.float32)
    got = ps._update_beta(pstate, _t(omega)[None], _t(np.asarray(jsp))[None],
                          ps.fixed, _t(eps)[None])
    _close(got, np.asarray(want)[None])


def test_asis_tau_matches_jax(pair):
    js, ps = pair
    jstate, pstate = _start(js)
    omega = _omega(js.n, 2)
    key = jax.random.key(31)
    want = js._asis_tau(key, dict(jstate), jnp.asarray(omega), js.fixed)
    k1, k2 = jax.random.split(key)
    noise = (_t(jax.random.normal(k1, (js.asis_steps,), jnp.float32))[None],
             _t(jax.random.uniform(k2, (js.asis_steps,), jnp.float32))[None])
    got = ps._asis_tau(dict(pstate), _t(omega)[None], ps.fixed, noise)
    for name in ('tau', 'eta', 'spatial'):
        _close(got[name], np.asarray(want[name])[None])


def test_jax_saved_carry_loads_and_runs(pair, tmp_path):
    js, ps = pair
    keys, states = js.init_carry(chains=2)
    path = tmp_path / 'carry.npz'
    js.save_carry(path, (keys, states))
    carry = ps.load_carry(path)
    assert carry.states['eta'].shape == (2, Q_DIM)
    for name, val in states.items():
        np.testing.assert_array_equal(carry.states[name].numpy(),
                                      np.asarray(val))
    post = ps.sample(3, chains=2, progressbar=False, resume_from=carry)
    assert np.isfinite(post['tau']).all()


def test_chain0_invariant_to_chain_count_and_resume_is_bitwise(data,
                                                                tmp_path):
    Q, W, X, y = data[:4]

    def make():
        return LogitRSRGibbs(Q, W, X, y, random_state=5, q=Q_DIM,
                             device='cpu')

    whole = make().sample(8, chains=2, progressbar=False)
    more = make().sample(8, chains=3, progressbar=False)
    s = make()
    first = s.sample(3, chains=2, progressbar=False)
    path = tmp_path / 'carry.npz'
    s.save_carry(path, s.final_carry)
    second = s.sample(5, chains=2, progressbar=False,
                      resume_from=s.load_carry(path))
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(more[name][:2], whole[name])
        np.testing.assert_array_equal(
            np.concatenate([first[name], second[name]], axis=1), whole[name]
        )


@pytest.mark.parametrize('kwargs', [
    dict(pg_method='gamma'), dict(asis_method='slice'), dict(asis=False),
    dict(dtype='float64'), dict(r=0.3),
])
def test_option_paths_run(data, kwargs):
    Q, W, X, y = data[:4]
    kwargs.setdefault('q', Q_DIM)
    s = LogitRSRGibbs(Q, W, X, y, random_state=2, device='cpu', **kwargs)
    post = s.sample(4, chains=2, progressbar=False)
    for name in ('alpha', 'beta', 'tau'):
        assert np.isfinite(post[name]).all()
    carry = s.init_carry(2, start={'eta': np.zeros(s.q_dim), 'tau': 2.0})
    assert float(carry.states['spatial'].abs().max()) == 0.0


def test_port_posterior_means_match_jax_sampler(data):
    """Unrelated random streams, one model: means of alpha and beta
    differ by Monte-Carlo error only (Z = 6, floor 0.05)."""
    Q, W, X, y = data[:4]
    size, burnin, chains = 600, 150, 4
    jax_post = JaxRSR(Q, W, X, y, random_state=4, q=Q_DIM).sample(
        size, burnin=burnin, chains=chains, progressbar=False
    )
    post = LogitRSRGibbs(Q, W, X, y, random_state=4, q=Q_DIM,
                         device='cpu').sample(
        size, burnin=burnin, chains=chains, progressbar=False
    )
    for name, dim in (('alpha', 2), ('beta', 3)):
        for j in range(dim):
            a = np.asarray(post[name])[:, :, j]
            b = np.asarray(jax_post[name])[:, :, j]
            ratio = dg.mean_z_ratio(a, b, 6.0, 0.05)
            assert ratio < 1.0, (
                f'{name}[{j}]: port {a.mean():.4f} vs jax {b.mean():.4f} '
                f'({ratio:.3f} of the tolerance)'
            )
