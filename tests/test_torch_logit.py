"""The port's LogitICARGibbs against the JAX package's, update by update.

From one JAX state (loaded into the port through its carry format) and
the same noise (made with jax.random on the keys each JAX update would
use, then passed to the port), every update of one Gibbs step must agree
to 1e-4 of the largest entry: the two compute in float32 with sums in
different orders. The z draw compares uniforms with probabilities, so a
site may flip only where its uniform lies within 1e-5 of its threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuspytial_tpu.data import pack_detection_data as jpack
from occuspytial_tpu.models.logit import LogitICARGibbs as JaxLogit
from occuspytial_tpu.utils import make_data as jmake_data
from occuspytial_tpu_torch import LogitICARGibbs
from occuspytial_tpu_torch.convert import carry_from_jax
from occuspytial_tpu_torch.data import pack_detection_data
from occuspytial_tpu_torch.utils import make_data

# the tensors here are small: one intra-op thread is faster than many,
# and the suite already runs in parallel worker processes
torch.set_num_threads(1)

ARGS = dict(n=150, ns=100, p=3, q=2, random_state=10)


@pytest.fixture(scope='module')
def data():
    return make_data(**ARGS)


@pytest.fixture(scope='module')
def pair(data):
    """(JAX sampler, port sampler) per solver."""
    Q, W, X, y = data[:4]
    out = {}
    for solver in ('cg', 'chol'):
        out[solver] = (
            JaxLogit(Q, W, X, y, random_state=3, solver=solver),
            LogitICARGibbs(Q, W, X, y, random_state=3, solver=solver,
                           device='cpu'),
        )
    return out


def _close(got, want, tol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def test_make_data_is_the_jax_package_data():
    a, b = make_data(**ARGS), jmake_data(**ARGS)
    np.testing.assert_array_equal(a[0].toarray(), b[0].toarray())
    for i in (2, 4, 5, 6, 7):
        np.testing.assert_array_equal(a[i], b[i])
    for i in (1, 3):
        assert sorted(a[i]) == sorted(b[i])
        for site in a[i]:
            np.testing.assert_array_equal(a[i][site], b[i][site])


def test_packed_data_is_the_jax_package_data(data):
    _, W, X, y = data[:4]
    a = pack_detection_data(W, y, X.shape[0])
    b = jpack(W, y, X.shape[0])
    for field in ('W', 'y', 'visit_mask', 'site_idx', 'surveyed', 'obs',
                  'W_flat', 'y_flat', 'visit_site'):
        np.testing.assert_array_equal(
            getattr(a, field), np.asarray(getattr(b, field))
        )
    flat = a.flat_index()
    np.testing.assert_array_equal(
        a.W_flat[flat[a.visit_mask]], a.W[a.visit_mask]
    )


@pytest.mark.parametrize('solver', ['cg', 'chol'])
def test_fixed_arrays_equal_jax(pair, solver):
    js, ps = pair[solver]
    assert sorted(ps.fixed) == sorted(js.fixed)
    for name, want in js.fixed.items():
        want = np.asarray(want)
        got = ps.fixed[name].numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_jax_saved_carry_loads(pair, tmp_path):
    js, ps = pair['cg']
    keys, states = js.init_carry(chains=2)
    path = tmp_path / 'carry.npz'
    js.save_carry(path, (keys, states))
    carry = ps.load_carry(path)
    np.testing.assert_array_equal(
        carry.keys.numpy(), np.asarray(jax.random.key_data(keys))
    )
    assert carry.step == 0
    assert sorted(carry.states) == sorted(states)
    for name, val in states.items():
        np.testing.assert_array_equal(carry.states[name].numpy(),
                                      np.asarray(val))
    # the loaded state runs on in the port
    post = ps.sample(3, chains=2, progressbar=False, resume_from=carry)
    assert np.isfinite(post['beta']).all()


def _start(js, chains=1):
    """A JAX carry's chain-0 state (jnp) and the same state in the port."""
    keys, states = js.init_carry(chains=chains)
    jstate = {k: v[0] for k, v in states.items()}
    carry = carry_from_jax(
        np.asarray(jax.random.key_data(keys))[:1],
        {k: np.asarray(v)[:1] for k, v in states.items()}, device='cpu',
    )
    return jstate, carry.states


def _omega(n, seed):
    gen = np.random.default_rng(seed)
    return gen.uniform(0.05, 0.3, n).astype(np.float32)


def test_update_tau_matches_jax(pair):
    js, ps = pair['cg']
    jstate, pstate = _start(js)
    key = jax.random.key(11)
    want = js._update_tau(key, jstate['eta'], js.fixed)
    g = jax.random.gamma(key, js.fixed['tau_shape'], dtype=jnp.float32)
    got = ps._update_tau(pstate['eta'], ps.fixed,
                         torch.tensor(np.asarray(g))[None])
    _close(got, np.asarray(want)[None])


def _blocked_noise(key, n, p):
    k_beta, k_eps1, k_noise = jax.random.split(key, 3)
    return (
        jax.random.normal(k_beta, (p,), jnp.float32),
        jax.random.normal(k_eps1, (n,), jnp.float32),
        jax.random.normal(k_noise, (n - 1,), jnp.float32),
    )


@pytest.mark.parametrize('solver', ['cg', 'chol'])
def test_blocked_beta_eta_matches_jax(pair, solver):
    js, ps = pair[solver]
    jstate, pstate = _start(js)
    jstate, pstate = dict(jstate), dict(pstate)
    omega = _omega(js.n, 1)
    tau = jstate['tau']
    # two successive solves: the second starts warm from the first
    for step in range(2):
        key = jax.random.key(20 + step)
        jb, je = js._update_beta_eta_blocked(
            key, jstate, jnp.asarray(omega), tau, js.fixed
        )
        noise = [torch.tensor(np.asarray(a))[None]
                 for a in _blocked_noise(key, js.n, js.n_beta)]
        pb, pe = ps._update_beta_eta_blocked(
            pstate, torch.as_tensor(omega)[None],
            torch.tensor(np.asarray(tau))[None], ps.fixed, *noise,
        )
        _close(pb, np.asarray(jb)[None])
        _close(pe, np.asarray(je)[None])
        if solver == 'cg':
            _close(pstate['eta_warm'], np.asarray(jstate['eta_warm'])[None])
            _close(pstate['solver_resid'],
                   np.asarray(jstate['solver_resid'])[None])


def test_asis_tau_matches_jax(pair):
    js, ps = pair['cg']
    jstate, pstate = _start(js)
    omega = _omega(js.n, 2)
    key = jax.random.key(31)
    want = js._asis_tau(key, dict(jstate), jnp.asarray(omega), js.fixed)
    k1, k2 = jax.random.split(key)
    normals = jax.random.normal(k1, (js.asis_steps,), jnp.float32)
    uniforms = jax.random.uniform(k2, (js.asis_steps,), jnp.float32)
    got = ps._asis_tau(
        dict(pstate), torch.as_tensor(omega)[None], ps.fixed,
        (torch.tensor(np.asarray(normals))[None],
         torch.tensor(np.asarray(uniforms))[None]),
    )
    for name in ('tau', 'eta', 'spatial'):
        _close(got[name], np.asarray(want[name])[None])
    assert float(got['tau'][0]) != float(pstate['tau'][0])


def test_update_alpha_matches_jax(pair):
    js, ps = pair['cg']
    jstate, pstate = _start(js)
    omega_a = _omega(js.total_visits, 3)
    key = jax.random.key(41)
    want = js._update_alpha(key, jstate, jnp.asarray(omega_a), js.fixed)
    eps = jax.random.normal(key, (js.n_alpha,), jnp.float32)
    got = ps._update_alpha(pstate, torch.as_tensor(omega_a)[None], ps.fixed,
                           torch.tensor(np.asarray(eps))[None])
    _close(got, np.asarray(want)[None])


def test_update_z_matches_jax(pair, data):
    js, ps = pair['cg']
    jstate, pstate = _start(js)
    key = jax.random.key(51)
    zj, kj = js._update_z(key, jstate, jstate['alpha'], jstate['beta'],
                          jstate['spatial'], js.fixed)
    u = np.asarray(jax.random.uniform(key, (js.n,), jnp.float32))
    zp, kp = ps._update_z(pstate, pstate['alpha'], pstate['beta'],
                          pstate['spatial'], ps.fixed,
                          torch.tensor(u)[None])
    zp, zj = zp[0].numpy(), np.asarray(zj)
    np.testing.assert_array_equal(kp[0].numpy(), zp - 0.5)
    bad = zp != zj
    if bad.any():
        # float64 occupancy probability of the flipped sites
        x = np.asarray(js.fixed['X'], np.float64)
        lin = x @ np.asarray(jstate['beta'], np.float64) + np.asarray(
            jstate['spatial'], np.float64)
        w = np.asarray(js.fixed['W_flat'], np.float64)
        log_prod = np.zeros(js.n)
        np.add.at(log_prod, np.asarray(js.fixed['visit_site']),
                  -np.logaddexp(0.0, w @ np.asarray(jstate['alpha'],
                                                    np.float64)))
        p = 1.0 / (1.0 + np.exp(-(lin + log_prod)))
        assert (np.abs(u[bad] - p[bad]) < 1e-5).all()


def test_chain0_invariant_to_chain_count(data):
    """Chain c's draws depend on its own key alone (CPU matrix products
    here give each row the same sums whatever the batch size)."""
    Q, W, X, y = data[:4]
    a = LogitICARGibbs(Q, W, X, y, random_state=11, solver='cg',
                       device='cpu').sample(6, chains=2, progressbar=False)
    b = LogitICARGibbs(Q, W, X, y, random_state=11, solver='cg',
                       device='cpu').sample(6, chains=3, progressbar=False)
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(a[name], b[name][:2])


def test_resume_is_bitwise_one_run(data, tmp_path):
    Q, W, X, y = data[:4]

    def make():
        return LogitICARGibbs(Q, W, X, y, random_state=5, solver='cg',
                              device='cpu')

    whole = make().sample(10, chains=2, progressbar=False)
    s = make()
    first = s.sample(4, chains=2, progressbar=False)
    path = tmp_path / 'carry.npz'
    s.save_carry(path, s.final_carry)
    second = s.sample(6, chains=2, progressbar=False,
                      resume_from=s.load_carry(path))
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(
            np.concatenate([first[name], second[name]], axis=1), whole[name]
        )
    assert s.final_carry.step == 10


def test_default_device_without_cuda_raises(data, monkeypatch):
    Q, W, X, y = data[:4]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        LogitICARGibbs(Q, W, X, y)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        carry_from_jax(np.zeros((1, 2), np.uint32), {})


@pytest.mark.parametrize('kwargs', [
    dict(solver='stencil'), dict(solver='graph'), dict(lattice=(10, 15)),
])
def test_unported_solvers_raise(data, kwargs):
    """The matrix-free regimes, once unported, now resolve as the JAX
    sampler's do: the same solver, or the same ValueError (a stencil
    without a lattice; a lattice that is not this Q's)."""
    Q, W, X, y = data[:4]
    try:
        want = JaxLogit(Q, W, X, y, **kwargs).solver
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            LogitICARGibbs(Q, W, X, y, device='cpu', **kwargs)
        assert str(got.value) == str(exc)
        return
    assert LogitICARGibbs(Q, W, X, y, device='cpu', **kwargs).solver == want


def test_options_and_defaults(data):
    Q, W, X, y = data[:4]
    s = LogitICARGibbs(Q, W, X, y, device='cpu')
    assert (s.solver, s.pg_method, s.cg_impl, s.spatial_sweeps) == (
        'chol', 'devroye', 'xla', 2)
    for bad in (dict(pg_method='x'), dict(cg_impl='x'),
                dict(asis_method='x'), dict(solver='x'),
                dict(spatial_sweeps=0)):
        with pytest.raises(ValueError):
            LogitICARGibbs(Q, W, X, y, device='cpu', **bad)
    with pytest.raises(ValueError):
        s.sample(5, burnin=5)


@pytest.mark.parametrize('kwargs', [
    dict(pg_method='gamma'), dict(pg_method='pallas'),
    dict(asis_method='slice'), dict(blocked=False),
    dict(blocked=False, solver='chol'), dict(dtype='float64'),
])
def test_option_paths_run(data, kwargs):
    Q, W, X, y = data[:4]
    kwargs.setdefault('solver', 'cg')
    s = LogitICARGibbs(Q, W, X, y, random_state=2, device='cpu', **kwargs)
    s.track = ('z',)
    post = s.sample(4, chains=2, progressbar=False)
    for name in ('alpha', 'beta', 'tau', 'z'):
        assert np.isfinite(post[name]).all()
    assert post['z'].shape == (2, 4, s.n)


def test_copy_and_start(data):
    Q, W, X, y = data[:4]
    s = LogitICARGibbs(Q, W, X, y, random_state=4, device='cpu')
    c1, c2 = s.copy(), s.copy()
    assert len({s._seed, c1._seed, c2._seed}) == 3
    carry = s.init_carry(2, start={'beta': [0.1, 0.2, 0.3], 'tau': 2.0})
    np.testing.assert_allclose(carry.states['beta'].numpy(),
                               [[0.1, 0.2, 0.3]] * 2, rtol=1e-6)
    assert torch.equal(carry.states['spatial'], carry.states['eta'])


def test_solver_residual_guardrail(data):
    Q, W, X, y = data[:4]
    s = LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                       device='cpu')
    assert s.solver_residual() < 1e-3
    starved = LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                             cg_iters=1, solver_check_tol=1e-6,
                             device='cpu')
    with pytest.raises(RuntimeError, match='did not converge'):
        starved.init_carry(2)



def test_sample_until(data):
    Q, W, X, y = data[:4]
    s = LogitICARGibbs(Q, W, X, y, random_state=6, device='cpu')
    post = s.sample_until(rhat_tol=None, min_ess=None, chains=2,
                          check_every=8)
    assert post['beta'].shape == (2, 4, 3)
    with pytest.raises(RuntimeError, match='no convergence after 16'):
        s.sample_until(min_ess=1e9, chains=2, check_every=8, max_size=16)
    with pytest.raises(ValueError):
        s.sample_until(check_every=4)
