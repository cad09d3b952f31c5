"""The large-n eta regimes of both ICAR samplers against the JAX package.

``solver='stencil'`` (``lattice=``) and ``solver='graph'`` of
``LogitICARGibbs`` and ``ProbitICARGibbs``: the same defaults as the JAX
samplers, the same fixed arrays, and from one JAX state (loaded into the
port through its carry format) and the same noise (made with jax.random
on the keys each JAX update would use), every eta update within 1e-4 of
the largest entry (the warm carry's h = Lambda^{-1} 1 row within 1e-3,
see the blocked test). The dataset is a 10 x 15 queen lattice from
chip_smoke.py's copy of the bench's generator (n = 150).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from chip_smoke import make_lattice_dataset
from occuspytial_tpu.models.logit import LogitICARGibbs as JaxLogit
from occuspytial_tpu.models.probit import ProbitICARGibbs as JaxProbit
from occuspytial_tpu.ops.icar import lattice_precision as jlattice
from occuspytial_tpu.ops.polyagamma import pg_devroye as jpg
from occuspytial_tpu_torch import (
    LogitICARGibbs,
    LogitRSRGibbs,
    ProbitICARGibbs,
    ProbitRSRGibbs,
)
from occuspytial_tpu_torch.convert import carry_from_jax
from occuspytial_tpu_torch.models.field import GRAPH_AUTO_THRESHOLD

torch.set_num_threads(1)

ROWS, COLS = 10, 15
REGIMES = {'stencil': dict(lattice=(ROWS, COLS, 8)),
           'graph': dict(solver='graph')}
FAMILIES = {'logit': (JaxLogit, LogitICARGibbs),
            'probit': (JaxProbit, ProbitICARGibbs)}


@functools.lru_cache(maxsize=None)
def _data():
    return make_lattice_dataset(ROWS, COLS, ns=90, seed=3)


def _q(regime):
    q = _data()[0]
    return sps.csr_matrix(q) if regime == 'graph' else q


@functools.lru_cache(maxsize=None)
def _pair(family, regime, **kwargs):
    """(JAX sampler, port sampler) of one family and regime."""
    jcls, tcls = FAMILIES[family]
    _, W, X, y = _data()[:4]
    kw = dict(REGIMES[regime], **kwargs)
    return (jcls(_q(regime), W, X, y, random_state=3, **kw),
            tcls(_q(regime), W, X, y, random_state=3, device='cpu', **kw))


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _start(js, seed=0):
    """A JAX carry's chain-0 state (jnp; probit utilities set to the
    linear predictor plus noise) and the same state in the port."""
    keys, states = js.init_carry(chains=1)
    states = {k: np.asarray(v) for k, v in states.items()}
    if 'omega_b' in states:
        x = np.asarray(js.fixed['X'])
        loc = states['beta'][0] @ x.T + states['spatial'][0] \
            + states['eps'][0]
        states['omega_b'] = (
            loc + np.random.default_rng(seed).normal(size=js.n)
        ).astype(np.float32)[None]
    jstate = {k: jnp.asarray(v[0]) for k, v in states.items()}
    carry = carry_from_jax(np.asarray(jax.random.key_data(keys)), states,
                           device='cpu')
    return jstate, dict(carry.states)


def _field_normals(js, key):
    """The normals the JAX regime's ``noise`` draws from ``key``, flat in
    the layout the port's reads."""
    if js.solver == 'stencil':
        lat = js.lattice
        dirs = [(0, 1), (1, 0)] + (
            [(1, 1), (1, -1)] if lat.max_neighbors == 8 else [])
        keys = jax.random.split(key, len(dirs) + 1)
        parts = [jax.random.normal(k, (lat.rows - dr, lat.cols - abs(dc)),
                                   jnp.float32).ravel()
                 for (dr, dc), k in zip(dirs, keys[:-1])]
        if lat.rho < 1.0:
            parts.append(jax.random.normal(keys[-1], (lat.n,), jnp.float32))
    else:
        k_e, k_d = jax.random.split(key)
        parts = [jax.random.normal(k_e, (js.graph.n_edges,), jnp.float32)]
        if js.graph.has_surplus:
            parts.append(jax.random.normal(k_d, (js.n,), jnp.float32))
    return np.concatenate([np.asarray(p) for p in parts])


def _omega(n, seed):
    return np.random.default_rng(seed).uniform(0.05, 0.3, n).astype(
        np.float32)


@pytest.mark.parametrize('family', sorted(FAMILIES))
@pytest.mark.parametrize('regime', sorted(REGIMES))
def test_defaults_and_fixed_arrays_equal_jax(family, regime):
    js, ps = _pair(family, regime)
    for name in ('solver', 'cg_iters', 'spatial_sweeps', 'graph_rank',
                 'graph_block', 'lattice'):
        want, got = getattr(js, name), getattr(ps, name)
        if name == 'lattice' and want is not None:
            want, got = (want.rows, want.cols, want.max_neighbors,
                         want.rho), (got.rows, got.cols, got.max_neighbors,
                                     got.rho)
        assert got == want, name
    assert ps.solver == regime
    if family == 'probit':
        assert ps.collapsed is js.collapsed is False
    if regime == 'graph':
        assert (ps.graph.n, ps.graph.k_max, ps.graph.n_edges,
                ps.graph.deflate, ps.graph.block, ps.graph.n_pad) == (
            js.graph.n, js.graph.k_max, js.graph.n_edges, js.graph.deflate,
            js.graph.block, js.graph.n_pad)
    extra = {'gr_inc_idx', 'gr_inc_w'} if regime == 'graph' else set()
    assert set(ps.fixed) == set(js.fixed) | extra
    assert 'Q' not in ps.fixed and 'sqrt_factor' not in ps.fixed
    for name, want in js.fixed.items():
        np.testing.assert_array_equal(ps.fixed[name].numpy(),
                                      np.asarray(want), err_msg=name)
    carry = ps.init_carry(2)
    assert sorted(carry.states) == sorted(js.init_carry(2)[1])
    rows = 2 if family == 'probit' else ps.n_beta + 3
    assert carry.states['eta_warm'].shape == (2, rows, ps.n)
    assert ps._solver_checked


@pytest.mark.parametrize('regime', sorted(REGIMES))
def test_logit_blocked_update_matches_jax(regime):
    js, ps = _pair('logit', regime)
    jstate, pstate = _start(js)
    omega = _omega(js.n, 1)
    tau = jstate['tau']
    # two successive solves: the second starts warm from the first
    for step in range(2):
        key = jax.random.key(20 + step)
        jb, je = js._update_beta_eta_blocked(
            key, jstate, jnp.asarray(omega), tau, js.fixed
        )
        k_beta, k_eps1, k_noise = jax.random.split(key, 3)
        pb, pe = ps._update_beta_eta_blocked(
            pstate, _t(omega)[None], _t(tau)[None], ps.fixed,
            _t(jax.random.normal(k_beta, (js.n_beta,), jnp.float32))[None],
            _t(jax.random.normal(k_eps1, (js.n,), jnp.float32))[None],
            _t(_field_normals(js, k_noise))[None],
        )
        _close(pb, np.asarray(jb)[None])
        _close(pe, np.asarray(je)[None])
        # the carry holds h = Lambda^{-1} 1, nearly the constant mode of
        # tau*Q + diag(omega), whose condition number (~ tau * 16 /
        # mean(omega), 5e3 here) scales float32 rounding of the two
        # operator forms (sums against the JAX package's products) to
        # ~1e-4 of h; the projected eta above agrees to 1e-5
        _close(pstate['eta_warm'], np.asarray(jstate['eta_warm'])[None],
               1e-3)
        _close(pstate['solver_resid'],
               np.asarray(jstate['solver_resid'])[None])


@pytest.mark.parametrize('regime', sorted(REGIMES))
def test_logit_unblocked_eta_update_matches_jax(regime):
    js, ps = _pair('logit', regime, blocked=False)
    jstate, pstate = _start(js)
    omega = _omega(js.n, 2)
    tau = jstate['tau']
    for step in range(2):
        key = jax.random.key(30 + step)
        je, _ = js._update_eta(key, jstate, jnp.asarray(omega), tau,
                               js.fixed)
        k1, k2 = jax.random.split(key)
        pe, ps_ = ps._update_eta(
            pstate, _t(omega)[None], _t(tau)[None], ps.fixed,
            _t(jax.random.normal(k1, (js.n,), jnp.float32))[None],
            _t(_field_normals(js, k2))[None],
        )
        assert ps_ is pe
        _close(pe, np.asarray(je)[None])
        # h = Lambda^{-1} 1 in the carry: see the blocked test
        _close(pstate['eta_warm'], np.asarray(jstate['eta_warm'])[None],
               1e-3)
        assert abs(float(pe.sum())) < 1e-3


@pytest.mark.parametrize('regime', sorted(REGIMES))
def test_probit_eta_update_matches_jax(regime):
    js, ps = _pair('probit', regime)
    jstate, pstate = _start(js)
    tau = jstate['tau']
    for step in range(2):
        key = jax.random.key(40 + step)
        je, _ = js._update_eta(key, jstate, jstate['omega_b'], tau,
                               js.fixed)
        k1, k2 = jax.random.split(key)
        eps = np.concatenate([
            np.asarray(jax.random.normal(k1, (js.n,), jnp.float32)),
            _field_normals(js, k2),
        ])
        assert eps.size == ps._eta_noise_dim
        pe, _ = ps._update_eta(pstate, pstate['omega_b'], _t(tau)[None],
                               ps.fixed, _t(eps)[None])
        _close(pe, np.asarray(je)[None])
        _close(pstate['eta_warm'], np.asarray(jstate['eta_warm'])[None])
        _close(pstate['solver_resid'],
               np.asarray(jstate['solver_resid'])[None])
    # and the quadratic form of the tau update
    _close(ps._eta_quad(pe, ps.fixed), np.asarray(
        js._eta_quad(je, js.fixed))[None])


@pytest.mark.parametrize('family', sorted(FAMILIES))
@pytest.mark.parametrize('regime', sorted(REGIMES))
@pytest.mark.parametrize('iters', [1, 2])
def test_solver_residual_matches_jax(family, regime, iters):
    """Cut short, so the residual (1e-3 and more) is far above float32
    rounding and the CG has not yet amplified it; the logit check draws
    omega through its PG path, so the port's is handed the JAX draw."""
    js, ps = _pair(family, regime, cg_iters=iters, solver_check_tol=None)
    keys, states = js.init_carry(chains=1)
    carry = carry_from_jax(np.asarray(jax.random.key_data(keys)),
                           {k: np.asarray(v) for k, v in states.items()},
                           device='cpu')
    if family == 'logit':
        lin_b = (np.asarray(js.fixed['X']) @ np.asarray(states['beta'][0])
                 + np.asarray(states['spatial'][0]))
        omega = np.asarray(jpg(jax.random.key(0), jnp.asarray(lin_b)))
        ps._pg = lambda subkeys, z: _t(omega)[None]
    want = js.solver_residual((keys, states))
    got = ps.solver_residual(carry)
    assert want > 1e-4
    assert got == pytest.approx(want, rel=1e-3)


def test_graph_basis_takes_eig_dtype():
    """The logit sampler stores the deflation basis in ``eig_dtype`` (the
    JAX package's policy); the products cast the rows to it and back."""
    _, W, X, y = _data()[:4]
    s = LogitICARGibbs(_q('graph'), W, X, y, random_state=2, solver='graph',
                       eig_dtype='float64', device='cpu')
    assert s.fixed['gr_defl_vecs_p'].dtype == torch.float64
    assert s.fixed['gr_bd_diag'].dtype == torch.float32
    post = s.sample(3, chains=2, progressbar=False)
    assert np.isfinite(post['beta']).all() and s.last_solver_resid < 1e-3


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_cold_start_check_raises_when_starved(family):
    _, W, X, y = _data()[:4]
    cls = FAMILIES[family][1]
    starved = cls(_q('graph'), W, X, y, random_state=1, solver='graph',
                  cg_iters=1, graph_rank=0, device='cpu')
    assert starved.graph.deflate == 0
    with pytest.raises(RuntimeError, match='did not converge'):
        starved.init_carry(1)
    with pytest.raises(ValueError, match='sites'):
        cls(jlattice(10, 12, 8).tocsr(), W, X, y, solver='graph',
            device='cpu')
    with pytest.raises(ValueError, match='does not match'):
        cls(_q('stencil'), W, X, y, lattice=(ROWS, COLS, 4), device='cpu')
    with pytest.raises(ValueError, match='requires the `lattice`'):
        cls(_q('stencil'), W, X, y, solver='stencil', device='cpu')


@pytest.mark.parametrize('family,regime', [
    ('logit', 'cg'), ('logit', 'stencil'), ('logit', 'graph'),
    ('probit', 'stencil'), ('probit', 'graph'), ('logit', 'rsr'),
    ('probit', 'rsr'),
])
def test_both_links_share_one_field_policy(family, regime):
    """Both ICAR samplers resolve a matrix-free regime alike (solver,
    cg_iters, graph_rank, from the one spatial field), and a starved
    iterative solve trips the same cold-start check in either link; an
    RSR sampler never runs the check, however starved its settings."""
    _, W, X, y = _data()[:4]
    if regime == 'rsr':
        cls = {'logit': LogitRSRGibbs, 'probit': ProbitRSRGibbs}[family]
        s = cls(_q('stencil'), W, X, y, random_state=1, q=12,
                device='cpu')
        s.solver, s.cg_iters, s.solver_check_tol = 'cg', 1, 1e-12
        carry = s.init_carry(1)
        assert 'solver_resid' not in carry.states
        assert not getattr(s, '_solver_checked', False)
        assert not s._solves_lambda and s._band_layout == 'dense'
        return
    if regime != 'cg':
        logit, probit = (_pair(f, regime)[1] for f in ('logit', 'probit'))
        assert (logit.solver, logit.cg_iters, logit.graph_rank) == \
            (probit.solver, probit.cg_iters, probit.graph_rank)
        assert logit._band_layout == probit._band_layout == regime
    kw = dict(REGIMES.get(regime, {'solver': regime}), cg_iters=1,
              solver_check_tol=1e-6)
    if regime == 'graph':
        kw['graph_rank'] = 0
    starved = FAMILIES[family][1](_q(regime), W, X, y, random_state=1,
                                  device='cpu', **kw)
    with pytest.raises(RuntimeError, match=rf"^eta solver \('{regime}', "
                       r'cg_iters=1\) did not converge: cold-start'):
        starved.init_carry(1)
    assert starved._solver_checked


def test_probit_collapsed_raises_for_the_iterative_regimes():
    _, W, X, y = _data()[:4]
    for regime in REGIMES:
        with pytest.raises(ValueError, match='collapsed'):
            ProbitICARGibbs(_q(regime), W, X, y, collapsed=True,
                            device='cpu', **REGIMES[regime])
        with pytest.raises(ValueError, match='collapsed'):
            JaxProbit(_q(regime), W, X, y, collapsed=True,
                      **REGIMES[regime])


def test_sparse_q_from_4096_sites_selects_graph_like_jax():
    """A sparse Q from 4096 sites resolves to 'graph' with the JAX
    samplers' defaults there (JAX ``models/logit.py`` and ``probit.py``:
    rank ``auto_graph_rank(4096)`` = 256, hence 10 iterations, one sweep,
    the reference-ordered probit ladder); a dense Q does not."""
    from occuspytial_tpu.models.logit import auto_graph_rank as jrank

    n, rows = GRAPH_AUTO_THRESHOLD, 64
    q = jlattice(rows, n // rows, 8)
    # survey data by hand: make_data's dense pseudo-inverse at 4096 sites
    # would take minutes
    gen = np.random.default_rng(0)
    X = np.c_[np.ones(n), gen.uniform(-2, 2, n)]
    W = {int(i): np.c_[np.ones(3), gen.uniform(-2, 2, 3)]
         for i in gen.choice(n, 40, replace=False)}
    y = {i: gen.integers(0, 2, 3) for i in W}
    for cls in (LogitICARGibbs, ProbitICARGibbs):
        ps = cls(q, W, X, y, random_state=0, device='cpu')
        assert (ps.solver, ps.graph_rank, ps.cg_iters, ps.spatial_sweeps) \
            == ('graph', jrank(n), 10, 1)
        assert ps.graph.deflate == 256 and ps.graph.block == 128
        assert 'gr_idx' in ps.fixed and 'Q' not in ps.fixed
        assert getattr(ps, 'collapsed', False) is False
        post = ps.sample(2, chains=2, progressbar=False)
        assert np.isfinite(post['beta']).all()
    q, W, X, y = _data()[:4]
    assert LogitICARGibbs(sps.csr_matrix(q), W, X, y,
                          device='cpu').solver == 'chol'
    assert ProbitICARGibbs(sps.csr_matrix(q), W, X, y,
                           device='cpu').solver == 'spectral'


@pytest.mark.parametrize('family', sorted(FAMILIES))
@pytest.mark.parametrize('regime', sorted(REGIMES))
def test_jax_saved_carry_loads_and_resumes(family, regime, tmp_path):
    js, ps = _pair(family, regime)
    keys, states = js.init_carry(chains=2)
    path = tmp_path / 'carry.npz'
    js.save_carry(path, (keys, states))
    carry = ps.load_carry(path)
    assert sorted(carry.states) == sorted(states)
    for name, val in states.items():
        np.testing.assert_array_equal(carry.states[name].numpy(),
                                      np.asarray(val))
    post = ps.sample(3, chains=2, progressbar=False, resume_from=carry)
    assert np.isfinite(post['beta']).all()
    assert ps.final_carry.step == 3
    assert ps.last_solver_resid <= ps.solver_check_tol


@pytest.mark.parametrize('family', sorted(FAMILIES))
@pytest.mark.parametrize('regime', sorted(REGIMES))
def test_chain_count_and_resume_bitwise(family, regime, tmp_path):
    _, W, X, y = _data()[:4]
    cls = FAMILIES[family][1]

    def make():
        return cls(_q(regime), W, X, y, random_state=5, device='cpu',
                   **REGIMES[regime])

    whole = make().sample(5, chains=2, progressbar=False)
    more = make().sample(5, chains=3, progressbar=False)
    s = make()
    first = s.sample(2, chains=2, progressbar=False)
    path = tmp_path / 'carry.npz'
    s.save_carry(path, s.final_carry)
    second = s.sample(3, chains=2, progressbar=False,
                      resume_from=s.load_carry(path))
    for name in ('alpha', 'beta', 'tau'):
        if regime == 'stencil':
            # the graph regime's deflation products fold all chains' rows
            # into one matrix, which the CPU library blocks by row count
            np.testing.assert_array_equal(more[name][:2], whole[name])
        np.testing.assert_array_equal(
            np.concatenate([first[name], second[name]], axis=1), whole[name]
        )
