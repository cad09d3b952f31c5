"""The port's probit samplers against the JAX package's, update by update.

From one JAX state (loaded into the port through its carry format) and
the same noise (made with jax.random on the keys each JAX update would
use, then passed to the port), every update of both ladders agrees to
1e-4 of the largest entry: float32 with sums in other orders. The z draw
compares uniforms with probabilities, so a site may flip only where its
uniform lies within 1e-5 of its threshold. The dataset is the JAX
bench's 10 x 10 queen lattice (configs 2 and 2b), through chip_smoke.py's
copy of its generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from scipy.special import ndtr

from chip_smoke import make_lattice_dataset
from occuspytial_tpu.models.probit import ProbitICARGibbs as JaxICAR
from occuspytial_tpu.models.probit import ProbitRSRGibbs as JaxRSR
from occuspytial_tpu.ops import mvnorm as jmv
from occuspytial_tpu_torch import ProbitICARGibbs, ProbitRSRGibbs, rng
from occuspytial_tpu_torch.convert import carry_from_jax
from occuspytial_tpu_torch.ops import mvnorm as tmv

# the tensors here are small: one intra-op thread is faster than many,
# and the suite already runs in parallel worker processes
torch.set_num_threads(1)

CLASSES = {'rsr': (JaxRSR, ProbitRSRGibbs), 'icar': (JaxICAR, ProbitICARGibbs)}


@pytest.fixture(scope='module')
def data():
    return make_lattice_dataset(10, 10, ns=50, seed=3)


@pytest.fixture(scope='module')
def pairs(data):
    """(JAX sampler, port sampler) per model and ladder, and with a
    nonzero beta prior mean (the Metropolis PX move)."""
    Q, W, X, y = data[:4]
    out = {}
    for model, (jcls, tcls) in CLASSES.items():
        for collapsed in (True, False):
            out[model, collapsed] = (
                jcls(Q, W, X, y, random_state=3, collapsed=collapsed),
                tcls(Q, W, X, y, random_state=3, collapsed=collapsed,
                     device='cpu'),
            )
        hp = {'b_mu': [0.2, -0.1, 0.0]}
        out[model, 'mh'] = (
            jcls(Q, W, X, y, hparams=hp, random_state=3),
            tcls(Q, W, X, y, hparams=hp, random_state=3, device='cpu'),
        )
    return out


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
    """A JAX carry's chain-0 state with utilities omega_b set to the
    linear predictor plus noise, and the same state in the port."""
    keys, states = js.init_carry(chains=1)
    states = {k: np.asarray(v) for k, v in states.items()}
    x = np.asarray(js.fixed['X'])
    loc = (states['beta'][0] @ x.T + states['spatial'][0]
           + states['eps'][0])
    states['omega_b'] = (
        loc + np.random.default_rng(seed).normal(size=js.n)
    ).astype(np.float32)[None]
    jstate = {k: jnp.asarray(v[0]) for k, v in states.items()}
    carry = carry_from_jax(np.asarray(jax.random.key_data(keys)), states,
                           device='cpu')
    return jstate, dict(carry.states)


def _normal(key, n):
    return _t(jax.random.normal(key, (n,), jnp.float32))[None]


def _uniform(key, n):
    return _t(jax.random.uniform(key, (n,), jnp.float32))[None]


@pytest.mark.parametrize('model', ['rsr', 'icar'])
def test_fixed_arrays_equal_jax(pairs, model):
    js, ps = pairs[model, True]
    assert sorted(ps.fixed) == sorted(js.fixed)
    want_keys = {'rsr': ('K', 'Q_rsr', 'KTK', 'KTX', 'XTX',
                         'XTX_plus_bprec'),
                 'icar': ('Q', 'XTX_plus_bprec', 'q_eigvals', 'q_eigvecs',
                          'UX', 'eig_mask')}[model]
    assert set(want_keys) <= set(ps.fixed)
    for name, want in js.fixed.items():
        want = np.asarray(want)
        got = ps.fixed[name].numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert ps.fixed.get('eig_mask', torch.ones(1, dtype=torch.bool)).dtype \
        == torch.bool
    if model == 'rsr':
        assert ps.q_dim == js.q_dim and 'Q' not in ps.fixed


def test_constrained_icar_mvnorm_unit_matches_jax(pairs):
    _, ps = pairs['icar', True]
    u, s = ps.fixed['q_eigvecs'], ps.fixed['q_eigvals']
    n = u.shape[0]
    gen = np.random.default_rng(5)
    b = gen.normal(size=(3, n)).astype(np.float32)
    tau = np.asarray([0.2, 4.0, 300.0], np.float32)
    keys = jax.random.split(jax.random.key(8), 3)
    want = np.stack([np.asarray(jmv.constrained_icar_mvnorm_unit(
        k, jnp.asarray(b[i]), tau[i], jnp.asarray(u.numpy()),
        jnp.asarray(s.numpy()))) for i, k in enumerate(keys)])
    eps = torch.cat([_normal(k, n) for k in keys])
    got = tmv.constrained_icar_mvnorm_unit(_t(b), _t(tau), u, s, eps)
    _close(got, want)
    assert float(got.sum(dim=-1).abs().max()) < 1e-3


@pytest.mark.parametrize('model', ['rsr', 'icar'])
@pytest.mark.parametrize('collapsed', [True, False])
def test_update_omega_b_matches_jax(pairs, model, collapsed):
    js, ps = pairs[model, collapsed]
    jstate, pstate = _start(js)
    key = jax.random.key(1)
    want = js._update_omega_b(key, jstate, js.fixed)
    got = ps._update_omega_b(pstate, ps.fixed, _uniform(key, js.n))
    _close(got, np.asarray(want)[None])


@pytest.mark.parametrize('model', ['rsr', 'icar'])
def test_reference_ladder_updates_match_jax(pairs, model):
    """eps, eta, beta of collapsed=False, and tau."""
    js, ps = pairs[model, False]
    jstate, pstate = _start(js, 1)
    omega_b = jstate['omega_b']
    tau = jstate['tau']
    key = jax.random.key(2)
    want = js._update_eps(key, jstate, omega_b, js.fixed)
    got = ps._update_eps(pstate, pstate['omega_b'], ps.fixed,
                         _normal(key, js.n))
    _close(got, np.asarray(want)[None])
    key = jax.random.key(3)
    je, jsp = js._update_eta(key, jstate, omega_b, tau, js.fixed)
    pe, psp = ps._update_eta(pstate, pstate['omega_b'], _t(tau)[None],
                             ps.fixed, _normal(key, ps._eta_noise_dim))
    _close(pe, np.asarray(je)[None])
    _close(psp, np.asarray(jsp)[None])
    key = jax.random.key(4)
    want = js._update_beta(key, jstate, omega_b, js.fixed)
    got = ps._update_beta(pstate, pstate['omega_b'], ps.fixed,
                          _normal(key, js.n_beta))
    _close(got, np.asarray(want)[None])
    key = jax.random.key(5)
    want = js._update_tau(key, jstate['eta'], js.fixed)
    g = jax.random.gamma(key, js.fixed['tau_shape'], dtype=jnp.float32)
    got = ps._update_tau(pstate['eta'], ps.fixed, _t(g)[None])
    _close(got, np.asarray(want)[None])


@pytest.mark.parametrize('model', ['rsr', 'icar'])
def test_collapsed_ladder_updates_match_jax(pairs, model):
    """beta with eta and eps out, then eta with eps out (sharing one
    factorization in the port, as in the step)."""
    js, ps = pairs[model, True]
    jstate, pstate = _start(js, 2)
    omega_b = jstate['omega_b']
    # a small tau: the spatial field's share of the utilities' variance
    # is large, so every term of the collapsed precisions shows
    tau = jnp.float32(0.3)
    ptau = _t(tau)[None]
    factor = ps._collapsed_factor(ptau, ps.fixed)
    assert (factor is None) == (model == 'icar')
    key = jax.random.key(6)
    jb = js._update_beta_collapsed(key, jstate, omega_b, tau, js.fixed)
    pb = ps._update_beta_collapsed(pstate, pstate['omega_b'], ptau,
                                   ps.fixed, _normal(key, js.n_beta), factor)
    _close(pb, np.asarray(jb)[None])
    # without the shared factor it is computed: the same draw
    pb2 = ps._update_beta_collapsed(pstate, pstate['omega_b'], ptau,
                                    ps.fixed, _normal(key, js.n_beta))
    torch.testing.assert_close(pb2, pb, rtol=0, atol=0)
    jstate = dict(jstate, beta=jb)
    pstate['beta'] = _t(np.asarray(jb))[None]
    key = jax.random.key(7)
    je, jsp = js._update_eta_collapsed(key, jstate, omega_b, tau, js.fixed)
    pe, psp = ps._update_eta_collapsed(
        pstate, pstate['omega_b'], ptau, ps.fixed,
        _normal(key, ps._eta_noise_dim), factor,
    )
    _close(pe, np.asarray(je)[None])
    _close(psp, np.asarray(jsp)[None])
    if model == 'icar':
        assert float(pe.sum().abs()) < 1e-3


@pytest.mark.parametrize('model', ['rsr', 'icar'])
def test_visit_updates_match_jax(pairs, model, data):
    """omega_a, alpha and z."""
    js, ps = pairs[model, True]
    jstate, pstate = _start(js, 3)
    key = jax.random.key(9)
    ja = js._update_omega_a(key, jstate, js.fixed)
    pa = ps._update_omega_a(pstate, ps.fixed, _uniform(key, js.total_visits))
    _close(pa, np.asarray(ja)[None])
    key = jax.random.key(10)
    want = js._update_alpha(key, jstate, ja, js.fixed)
    got = ps._update_alpha(pstate, _t(ja)[None], ps.fixed,
                           _normal(key, js.n_alpha))
    _close(got, np.asarray(want)[None])
    key = jax.random.key(11)
    zj = np.asarray(js._update_z(key, jstate, js.fixed))
    u = np.asarray(jax.random.uniform(key, (js.n,), jnp.float32))
    zp = ps._update_z(pstate, ps.fixed, _t(u)[None])[0].numpy()
    bad = zp != zj
    if bad.any():
        # float64 occupancy probability of the flipped sites
        f = {k: np.asarray(v, np.float64) for k, v in js.fixed.items()
             if k in ('X', 'W_flat')}
        st = {k: np.asarray(v, np.float64) for k, v in jstate.items()}
        lin = f['X'] @ st['beta'] + st['spatial'] + st['eps']
        log_prod = np.zeros(js.n)
        np.add.at(log_prod, np.asarray(js.fixed['visit_site']),
                  np.log(ndtr(-(f['W_flat'] @ st['alpha']))))
        p = 1.0 / (1.0 + np.exp(-(np.log(ndtr(lin)) + log_prod
                                  - np.log(ndtr(-lin)))))
        assert (np.abs(u[bad] - p[bad]) < 1e-5).all()


@pytest.mark.parametrize('model', ['rsr', 'icar'])
@pytest.mark.parametrize('variant', [(True, True), (True, False),
                                     ('mh', True), ('mh', False)])
def test_px_scale_move_matches_jax(pairs, model, variant):
    """The exact chi draw (zero-mean beta prior) and the Metropolis form,
    each on the eps-marginal and the full density."""
    which, marginal = variant
    js, ps = pairs[model, which]
    assert ps._px_exact == (which is True)
    for seed in range(3):
        jstate, pstate = _start(js, 4 + seed)
        key = jax.random.key(20 + seed)
        want = js._px_scale_move(key, dict(jstate), js.fixed,
                                 marginal=marginal)
        k1, k2 = jax.random.split(key)
        if ps._px_exact:
            d = ps._px_dim(marginal)
            noise = _t(jax.random.gamma(k1, 0.5 * d, dtype=jnp.float32))[None]
        else:
            noise = (_t(jax.random.normal(k1, (), jnp.float32))[None],
                     _t(jax.random.uniform(k2, (), jnp.float32))[None])
        got = ps._px_scale_move(dict(pstate), ps.fixed, noise,
                                marginal=marginal)
        for name in ('omega_b', 'beta', 'eta', 'eps', 'spatial'):
            _close(got[name], np.asarray(want[name])[None])
        if marginal:
            assert torch.equal(got['eps'], pstate['eps'])


@pytest.mark.parametrize('model', ['rsr', 'icar'])
def test_asis_tau_matches_jax(pairs, model):
    js, ps = pairs[model, True]
    jstate, pstate = _start(js, 8)
    key = jax.random.key(31)
    want = js._asis_tau(key, dict(jstate), js.fixed)
    k1, k2 = jax.random.split(key)
    noise = (_t(jax.random.normal(k1, (js.asis_steps,), jnp.float32))[None],
             _t(jax.random.uniform(k2, (js.asis_steps,), jnp.float32))[None])
    got = ps._asis_tau(dict(pstate), ps.fixed, noise)
    for name in ('tau', 'eta', 'spatial'):
        _close(got[name], np.asarray(want[name])[None])


@pytest.mark.parametrize('shape', [0.5 * (2 * 100 + 3 + 99),
                                   0.5 * (2 * 1000 + 3 + 999)])
def test_gamma_moments_at_the_px_shape(shape):
    """The exact PX draw is Gamma(d/2) with d up to 2n + p + (n - 1): the
    port's Marsaglia-Tsang draw has that mean and variance."""
    n = 50_000
    keys = rng.chain_keys(int(shape), n, rng.RUN)
    g = rng.gamma(shape, rng.words(keys, 0, 0, rng.GAMMA_WORDS),
                  torch.float32).double().numpy()
    ref = stats.gamma(shape)
    assert abs(g.mean() - ref.mean()) < 6 * ref.std() / np.sqrt(n)
    assert abs(g.var() / ref.var() - 1.0) < 0.02
    assert np.isfinite(g).all() and (g > 0).all()


def test_defaults_options_and_unported_solvers(data):
    Q, W, X, y = data[:4]
    icar = ProbitICARGibbs(Q, W, X, y, device='cpu')
    assert (icar.solver, icar.spatial_sweeps, icar.collapsed, icar.px,
            icar.asis, icar._px_exact) == ('spectral', 6, True, True, True,
                                           True)
    assert ProbitICARGibbs(Q, W, X, y, spatial_sweeps=2,
                           device='cpu').spatial_sweeps == 2
    assert ProbitRSRGibbs(Q, W, X, y, device='cpu').spatial_sweeps == 1
    for kwargs in (dict(solver='stencil'), dict(solver='graph'),
                   dict(lattice=(10, 10))):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            ProbitICARGibbs(Q, W, X, y, device='cpu', **kwargs)
    for bad in (dict(solver='x'), dict(asis_method='x'),
                dict(spatial_sweeps=0)):
        with pytest.raises(ValueError):
            ProbitICARGibbs(Q, W, X, y, device='cpu', **bad)


@pytest.mark.parametrize('model', ['rsr', 'icar'])
def test_jax_saved_carry_loads_and_runs(pairs, model, tmp_path):
    js, ps = pairs[model, True]
    keys, states = js.init_carry(chains=2)
    path = tmp_path / 'carry.npz'
    js.save_carry(path, (keys, states))
    carry = ps.load_carry(path)
    assert sorted(carry.states) == sorted(states)
    assert sorted(ps.init_carry(2).states) == sorted(states)
    for name, val in states.items():
        np.testing.assert_array_equal(carry.states[name].numpy(),
                                      np.asarray(val))
    post = ps.sample(3, chains=2, progressbar=False, resume_from=carry)
    assert np.isfinite(post['beta']).all()


@pytest.mark.parametrize('cls', [ProbitRSRGibbs, ProbitICARGibbs])
def test_chain0_invariant_to_chain_count_and_resume_is_bitwise(
        data, tmp_path, cls):
    Q, W, X, y = data[:4]

    def make():
        return cls(Q, W, X, y, random_state=5, device='cpu')

    whole = make().sample(6, chains=2, progressbar=False)
    more = make().sample(6, chains=3, progressbar=False)
    s = make()
    first = s.sample(2, chains=2, progressbar=False)
    path = tmp_path / 'carry.npz'
    s.save_carry(path, s.final_carry)
    second = s.sample(4, chains=2, progressbar=False,
                      resume_from=s.load_carry(path))
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(more[name][:2], whole[name])
        np.testing.assert_array_equal(
            np.concatenate([first[name], second[name]], axis=1), whole[name]
        )


@pytest.mark.parametrize('cls', [ProbitRSRGibbs, ProbitICARGibbs])
@pytest.mark.parametrize('kwargs', [
    dict(collapsed=False), dict(px=False, asis=False),
    dict(asis_method='slice'), dict(dtype='float64'),
    dict(hparams={'b_mu': [0.2, -0.1, 0.0]}),
])
def test_option_paths_run(data, cls, kwargs):
    Q, W, X, y = data[:4]
    s = cls(Q, W, X, y, random_state=2, device='cpu', **kwargs)
    s.track = ('z', 'eps')
    post = s.sample(4, chains=2, progressbar=False)
    for name in ('alpha', 'beta', 'tau', 'z', 'eps'):
        assert np.isfinite(post[name]).all()
    assert post['eps'].shape == (2, 4, s.n)
    start = {'eps': np.zeros(s.n), 'beta': [0.1, 0.2, 0.3]}
    carry = s.init_carry(2, start=start)
    assert float(carry.states['eps'].abs().max()) == 0.0
    assert carry.states['eps'].shape == (2, s.n)
