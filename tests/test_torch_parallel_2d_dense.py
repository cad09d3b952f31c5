"""The port's 2-D (chains x sites) sampler on the CPU for the RSR samplers
and the dense eta regimes: ``sample_parallel_2d`` for ``LogitICARGibbs``
``'chol'`` and ``'cg'`` (also with ``pg_method='gamma'``),
``ProbitICARGibbs`` ``'spectral'``, ``LogitRSRGibbs`` and
``ProbitRSRGibbs``.

The data are those of ``tests/test_torch_parallel_2d.py`` (the JAX 2-D
test's 16 x 10 lattice, 160 sites), with no lattice named, so the samplers
take their dense regimes. A band is a run of 40 (2 x 2) sites: each rank
holds its rows of the Moran basis, of the noise factor or of the spectral
eigenbasis, sums its contractions over its chain row, and gathers the
field for a solve or a quad form (``parallel/sharded_dense.py``). A 2 x 2
mesh (4 chains) matches the unsharded run to the JAX 2-D test's tolerance,
a 1 x 1 mesh bit for bit. The band operators run in a world of 2 ranks on
seeded numpy inputs against the port's unsharded ops (and the JAX CG) on
the gathered field, and the slice as a whole against the JAX
``sample_parallel_2d`` on a 2 x 2 virtual-device mesh by posterior means.

The rank function below runs in the workers, which import this module:
it imports no JAX at the top.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_parallel_2d import ATOL, DATA, RTOL, _mesh

from occuspytial_tpu_torch import (
    LogitICARGibbs,
    LogitRSRGibbs,
    ProbitICARGibbs,
    ProbitRSRGibbs,
    rng,
)
from occuspytial_tpu_torch import diagnostics as dg
from occuspytial_tpu_torch.models import logit, probit
from occuspytial_tpu_torch.ops import icar
from occuspytial_tpu_torch.ops.cg import icar_cg_solve_spectral
from occuspytial_tpu_torch.ops.mvnorm import (
    constrained_icar_mvnorm_unit,
    lambda_cholesky_solve,
    rsr_mvnorm,
)
from occuspytial_tpu_torch.ops.polyagamma import pg_gamma
from occuspytial_tpu_torch.parallel import (
    _gather_row,
    _site_states,
    sample_parallel_2d,
    shard_sampler_2d,
)
from occuspytial_tpu_torch.parallel._spmd import World
from occuspytial_tpu_torch.parallel.sharded_dense import site_bands
from occuspytial_tpu_torch.parallel.sharded_stencil import BandSites

torch.set_num_threads(1)

N = 160
#: sampler and keywords of each case; 15 CG iterations is the JAX 2-D
#: test's budget at this size
CASES = {
    'chol': (LogitICARGibbs, dict(solver='chol')),
    'cg': (LogitICARGibbs, dict(solver='cg', cg_iters=15)),
    'cg-gamma': (LogitICARGibbs,
                 dict(solver='cg', cg_iters=15, pg_method='gamma')),
    'spectral': (ProbitICARGibbs, {}),
    'logit-rsr': (LogitRSRGibbs, {}),
    'probit-rsr': (ProbitRSRGibbs, {}),
}
ICAR = ('chol', 'cg', 'cg-gamma', 'spectral')


def _make(case):
    cls, kw = CASES[case]
    return cls(*DATA, random_state=4, device='cpu', **kw)


@functools.lru_cache(maxsize=None)
def _run(case, shape=None):
    """One case's 6-step run of 4 chains, in one process (``shape``
    None) or over a (chains, sites) mesh; the sampler and the posterior
    (one run a case and shape in the module)."""
    s = _make(case)
    if shape is None:
        return s, s.sample(6, chains=4, progressbar=False)
    return s, sample_parallel_2d(s, 6, _mesh(*shape), chains=4, timed=True)


@pytest.mark.parametrize('case', list(CASES))
def test_2x2_mesh_matches_unsharded(case):
    local_s, local = _run(case)
    two_s, two = _run(case, (2, 2))
    for name in ('alpha', 'beta'):
        np.testing.assert_allclose(two[name], local[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(two['tau'], local['tau'], rtol=RTOL)
    carry, want = two_s.final_carry, local_s.final_carry
    assert carry.step == 6 and torch.equal(carry.keys, want.keys)
    for name, val in want.states.items():
        assert carry.states[name].shape == val.shape, name
    eta = carry.states['eta']
    if case in ICAR:
        # every chain's eta on its sum-to-zero plane
        drift = (eta.sum(-1).abs() / eta.abs().sum(-1)).max()
        assert float(drift) < 1e-5
    else:
        assert eta.shape == (4, two_s.q_dim)
    np.testing.assert_allclose(carry.states['spatial'],
                               want.states['spatial'], rtol=RTOL,
                               atol=10 * ATOL)
    # timed: the dense solves' and quad forms' gathers ('field'), the RSR
    # samplers none; the site sums
    for stats in two_s.rank_collectives:
        assert ('field' in stats) == (case in ICAR)
        assert stats['sum'][1] > 4 * 8
    if case in ('cg', 'cg-gamma'):
        assert two_s.last_solver_resid < two_s.solver_check_tol


@pytest.mark.parametrize('case', ['cg', 'logit-rsr'])
def test_1x1_mesh_is_bit_identical(case):
    """With one site rank the band is the field: the gathers, the site
    hook, the tables and the lane table change no bit."""
    local_s, local = _run(case)
    one_s, one = _run(case, (1, 1))
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(one[name], local[name])
    for name, val in local_s.final_carry.states.items():
        assert torch.equal(one_s.final_carry.states[name], val), name


@pytest.mark.parametrize('case', ['cg', 'spectral', 'logit-rsr',
                                  'probit-rsr'])
def test_dense_band_draws_are_the_fields_words(case):
    """Each band draws the field's words at its sites and visits; the
    normals no site indexes (the noise factor's n - 1, the spectral
    draw's n modes, RSR's q) and the per-chain draws stay whole."""
    s = _make(case)
    carry = s.init_carry(2)
    full = s._plan(carry.keys, 5)
    for view, _ in shard_sampler_2d(s, carry, _mesh(1, 4)):
        band = view._band
        got = view._plan(carry.keys, 5)
        assert got.keys() == full.keys()
        sl = slice(band.site0, band.site1)
        two = slice(2 * band.site0, 2 * band.site1)
        site_updates = {view._z_update: sl}
        for i in range(s.spatial_sweeps):
            if isinstance(s, LogitICARGibbs):  # eps1
                uid = 1 + logit._SWEEP_UPDATES * i + logit._EPS1
            else:  # eps
                uid = 2 + probit._SWEEP_UPDATES * i + probit._EPS
            site_updates[uid] = two
        if not isinstance(s, LogitICARGibbs):
            site_updates[probit._OMEGA_B] = sl  # the site utilities
            site_updates[view._omega_a_update] = slice(band.visit0,
                                                       band.visit1)
        for uid, words in full.items():
            want = words[:, site_updates[uid]] if uid in site_updates \
                else words
            assert torch.equal(got[uid], want), uid


def test_pg_gamma_lane_table_draws_the_fields_words():
    """``pg_gamma`` with a lane table draws, column for column, what the
    whole draw gives those lanes (the 2-D run's ``pg_method='gamma'``)."""
    gen = np.random.default_rng(3)
    keys = torch.as_tensor(gen.integers(0, 2 ** 32, (3, 2)),
                           dtype=torch.int64)
    z = torch.as_tensor(gen.normal(0, 2, (3, 50)), dtype=torch.float32)
    full = pg_gamma(keys, z)
    lanes = torch.as_tensor([7, 0, 49, 8, 9, 30])
    np.testing.assert_array_equal(pg_gamma(keys, z[:, lanes], lanes=lanes),
                                  full[:, lanes])
    words = rng.words(keys, 4, 9, 50 * 6).reshape(3, 50, 6)
    np.testing.assert_array_equal(
        rng.lane_words(keys, 4, 9, lanes, 6).reshape(3, -1, 6),
        words[:, lanes])


def test_rsr_eta_stays_whole_when_a_band_has_q_sites():
    """An RSR eta is (chains, q) in the Moran basis: with 8 bands of 20
    sites and q = 20 it is still given whole to every band and read back
    from site rank 0 (once the ranks agree), not joined over the bands;
    its site field is cut."""
    s = LogitRSRGibbs(*DATA, random_state=4, q=20, device='cpu')
    carry = s.init_carry(2)
    parts = shard_sampler_2d(s, carry, _mesh(1, 8))
    assert len(parts) == 8
    for view, (_, states, _) in parts:
        assert view.n == 20 == s.q_dim
        assert view.fixed['K'].shape == (20, 20)
        assert torch.equal(view.fixed['Q_rsr'], s.fixed['Q_rsr'])
        assert torch.equal(states['eta'], carry.states['eta'])
        band = view._band
        assert torch.equal(states['spatial'], carry.states['spatial'][
            :, band.site0:band.site1])
    cut = _site_states(s)
    row = [{'states': {k: v.numpy() for k, v in p[1][1].items()}}
           for p in parts]
    eta = _gather_row(row, 'eta', cut, 'states')
    np.testing.assert_array_equal(eta, carry.states['eta'].numpy())
    np.testing.assert_array_equal(
        _gather_row(row, 'spatial', cut, 'states'),
        carry.states['spatial'].numpy())
    row[3]['states']['eta'] = row[3]['states']['eta'] + 1.0
    with pytest.raises(RuntimeError, match="site rank 3 holds other 'eta'"):
        _gather_row(row, 'eta', cut, 'states')


def _dense_rank(rhs, warm, omega, tau, u, s, q_dense, b_rows, eps_b, b_rsr,
                k_rows, q_rsr, e_rsr, eps1, eps2, b_unit, u_rows, eps_unit,
                iters):
    """Rank body: the band's gathered CG and Cholesky solves, its rows of
    the ICAR noise, the RSR draw and the unit-noise draw with the band's
    site hook."""
    rank, world = dist.get_rank(), dist.get_world_size()
    band = site_bands(N, np.zeros(0, np.int64), world)[rank]
    sites = BandSites(None, span=slice(band.site0, band.site1), n=N)
    rhs_f, warm_f, omega_f = sites.gather(rhs, warm, omega)
    x, x_spec = icar_cg_solve_spectral(rhs_f, warm_f, omega_f, tau, u, s,
                                       iters)
    rhs_f, omega_f = sites.gather(rhs, omega)
    chol = lambda_cholesky_solve(rhs_f, omega_f, tau, q_dense)
    noise = eps_b @ b_rows.T
    eta_rsr = rsr_mvnorm(b_rsr, omega, tau, q_rsr, k_rows, e_rsr, eps1, eps2,
                         sites=sites)
    eta_unit = constrained_icar_mvnorm_unit(b_unit, tau, u_rows, s,
                                            eps_unit, sites=sites)
    return (sites.band(x), sites.band(x_spec), sites.band(chol), noise,
            eta_rsr, eta_unit)


def test_band_operators_match_the_field_and_jax():
    """In a world of 2 ranks, on seeded inputs: the gathered eigenbasis
    CG against the port's solve on the field (bit for bit: the same call)
    and against the JAX ``icar_cg_solve_spectral`` (1e-4); the gathered
    Cholesky solve and the band rows of ``B eps`` against the field's (bit
    for bit); ``rsr_mvnorm`` (the same draw on both ranks) and
    ``constrained_icar_mvnorm_unit`` with the band's site hook against
    the unsharded draws (1e-5)."""
    import jax
    import jax.numpy as jnp

    from occuspytial_tpu.ops import cg as jcg

    q_dense = icar.to_dense(DATA[0])
    s_eig, u_eig, b_fac = icar.icar_spectral(q_dense)
    rsr = LogitRSRGibbs(*DATA, random_state=4, device='cpu')
    k_basis = rsr.fixed['K'].numpy()
    q_rsr, e_rsr = rsr.fixed['Q_rsr'].numpy(), rsr.fixed['sqrt_factor']
    q = q_rsr.shape[0]
    gen = np.random.default_rng(8)
    chains, rows, iters = 2, 3, 6

    def f32(*shape, lo=None):
        if lo is None:
            return gen.standard_normal(shape).astype(np.float32)
        return gen.uniform(lo, 1.0, shape).astype(np.float32)

    rhs, warm = f32(chains, rows, N), 0.1 * f32(chains, rows, N)
    omega = f32(chains, N, lo=0.05)
    tau = gen.uniform(0.5, 20.0, chains).astype(np.float32)
    eps_b, b_rsr = f32(chains, N - 1), f32(chains, q)
    eps1, eps2 = f32(chains, N), f32(chains, e_rsr.shape[1])
    b_unit, eps_unit = f32(chains, N), f32(chains, N)
    u32, s32 = u_eig.astype(np.float32), s_eig.astype(np.float32)
    b32, q32 = b_fac.astype(np.float32), q_dense.astype(np.float32)
    args = []
    for band in site_bands(N, np.zeros(0, np.int64), 2):
        sl = slice(band.site0, band.site1)
        args.append((rhs[..., sl], warm[..., sl], omega[:, sl], tau, u32,
                     s32, q32, b32[sl], eps_b, b_rsr, k_basis[sl], q_rsr,
                     e_rsr.numpy(), eps1[:, sl], eps2, b_unit[:, sl],
                     u32[sl], eps_unit, iters))
    with World(2, ['cpu'] * 2) as w:
        outs = w.run_each(_dense_rank, args)
    x, x_spec, chol, noise = (
        np.concatenate([o[i] for o in outs], axis=-1) for i in range(4))
    t = torch.as_tensor
    want = icar_cg_solve_spectral(t(rhs), t(warm), t(omega), t(tau), t(u32),
                                  t(s32), iters)
    np.testing.assert_array_equal(x, want[0].numpy())
    np.testing.assert_array_equal(x_spec, want[1].numpy())
    jwant = jax.vmap(lambda r, w, o, tt: jcg.icar_cg_solve_spectral(
        r, w, o, tt, jnp.asarray(u32), jnp.asarray(s32), iters))(
        jnp.asarray(rhs), jnp.asarray(warm), jnp.asarray(omega),
        jnp.asarray(tau))
    for got, ref in zip((x, x_spec), jwant):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(
        chol, lambda_cholesky_solve(t(rhs), t(omega), t(tau),
                                    t(q32)).numpy())
    np.testing.assert_array_equal(noise, (t(eps_b) @ t(b32).T).numpy())
    want = rsr_mvnorm(t(b_rsr), t(omega), t(tau), t(q_rsr), t(k_basis),
                      e_rsr, t(eps1), t(eps2)).numpy()
    for o in outs:
        np.testing.assert_allclose(o[4], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(outs[0][4], outs[1][4])
    unit = np.concatenate([o[5] for o in outs], axis=-1)
    want = constrained_icar_mvnorm_unit(t(b_unit), t(tau), t(u32), t(s32),
                                        t(eps_unit)).numpy()
    np.testing.assert_allclose(unit, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_port_2d_rsr_means_match_jax_2d():
    """The slice as a whole: the port's sample_parallel_2d
    (``LogitRSRGibbs``, 2 x 2) against the JAX sample_parallel_2d on a
    2 x 2 virtual-device mesh, by posterior means."""
    import jax
    from jax.sharding import Mesh

    from occuspytial_tpu import LogitRSRGibbs as JaxRSR
    from occuspytial_tpu.parallel import sample_parallel_2d as jax_2d

    size, burnin = 200, 50
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                axis_names=('chains', 'sites'))
    jpost = jax_2d(JaxRSR(*DATA, random_state=3), size, mesh, burnin=burnin,
                   chains=4)
    s = LogitRSRGibbs(*DATA, random_state=3, device='cpu')
    post = sample_parallel_2d(s, size, _mesh(2, 2), burnin=burnin, chains=4)
    for name, dim in (('alpha', 2), ('beta', 3)):
        for j in range(dim):
            ratio = dg.mean_z_ratio(post[name][:, :, j],
                                    jpost[name][:, :, j])
            assert ratio < 1.0, (name, j, ratio)
