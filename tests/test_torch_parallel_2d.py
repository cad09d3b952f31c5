"""The port's 2-D (chains x sites) sampler on the CPU: ``sample_parallel_2d``
for the lattice regime of ``LogitICARGibbs`` and ``ProbitICARGibbs``, the
counterpart of ``tests/test_parallel.py::TestSiteSharded2D``.

Each rank is a spawned process in one gloo world (``parallel._spmd.World``:
a file rendezvous, a ``sites`` subgroup per chain row), on the JAX test's
data: ``_lattice_dataset(16, 10, ns=80, seed=4)`` with ``lattice=(16, 10,
8)``. A 2 x 2 mesh (4 chains, two 8-row bands) matches the unsharded run
to the JAX test's tolerance (partitioned sums round otherwise); a 1 x 1
mesh is bit for bit the unsharded run. The band operators run in a world
of 2 ranks on seeded numpy inputs against the JAX ``ops/stencil``
functions on the gathered field, and the slice as a whole against the
JAX ``sample_parallel_2d`` on a 2 x 2 virtual-device mesh by posterior
means.

The rank function below runs in the workers, which import this module:
it imports no JAX at the top.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
import torch.distributed as dist

from occuspytial_tpu_torch import (
    LogitICARGibbs,
    LogitRSRGibbs,
    ProbitICARGibbs,
)
from occuspytial_tpu_torch import diagnostics as dg
from occuspytial_tpu_torch.ops import stencil as tst
from occuspytial_tpu_torch.parallel import (
    mesh_2d,
    sample_parallel_2d,
    shard_sampler_2d,
)
from occuspytial_tpu_torch.parallel._spmd import World
from occuspytial_tpu_torch.parallel.sharded_stencil import BandOps, bands

torch.set_num_threads(1)

ROWS, COLS = 16, 10
LATTICE = (ROWS, COLS, 8)
RTOL, ATOL = 2e-3, 2e-4


def _lattice_dataset(rows, cols, ns, seed):
    """Survey data on an explicit (rows x cols) lattice: the helper of
    tests/test_parallel.py, on the port's own utilities (the same
    draws)."""
    from occuspytial_tpu_torch.ops.icar import lattice_precision
    from occuspytial_tpu_torch.utils import get_generator

    n = rows * cols
    rng = get_generator(seed)
    q_mat = lattice_precision(rows, cols).astype(float)
    x = rng.uniform(-2, 2, (n, 3))
    x[:, 0] = 1
    beta = rng.standard_normal(3)
    alpha = rng.standard_normal(2)
    z = rng.binomial(1, 1 / (1 + np.exp(-(x @ beta))))
    w, yy = {}, {}
    for s in rng.choice(n, ns, replace=False):
        v = rng.integers(2, 5, endpoint=True)
        w_s = rng.uniform(-2, 2, (v, 2))
        w_s[:, 0] = 1
        d = 1 / (1 + np.exp(-(w_s @ alpha)))
        w[int(s)] = w_s
        yy[int(s)] = rng.binomial(1, z[s] * d)
    return q_mat, w, x, yy


DATA = _lattice_dataset(ROWS, COLS, ns=80, seed=4)


def _make(cls):
    return cls(*DATA, random_state=4, lattice=LATTICE, device='cpu')


def _mesh(chains, sites):
    return mesh_2d(chains, sites, ['cpu'] * (chains * sites))


@pytest.fixture(scope='module', params=[LogitICARGibbs, ProbitICARGibbs],
                ids=['logit', 'probit'])
def runs(request):
    """One model's unsharded 6-step run, its 2 x 2 and 1 x 1 runs and the
    samplers that ran them (their final carries)."""
    cls = request.param
    local_s = _make(cls)
    local = local_s.sample(6, chains=4, progressbar=False)
    two_s, one_s = _make(cls), _make(cls)
    two = sample_parallel_2d(two_s, 6, _mesh(2, 2), chains=4, timed=True)
    one = sample_parallel_2d(one_s, 6, _mesh(1, 1), chains=4)
    return cls, (local_s, local), (two_s, two), (one_s, one)


def test_2x2_mesh_matches_unsharded(runs):
    cls, (local_s, local), (two_s, two), _ = runs
    names = ('alpha', 'beta') if cls is LogitICARGibbs else ('beta',)
    for name in names:
        np.testing.assert_allclose(two[name], local[name], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(two['tau'], local['tau'], rtol=RTOL)
    carry, want = two_s.final_carry, local_s.final_carry
    assert carry.step == 6 and torch.equal(carry.keys, want.keys)
    for name, val in want.states.items():
        assert carry.states[name].shape == val.shape, name
    eta = carry.states['eta']
    # every chain's eta on its sum-to-zero plane
    drift = (eta.sum(-1).abs() / eta.abs().sum(-1)).max()
    assert float(drift) < 1e-5
    np.testing.assert_allclose(carry.states['eta'], want.states['eta'],
                               rtol=RTOL, atol=10 * ATOL)
    assert [len(t) for t in two_s.rank_step_seconds] == [6] * 4
    # timed: the steps after the first two, each CG iteration's DCT
    # all-reduce (15 iterations and the start) and the other sums
    for stats in two_s.rank_collectives:
        assert stats['dct'][1] == 4 * 16 and stats['sum'][1] > 4 * 30
    assert two_s.last_solver_resid < two_s.solver_check_tol


def test_1x1_mesh_is_bit_identical(runs):
    """With one site rank the band is the field: the hook, the tables, the
    lane table and the band operators change no bit."""
    _, (local_s, local), _, (one_s, one) = runs
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(one[name], local[name])
    for name, val in local_s.final_carry.states.items():
        assert torch.equal(one_s.final_carry.states[name], val), name


def test_shard_sampler_2d_layout():
    s = _make(LogitICARGibbs)
    carry = s.init_carry(4)
    parts = shard_sampler_2d(s, carry, _mesh(2, 2))
    assert len(parts) == 4
    for r, (view, (keys, states, step)) in enumerate(parts):
        c, b = divmod(r, 2)
        band = view._band
        assert (band.row0, band.row1) == (8 * b, 8 * (b + 1))
        assert view.n == 80 and view.fixed['X'].shape == (80, 3)
        assert view.fixed['lat_dct_r'].shape == (ROWS, 8)
        assert torch.equal(keys, carry.keys[2 * c:2 * c + 2])
        assert torch.equal(states['eta'],
                           carry.states['eta'][2 * c:2 * c + 2,
                                               80 * b:80 * (b + 1)])
        assert states['eta_warm'].shape == (2, 6, 80)
        assert torch.equal(states['tau'], carry.states['tau'][2 * c:2 * c + 2])
        # the Pólya-Gamma lanes: the band's sites, then n + its visits
        v = s.data.visit_site
        lanes = view._pg_lanes.numpy()
        sites = np.arange(80 * b, 80 * (b + 1))
        visits = np.nonzero((v >= 80 * b) & (v < 80 * (b + 1)))[0]
        np.testing.assert_array_equal(lanes, np.r_[sites, 160 + visits])
        np.testing.assert_array_equal(
            view.fixed['W_flat'].numpy(), s.fixed['W_flat'][visits].numpy())


def test_band_draws_are_the_fields_words():
    """Each band's step draws, word for word, the field's draws at its
    sites and edges (the per-chain draws whole)."""
    s = _make(ProbitICARGibbs)
    keys = s.init_carry(2).keys
    full = s._plan(keys, 5)
    for view, _ in shard_sampler_2d(s, s.init_carry(2), _mesh(1, 2)):
        got = view._plan(keys, 5)
        band = view._band
        sl = slice(band.site0, band.site1)
        assert torch.equal(got[0], full[0][:, sl])  # site utilities
        assert torch.equal(got[view._z_update], full[view._z_update][:, sl])
        va = slice(band.visit0, band.visit1)
        assert torch.equal(got[view._omega_a_update],
                           full[view._omega_a_update][:, va])
        assert torch.equal(got[view._alpha_update],
                           full[view._alpha_update])
        eps = full[2 + 3].reshape(2, -1, 2)[:, sl].reshape(2, -1)
        assert torch.equal(got[2 + 3], eps)


def _band_rank(spec, deg, dct_r, dct_c, sym, v, eps, rhs, x0, omega, tau,
               iters):
    """Rank body: the band's preconditioner apply, noise and solve."""
    rank, world = dist.get_rank(), dist.get_world_size()
    band = bands(spec, np.zeros(0, np.int64), world)[rank]
    ops = BandOps(band, None)
    fixed = {'lat_deg': deg, 'lat_dct_r': dct_r, 'lat_dct_c': dct_c,
             'lat_sym': sym}
    pc = tst.precond_apply(spec, fixed, tau[:, None, None, None], 0.3, v,
                           ops.sites)
    nz = ops.noise(spec, fixed, eps)
    sol = ops.cg_solve(spec, fixed, rhs, x0, omega, tau, iters)
    return pc, nz, sol


def test_band_operators_match_jax_and_the_field():
    """The band DCT preconditioner against the JAX ``precond_apply``
    (1e-5), the band noise against the port's whole-field noise on the
    same normals (bit for bit: each site sums its edges in the same
    order), the band DCT-preconditioned CG against the JAX ``cg_solve``
    (1e-4), all on the gathered field; the solve also against the port's
    single-device solve."""
    import jax.numpy as jnp

    from occuspytial_tpu.ops import stencil as jst

    spec = tst.LatticeSpec(ROWS, COLS, 8)
    fx = tst.setup(spec)
    n = spec.n
    gen = np.random.default_rng(21)
    chains, rows = 2, 3
    v = gen.standard_normal((chains, rows, n)).astype(np.float32)
    eps = gen.standard_normal((chains, tst.noise_dim(spec))).astype(
        np.float32)
    rhs = gen.standard_normal((chains, rows, n)).astype(np.float32)
    x0 = 0.1 * gen.standard_normal((chains, rows, n)).astype(np.float32)
    omega = gen.uniform(0.05, 0.3, (chains, n)).astype(np.float32)
    tau = gen.uniform(0.5, 20.0, chains).astype(np.float32)
    iters = 6
    world = 2
    args = []
    for band in bands(spec, np.zeros(0, np.int64), world):
        sl = slice(band.site0, band.site1)
        rl = slice(band.row0, band.row1)
        args.append((
            spec, fx['lat_deg'][rl], np.ascontiguousarray(
                fx['lat_dct_r'][:, rl]), fx['lat_dct_c'], fx['lat_sym'],
            v[..., sl], eps[:, tst.noise_index(spec, band.row0, band.row1)],
            rhs[..., sl], x0[..., sl], omega[:, sl], tau, iters,
        ))
    with World(world, ['cpu'] * world) as w:
        outs = w.run_each(_band_rank, args)
    pc, nz, sol = (np.concatenate([o[i] for o in outs], axis=-1)
                   for i in range(3))
    jfx = {k: jnp.asarray(a) for k, a in fx.items()}
    jspec = jst.LatticeSpec(ROWS, COLS, 8)
    for c in range(chains):
        want = np.asarray(jst.precond_apply(jspec, jfx, tau[c], 0.3,
                                            jnp.asarray(v[c])))
        np.testing.assert_allclose(pc[c], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        want = np.asarray(jst.cg_solve(
            jspec, jfx, jnp.asarray(rhs[c]), jnp.asarray(x0[c]),
            jnp.asarray(omega[c]), tau[c], iters))
        np.testing.assert_allclose(sol[c], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    tfx = {k: torch.as_tensor(a) for k, a in fx.items()}
    want = tst.noise(spec, tfx, torch.as_tensor(eps)).numpy()
    np.testing.assert_array_equal(nz, want)
    single = tst.cg_solve(spec, tfx, torch.as_tensor(rhs),
                          torch.as_tensor(x0), torch.as_tensor(omega),
                          torch.as_tensor(tau), iters).numpy()
    np.testing.assert_allclose(sol, single, rtol=0,
                               atol=1e-5 * np.abs(single).max())


def test_port_2d_means_match_jax_2d():
    """The slice as a whole: the port's sample_parallel_2d (logit, 2 x 2)
    against the JAX sample_parallel_2d on a 2 x 2 virtual-device mesh, by
    posterior means."""
    import jax
    from jax.sharding import Mesh

    from occuspytial_tpu import LogitICARGibbs as JaxLogit
    from occuspytial_tpu.parallel import sample_parallel_2d as jax_2d

    size, burnin = 200, 50
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                axis_names=('chains', 'sites'))
    jpost = jax_2d(JaxLogit(*DATA, random_state=3, lattice=LATTICE), size,
                   mesh, burnin=burnin, chains=4)
    s = LogitICARGibbs(*DATA, random_state=3, lattice=LATTICE,
                       device='cpu')
    post = sample_parallel_2d(s, size, _mesh(2, 2), burnin=burnin,
                              chains=4)
    for name, dim in (('alpha', 2), ('beta', 3)):
        for j in range(dim):
            ratio = dg.mean_z_ratio(post[name][:, :, j],
                                    jpost[name][:, :, j])
            assert ratio < 1.0, (name, j, ratio)


def test_errors():
    s = _make(LogitICARGibbs)
    # 3 site ranks split neither 160 sites nor 16 rows
    with pytest.raises(ValueError, match='must divide'):
        sample_parallel_2d(s, 2, _mesh(2, 3), chains=2)
    with pytest.raises(ValueError, match="multiple of the 'chains' mesh"):
        sample_parallel_2d(s, 2, _mesh(2, 2), chains=3)
    with pytest.raises(ValueError, match='chains must a positive integer'):
        sample_parallel_2d(s, 2, _mesh(1, 2), chains=0)
    with pytest.raises(ValueError, match='burnin'):
        sample_parallel_2d(s, 2, _mesh(1, 2), burnin=2)
    # the graph regime runs (tests/test_torch_parallel_2d_graph.py), and
    # so do the RSR samplers and the dense regimes, in runs of sites
    # (tests/test_torch_parallel_2d_dense.py)
    graph = LogitICARGibbs(sps.csr_matrix(DATA[0]), *DATA[1:],
                           random_state=4, solver='graph', device='cpu')
    assert len(shard_sampler_2d(graph, graph.init_carry(2),
                                _mesh(1, 2))) == 2
    rsr = LogitRSRGibbs(*DATA, random_state=4, device='cpu')
    carry = rsr.init_carry(2)
    parts = shard_sampler_2d(rsr, carry, _mesh(1, 2))
    assert len(parts) == 2
    for view, (_, states, _) in parts:
        # the Moran basis's rows of the band; eta (chains, q) kept whole
        assert view.n == 80 and view.fixed['K'].shape == (80, rsr.q_dim)
        assert torch.equal(states['eta'], carry.states['eta'])
        assert states['spatial'].shape == (2, 80)
    spectral = ProbitICARGibbs(*DATA, random_state=4, device='cpu')
    parts = shard_sampler_2d(spectral, spectral.init_carry(2), _mesh(1, 2))
    assert [tuple(v.fixed['q_eigvecs'].shape) for v, _ in parts] \
        == [(80, 160)] * 2
    # a dense sampler: 3 site ranks do not split 160 sites (the JAX
    # message)
    with pytest.raises(ValueError, match='must divide the site count 160'):
        sample_parallel_2d(spectral, 2, _mesh(1, 3))
    with pytest.raises(ValueError, match='devices for a'):
        mesh_2d(2, 2, ['cpu'] * 3)
