"""The port's 2-D (chains x sites) sampler on an arbitrary graph:
``sample_parallel_2d`` for ``LogitICARGibbs`` and ``ProbitICARGibbs`` with
``solver='graph'``, the counterpart of
``tests/test_parallel.py::TestGraphSiteSharded2D``.

Each rank is a spawned process in one gloo world, as in
``tests/test_torch_parallel_2d.py``, on the JAX test's data:
``_lattice_dataset(16, 10, ns=80, seed=4)`` as a sparse Q, which the
graph regime lays out in 128-site tiles (n = 160, two blocks; ELL with
``graph_block=0``). A 2 x 2 mesh matches the unsharded run to the JAX
test's tolerance (rtol 2e-3, atol 2e-4), a 1 x 1 mesh is bit for bit the
unsharded run. The band operators run in a world of 2 ranks on seeded
numpy inputs against the JAX ``ops/graph`` functions on the gathered
field, and the slice as a whole against the JAX ``sample_parallel_2d``
graph run on a 2 x 2 virtual-device mesh by posterior means.

The rank function below runs in the workers, which import this module:
it imports no JAX at the top.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
import torch.distributed as dist
from test_torch_parallel_2d import DATA

from occuspytial_tpu_torch import LogitICARGibbs, ProbitICARGibbs
from occuspytial_tpu_torch import diagnostics as dg
from occuspytial_tpu_torch.models import field
from occuspytial_tpu_torch.ops import graph as tgr
from occuspytial_tpu_torch.parallel import (
    mesh_2d,
    sample_parallel_2d,
    shard_sampler_2d,
)
from occuspytial_tpu_torch.parallel._spmd import World
from occuspytial_tpu_torch.parallel.sharded_graph import (
    GraphBandOps,
    band_fixed,
    graph_bands,
)

torch.set_num_threads(1)

RTOL, ATOL = 2e-3, 2e-4
Q_SPARSE = sps.csr_matrix(DATA[0])
#: draws of the logit 2 x 2 run: its first 6 are held against the 6-step
#: unsharded run, the rest against the JAX 2-D run by posterior means (a
#: 2 x 2 graph step makes ~140 all-reduces, ~0.2 s on the CPU)
LONG, BURNIN = 100, 20


def _make(cls, **kw):
    return cls(Q_SPARSE, *DATA[1:], random_state=4, solver='graph',
               device='cpu', **kw)


def _mesh(chains, sites):
    return mesh_2d(chains, sites, ['cpu'] * (chains * sites))


@pytest.fixture(scope='module')
def runs():
    """One model's unsharded 6-step run, its 2 x 2 run (logit: LONG steps)
    and 1 x 1 run, and the samplers that ran them; built on first use."""
    cache = {}

    def get(cls):
        if cls not in cache:
            local_s = _make(cls)
            assert local_s.graph.block == 128
            local = local_s.sample(6, chains=4, progressbar=False)
            two_s, one_s = _make(cls), _make(cls)
            size = LONG if cls is LogitICARGibbs else 6
            two = sample_parallel_2d(two_s, size, _mesh(2, 2), chains=4,
                                     timed=True)
            one = sample_parallel_2d(one_s, 6, _mesh(1, 1), chains=4)
            cache[cls] = (local_s, local), (two_s, two), (one_s, one)
        return cache[cls]

    return get


def _plane_drift(eta):
    return float((eta.sum(-1).abs() / eta.abs().sum(-1)).max())


@pytest.mark.parametrize('cls', [LogitICARGibbs, ProbitICARGibbs],
                         ids=['logit', 'probit'])
def test_2x2_mesh_matches_unsharded(runs, cls):
    (local_s, local), (two_s, two), _ = runs(cls)
    names = ('alpha', 'beta') if cls is LogitICARGibbs else ('beta',)
    for name in names:
        np.testing.assert_allclose(two[name][:, :6], local[name], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(two['tau'][:, :6], local['tau'], rtol=RTOL)
    carry, want = two_s.final_carry, local_s.final_carry
    assert torch.equal(carry.keys, want.keys)
    assert set(carry.states) == set(want.states)
    for name, val in want.states.items():
        assert carry.states[name].shape == val.shape, name
    assert _plane_drift(carry.states['eta']) < 1e-5
    # timed: per step the banded solve's two moves, a block halo per CG
    # matvec (24 iterations and the start), the quad form's gather
    solves = 1
    for stats in two_s.rank_collectives:
        steps = two_s.rank_step_seconds[0].size - 2
        assert stats['perm'][1] == 2 * solves * steps
        assert stats['halo'][1] == 25 * solves * steps
        assert stats['gather'][1] >= steps and stats['sum'][1] > 0
    assert two_s.last_solver_resid < two_s.solver_check_tol


@pytest.mark.parametrize('cls', [LogitICARGibbs, ProbitICARGibbs],
                         ids=['logit', 'probit'])
def test_1x1_mesh_is_bit_identical(runs, cls):
    """With one site rank the band is the field and its block run every
    block: the moves, tables, lane table and band operators change no
    bit."""
    (local_s, local), _, (one_s, one) = runs(cls)
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(one[name], local[name])
    for name, val in local_s.final_carry.states.items():
        assert torch.equal(one_s.final_carry.states[name], val), name


def test_ell_layout_1x2_matches_unsharded():
    """graph_block=0: the ELL layout, whose matvec gathers the field
    vector, on two site ranks."""
    local_s = _make(LogitICARGibbs, graph_block=0)
    assert local_s.graph.block == 0
    local = local_s.sample(6, chains=4, progressbar=False)
    s = _make(LogitICARGibbs, graph_block=0)
    post = sample_parallel_2d(s, 6, _mesh(1, 2), chains=4)
    for name in ('alpha', 'beta'):
        np.testing.assert_allclose(post[name], local[name], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(post['tau'], local['tau'], rtol=RTOL)
    assert _plane_drift(s.final_carry.states['eta']) < 1e-5


def _band_ops_rank(spec, arrays, v, eps, rhs, x0, omega, tau, iters):
    """Rank body: the band's matvec, quad form, noise and solve, on the
    rank's device, with the band's arrays cut from the field's."""
    rank, world = dist.get_rank(), dist.get_world_size()
    band = graph_bands(spec, arrays, np.zeros(0, np.int64), world)[rank]
    cut = band_fixed(spec, {k: torch.as_tensor(a) for k, a in arrays.items()},
                     band)
    bf = {k: t.to(v.device) for k, t in cut.items()}
    ops = GraphBandOps(band, spec, None)
    sl = slice(band.site0, band.site1)
    noise_idx = torch.as_tensor(band.noise_index(spec), device=v.device)
    return (
        ops.matvec(spec, bf, v[..., sl]),
        ops.quad_form(spec, bf, v[..., sl]),
        ops.noise(spec, bf, eps[..., noise_idx]),
        ops.cg_solve(spec, bf, rhs[..., sl], x0[..., sl], omega[..., sl],
                     tau, iters),
    )


def band_ops_inputs(spec, seed=21, chains=2, rows=3):
    """Seeded numpy inputs of :func:`_band_ops_rank`."""
    gen = np.random.default_rng(seed)
    n = spec.n
    return dict(
        v=gen.standard_normal((chains, n)).astype(np.float32),
        eps=gen.standard_normal((chains, tgr.noise_dim(spec))).astype(
            np.float32),
        rhs=gen.standard_normal((chains, rows, n)).astype(np.float32),
        x0=0.1 * gen.standard_normal((chains, rows, n)).astype(np.float32),
        omega=gen.uniform(0.05, 0.3, (chains, n)).astype(np.float32),
        tau=gen.uniform(0.5, 20.0, chains).astype(np.float32),
    )


def run_band_ops(world, spec, arrays, inputs, iters):
    """The band operators of every rank of ``world``, joined over the
    bands: (matvec, quad form, noise, solve), as numpy."""
    args = (spec, arrays, inputs['v'], inputs['eps'], inputs['rhs'],
            inputs['x0'], inputs['omega'], inputs['tau'], iters)
    outs = world.run_each(_band_ops_rank, [args] * world.world)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[1], outs[0][1])
    return (np.concatenate([o[0] for o in outs], axis=-1), outs[0][1],
            np.concatenate([o[2] for o in outs], axis=-1),
            np.concatenate([o[3] for o in outs], axis=-1))


@pytest.fixture(scope='module')
def world2():
    with World(2, ['cpu'] * 2) as w:
        yield w


@pytest.mark.parametrize('block', [128, 0], ids=['banded', 'ell'])
def test_band_operators_match_jax_and_the_field(world2, block):
    """Two ranks' band matvec and quad form against the JAX ``matvec`` and
    ``quad_form`` (1e-5), the band solve against the JAX ``cg_solve``
    (1e-4) and the port's single-device solve (1e-5), all on the gathered
    field; the band noise against the port's whole-field noise on the
    same normals, bit for bit (each site sums its edges in the same
    order)."""
    import jax.numpy as jnp

    from occuspytial_tpu.ops import graph as jgr

    q = DATA[0]
    spec, arrays = field.setup_graph(Q_SPARSE, q.shape[0], 24, block)
    assert spec.block == block and (not block or spec.n_pad == 256)
    jspec, jarr = jgr.build(Q_SPARSE, deflate=24, block=block)
    jfx = {k: jnp.asarray(a) for k, a in jarr.items()}
    inputs = band_ops_inputs(spec)
    iters = 6
    mv, qf, nz, sol = run_band_ops(world2, spec, arrays, inputs, iters)
    v, tau = inputs['v'], inputs['tau']
    want = np.asarray(jgr.matvec(jfx, jnp.asarray(v)))
    np.testing.assert_allclose(mv, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for c in range(v.shape[0]):
        want = float(jgr.quad_form(jfx, jnp.asarray(v[c])))
        assert abs(qf[c] - want) <= 1e-5 * abs(want)
        want = np.asarray(jgr.cg_solve(
            jspec, jfx, jnp.asarray(inputs['rhs'][c]),
            jnp.asarray(inputs['x0'][c]), jnp.asarray(inputs['omega'][c]),
            tau[c], iters))
        np.testing.assert_allclose(sol[c], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    tfx = {k: torch.as_tensor(a) for k, a in arrays.items()}
    want = tgr.noise(spec, tfx, torch.as_tensor(inputs['eps'])).numpy()
    np.testing.assert_array_equal(nz, want)
    single = tgr.cg_solve(
        spec, tfx, *(torch.as_tensor(inputs[k])
                     for k in ('rhs', 'x0', 'omega', 'tau')), iters).numpy()
    np.testing.assert_allclose(sol, single, rtol=0,
                               atol=1e-5 * np.abs(single).max())


@pytest.mark.parametrize('cls', [LogitICARGibbs, ProbitICARGibbs],
                         ids=['logit', 'probit'])
def test_shard_sampler_2d_layout_and_band_draws(cls):
    """Each band: its sites in the original order, its block of the
    permuted layout (the second with the padded tail), its cut arrays,
    its Pólya-Gamma lanes, and its draws the field's words at its sites
    and incident edges."""
    s = _make(cls)
    spec = s.graph
    carry = s.init_carry(4)
    parts = shard_sampler_2d(s, carry, _mesh(2, 2))
    assert len(parts) == 4
    keys = carry.keys[:2]
    full = s._plan(keys, 5)
    # the field noise's normals: logit's own update, probit's after the
    # eta draw's n site normals
    noise_upd, skip = (4, 0) if cls is LogitICARGibbs else (2 + 2, s.n)
    for r, (view, (k, states, _)) in enumerate(parts):
        c, b = divmod(r, 2)
        band = view._band
        assert (band.site0, band.site1) == (80 * b, 80 * (b + 1))
        assert (band.blk0, band.blk1) == (b, b + 1)
        f = view.fixed
        assert view.n == 80 and f['X'].shape == (80, 3)
        assert f['gr_idx'].shape == (80, spec.k_max)
        assert f['gr_defl_vecs'].shape == (80, spec.deflate)
        assert f['gr_bd_diag'].shape == (1, 128, 128)
        assert f['gr_defl_vecs_p'].shape == (128, spec.deflate)
        np.testing.assert_array_equal(
            f['gr_perm'], s.fixed['gr_perm'][128 * b:min(128 * (b + 1),
                                                         160)])
        assert 'gr_esrc' not in f and 'gr_iperm' not in f
        edges = torch.as_tensor(band.edges)
        inc = s.fixed['gr_inc_idx'][80 * b:80 * (b + 1)]
        real = s.fixed['gr_inc_w'][80 * b:80 * (b + 1)] != 0
        assert torch.equal(edges[f['gr_inc_idx']][real], inc[real])
        assert torch.equal(k, carry.keys[2 * c:2 * c + 2])
        assert torch.equal(states['eta'],
                           carry.states['eta'][2 * c:2 * c + 2,
                                               80 * b:80 * (b + 1)])
        v = s.data.visit_site
        visits = np.nonzero((v >= 80 * b) & (v < 80 * (b + 1)))[0]
        np.testing.assert_array_equal(view._pg_lanes.numpy(),
                                      np.r_[np.arange(80 * b, 80 * b + 80),
                                            160 + visits])
        got = view._plan(keys, 5)
        assert torch.equal(got[view._z_update][:, :80],
                           full[view._z_update][:, 80 * b:80 * (b + 1)])
        words = full[noise_upd][:, 2 * skip:].reshape(2, -1, 2)
        tail = got[noise_upd][:, 2 * (80 if skip else 0):]
        assert torch.equal(tail, words[:, edges].reshape(2, -1))


def test_errors():
    """The JAX messages: 4 site ranks cannot split 2 blocks ("block
    count"), 3 cannot split 160 sites; the ELL layout has no blocks."""
    s = _make(LogitICARGibbs)
    with pytest.raises(ValueError, match='must divide the banded layout '
                                         'block count 2'):
        sample_parallel_2d(s, 2, _mesh(1, 4), chains=2)
    with pytest.raises(ValueError, match='must divide the site count 160'):
        sample_parallel_2d(s, 2, _mesh(1, 3), chains=2)
    ell = _make(LogitICARGibbs, graph_block=0)
    parts = shard_sampler_2d(ell, ell.init_carry(2), _mesh(1, 4))
    assert [p[0]._band.site0 for p in parts] == [0, 40, 80, 120]


def test_port_2d_means_match_jax_2d(runs):
    """The slice as a whole: the port's logit 2 x 2 graph run against the
    JAX sample_parallel_2d graph run on a 2 x 2 virtual-device mesh, by
    posterior means."""
    import jax
    from jax.sharding import Mesh

    from occuspytial_tpu import LogitICARGibbs as JaxLogit
    from occuspytial_tpu.parallel import sample_parallel_2d as jax_2d

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                axis_names=('chains', 'sites'))
    jpost = jax_2d(JaxLogit(Q_SPARSE, *DATA[1:], random_state=4,
                            solver='graph'), LONG, mesh, burnin=BURNIN,
                   chains=4)
    _, (_, post), _ = runs(LogitICARGibbs)
    for name, dim in (('alpha', 2), ('beta', 3)):
        for j in range(dim):
            ratio = dg.mean_z_ratio(post[name][:, BURNIN:, j],
                                    jpost[name][:, :, j])
            assert ratio < 1.0, (name, j, ratio)
