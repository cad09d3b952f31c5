"""The port's site-sharded solves against the JAX ``shard_map`` versions.

The port's per-rank functions run in a gloo world of 4 CPU ranks
(``parallel._spmd.World``: spawned processes, a file rendezvous); the
JAX functions under ``jax.shard_map`` on 4 of the 8 virtual CPU devices
of ``tests/conftest.py``, jitted (an eager ``shard_map`` compiles each
primitive on its own). Both get the same numpy inputs, made from a
seed: the lattice operator of ``tests/test_sharded_stencil.py`` and the
900-site Delaunay graph of ``tests/test_sharded_graph.py`` in 128-site
tiles (8 blocks, 2 a rank). The port's sharded functions are also held
against its own single-device operators, at world sizes 1 and 4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from occuspytial_tpu.ops import stencil as jst
from occuspytial_tpu.parallel import sharded_graph as jsg
from occuspytial_tpu.parallel import sharded_stencil as jss
from occuspytial_tpu_torch.ops import graph as tgr
from occuspytial_tpu_torch.ops.cg import pcg
from occuspytial_tpu_torch.ops import stencil as tst
from occuspytial_tpu_torch.parallel import sharded_graph as tsg
from occuspytial_tpu_torch.parallel import sharded_stencil as tss
from occuspytial_tpu_torch.parallel._spmd import World
from test_graph import delaunay_precision

torch.set_num_threads(1)

SHARDS = 4
ROWS, COLS = 16, 20  # 4-row bands
TAU = np.float32(2.1)


@pytest.fixture(scope='module')
def mesh():
    return Mesh(np.asarray(jax.devices()[:SHARDS]), axis_names=('sites',))


@pytest.fixture(scope='module')
def worlds():
    with World(SHARDS, ['cpu'] * SHARDS) as w4, World(1, ['cpu']) as w1:
        yield {SHARDS: w4, 1: w1}


@pytest.fixture(scope='module')
def built():
    # 900 sites in 128-site tiles: n_pad 1024, nb 8
    q = delaunay_precision(900, seed=9)
    spec, arrs = tgr.build(q, deflate=24, block=128)
    assert spec.n_pad // spec.block == 8
    return q, spec, arrs


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize('neighbors', [4, 8])
def test_stencil_matvec_matches_jax_and_single_device(mesh, worlds,
                                                      neighbors):
    spec = tst.LatticeSpec(ROWS, COLS, neighbors, 1.0)
    deg = tst.degree_grid(spec).astype(np.float32)
    v = np.random.default_rng(0).standard_normal((3, ROWS, COLS)).astype(
        np.float32)
    jspec = jst.LatticeSpec(ROWS, COLS, neighbors, 1.0)
    fn = jax.jit(jax.shard_map(
        jax.vmap(lambda d, vv: jss.matvec_sharded(jspec, d, vv),
                 in_axes=(None, 0)),
        mesh=mesh, in_specs=(P('sites', None), P(None, 'sites', None)),
        out_specs=P(None, 'sites', None),
    ))
    want = np.asarray(fn(jnp.asarray(deg), jnp.asarray(v)))
    single = tst.matvec(spec, {'lat_deg': torch.as_tensor(deg)},
                        torch.as_tensor(v.reshape(3, -1))).numpy()
    for world, w in worlds.items():
        got = w.run(tss.matvec_sharded, (spec, deg, v), (None, 0, -2),
                    out_dim=-2)
        assert _rel(got, want) <= 1e-6, world
        assert _rel(got.reshape(3, -1), single) <= 1e-6, world


def _stencil_cg(mesh, worlds, iters):
    """The Jacobi CG at ``iters`` iterations on the 16 x 20 queen lattice:
    (inputs, the JAX answer, the port's answer at each world size)."""
    spec = tst.LatticeSpec(ROWS, COLS, 8, 1.0)
    deg = tst.degree_grid(spec).astype(np.float32)
    rng = np.random.default_rng(1)
    omega = rng.uniform(0.05, 0.3, spec.n).astype(np.float32)
    rhs = rng.standard_normal((3, spec.n)).astype(np.float32)
    x0 = np.zeros_like(rhs)
    jspec = jst.LatticeSpec(ROWS, COLS, 8, 1.0)
    fn = jax.jit(jax.shard_map(
        lambda d, r_, o: jss.cg_solve_sharded(
            jspec, d, r_, jnp.zeros_like(r_), o,
            jnp.asarray(TAU, jnp.float32), iters),
        mesh=mesh,
        in_specs=(P('sites', None), P(None, 'sites'), P('sites')),
        out_specs=P(None, 'sites'),
    ))
    want = np.asarray(fn(jnp.asarray(deg), jnp.asarray(rhs),
                         jnp.asarray(omega)))
    args = (spec, deg, rhs, x0, omega, TAU, iters)
    dims = (None, 0, -1, -1, 0, None, None)
    got = {w: worlds[w].run(tss.cg_solve_sharded, args, dims)
           for w in worlds}
    return (spec, deg, rhs, omega), want, got


def test_stencil_cg_matches_jax_and_world_one(mesh, worlds):
    (spec, _, rhs, omega), want, got = _stencil_cg(mesh, worlds, 300)
    assert _rel(got[SHARDS], want) <= 1e-4
    assert _rel(got[SHARDS], got[1]) <= 1e-4
    # and the solution solves the system
    q = spec_dense(spec)
    resid = (TAU * q + np.diag(omega)) @ got[SHARDS].T.astype(float) - rhs.T
    assert np.abs(resid).max() <= 1e-3 * np.abs(rhs).max()


@pytest.mark.parametrize('iters', [1, 2, 3])
def test_stencil_cg_cut_short_matches_jax_and_single_device(mesh, worlds,
                                                            iters):
    """A few iterations, far from convergence: the Jacobi diagonal, the
    summed inner products and the beta update decide the iterate here,
    where a converged CG would hide them."""
    (spec, deg, rhs, omega), want, got = _stencil_cg(mesh, worlds, iters)
    # the single-device operator in the port's own PCG, same diagonal
    fixed = {'lat_deg': torch.as_tensor(deg)}
    om = torch.as_tensor(omega)
    jac = 1.0 / (TAU * torch.as_tensor(deg).reshape(-1) + om)
    single = pcg(
        lambda v: TAU * tst.matvec(spec, fixed, v) + om * v,
        lambda r: r * jac,
        torch.as_tensor(rhs), torch.zeros(rhs.shape), iters,
    ).numpy()
    # the iterate has not converged: the depth decides it
    assert _rel(single, _stencil_solve_host(spec, rhs, omega)) > 1e-2
    for world, sol in got.items():
        assert _rel(sol, want) <= 1e-5, world
        assert _rel(sol, single) <= 1e-5, world


def _stencil_solve_host(spec, rhs, omega):
    lam = TAU * spec_dense(spec) + np.diag(omega.astype(float))
    return np.linalg.solve(lam, rhs.T.astype(float)).T


def spec_dense(spec):
    from occuspytial_tpu_torch.ops.icar import lattice_precision

    return lattice_precision(spec.rows, spec.cols,
                             spec.max_neighbors).toarray()


def _panels(arrs):
    return (arrs['gr_bd_diag'], arrs['gr_bd_sub'], arrs['gr_bd_sup'])


def test_graph_matvec_matches_jax_and_single_device(mesh, worlds, built):
    q, spec, arrs = built
    nb, bs = spec.n_pad // spec.block, spec.block
    v = np.random.default_rng(0).standard_normal((2, spec.n_pad)).astype(
        np.float32)
    v[:, spec.n:] = 0.0
    fn = jax.jit(jax.shard_map(
        jsg.banded_matvec_sharded, mesh=mesh,
        in_specs=(P('sites', None, None),) * 3 + (P(None, 'sites', None),),
        out_specs=P(None, 'sites', None),
    ))
    want = np.asarray(fn(*map(jnp.asarray, _panels(arrs)),
                         jnp.asarray(v.reshape(2, nb, bs))))
    fixed = {k: torch.as_tensor(a) for k, a in arrs.items()}
    single = tgr.banded_matvec(spec, fixed, torch.as_tensor(v)).numpy()
    for world, w in worlds.items():
        got = w.run(tsg.banded_matvec_sharded,
                    _panels(arrs) + (v.reshape(2, nb, bs),),
                    (0, 0, 0, -2), out_dim=-2)
        assert _rel(got, want) <= 1e-6, world
        assert _rel(got.reshape(2, -1), single) <= 1e-6, world
    # Q_perm v in the original order is Q v
    out = single[:, :spec.n][:, arrs['gr_iperm']]
    vo = v[:, :spec.n][:, arrs['gr_iperm']].astype(float)
    np.testing.assert_allclose(out, vo @ q.toarray().T, atol=1e-4)


def _graph_cg(mesh, worlds, built, deflate, iters):
    """The graph CG at ``iters`` iterations in the padded block space:
    (inputs, the JAX answer, the port's answer at each world size)."""
    q, spec, arrs = built
    rng = np.random.default_rng(1)
    omega = rng.uniform(0.05, 0.3, spec.n).astype(np.float32)
    tau = np.float32(3.1)
    rhs = rng.standard_normal((2, spec.n)).astype(np.float32)
    perm, pad = arrs['gr_perm'], spec.n_pad - spec.n
    rhs_p = np.pad(rhs[:, perm], ((0, 0), (0, pad))).astype(np.float32)
    omega_p = np.pad(omega[perm], (0, pad),
                     constant_values=1.0).astype(np.float32)
    vecs = arrs['gr_defl_vecs_p'] if deflate else None
    vals = arrs['gr_defl_vals'] if deflate else None

    def jsolve(d, s, u, r_, o, uv=None):
        return jsg.cg_solve_sharded(
            (d, s, u), r_, jnp.zeros_like(r_), o,
            jnp.asarray(tau, jnp.float32), iters, defl_vecs_local=uv,
            defl_vals=None if vals is None else jnp.asarray(vals))

    in_specs = (P('sites', None, None),) * 3 + (P(None, 'sites'),
                                                P('sites'))
    jargs = [jnp.asarray(a) for a in _panels(arrs) + (rhs_p, omega_p)]
    if deflate:
        in_specs += (P('sites', None),)
        jargs.append(jnp.asarray(vecs))
    fn = jax.jit(jax.shard_map(jsolve, mesh=mesh, in_specs=in_specs,
                               out_specs=P(None, 'sites')))
    want = np.asarray(fn(*jargs))

    args = (_panels(arrs), rhs_p, np.zeros_like(rhs_p), omega_p, tau,
            iters, vecs, vals)
    dims = ((0, 0, 0), -1, -1, 0, None, None, 0 if deflate else None,
            None)
    got = {w: worlds[w].run(tsg.cg_solve_sharded, args, dims)
           for w in worlds}
    return (rhs, omega, tau, rhs_p, omega_p), want, got


def _graph_single(spec, arrs, deflate, rhs, omega, tau, iters):
    """The port's single-device ``ops/graph.cg_solve`` in the original
    order."""
    fixed = {k: torch.as_tensor(a) for k, a in arrs.items()}
    ref_spec = dataclasses.replace(spec, deflate=deflate)
    return tgr.cg_solve(
        ref_spec, fixed, torch.as_tensor(rhs)[None],
        torch.zeros((1,) + rhs.shape), torch.as_tensor(omega)[None],
        torch.as_tensor(tau)[None], iters,
    )[0].numpy()


@pytest.mark.parametrize('deflate', [0, 24])
def test_graph_cg_matches_jax_and_single_device(mesh, worlds, built,
                                                deflate):
    q, spec, arrs = built
    (rhs, omega, tau, _, _), want, got = _graph_cg(mesh, worlds, built,
                                                   deflate, 64)
    assert _rel(got[SHARDS], want) <= 1e-4
    # the single-device solve in the original order
    single = _graph_single(spec, arrs, deflate, rhs, omega, tau, 64)
    for world, sol in got.items():
        assert _rel(sol[:, :spec.n][:, arrs['gr_iperm']], single) <= 1e-4


@pytest.mark.parametrize('iters', [1, 2, 3])
@pytest.mark.parametrize('deflate', [0, 24])
def test_graph_cg_cut_short_matches_jax_and_single_device(
    mesh, worlds, built, deflate, iters,
):
    """A few iterations, far from convergence: the Jacobi diagonal, the
    deflated preconditioner (its cbar, its inverse eigenvalues and the
    sums of its thin products) and the beta update decide the iterate."""
    q, spec, arrs = built
    (rhs, omega, tau, rhs_p, omega_p), want, got = _graph_cg(
        mesh, worlds, built, deflate, iters)
    if deflate:
        # ops/graph.cg_solve takes cbar over the real sites and the
        # sharded solve over the padded lanes (omega 1 there), as the JAX
        # pair does; so the single-device reference is the port's PCG on
        # its banded matvec and deflated-Jacobi apply with the padded cbar
        fixed = {k: torch.as_tensor(a) for k, a in arrs.items()}
        om = torch.as_tensor(omega_p)
        jac = 1.0 / (tau * fixed['gr_deg_p'] + om)
        single = pcg(
            lambda v: tau * tgr.banded_matvec(spec, fixed, v) + om * v,
            lambda r: tgr._deflated_jacobi(
                jac, fixed['gr_defl_vecs_p'], fixed['gr_defl_vals'], tau,
                torch.mean(om), r),
            torch.as_tensor(rhs_p), torch.zeros(rhs_p.shape), iters,
        ).numpy()
    else:
        single = _graph_single(spec, arrs, 0, rhs, omega, tau, iters)
        single = np.pad(single[:, arrs['gr_perm']],
                        ((0, 0), (0, spec.n_pad - spec.n)))
    converged = _graph_single(spec, arrs, deflate, rhs, omega, tau, 200)
    assert _rel(single[:, :spec.n][:, arrs['gr_iperm']], converged) > 1e-2
    for world, sol in got.items():
        assert _rel(sol, want) <= 1e-5, world
        assert _rel(sol, single) <= 1e-5, world


def test_extents_must_divide(built):
    with pytest.raises(ValueError, match='must divide'):
        tss.check_extent(tst.LatticeSpec(ROWS, COLS, 8), 3)
    tss.check_extent(tst.LatticeSpec(ROWS, COLS, 8), SHARDS)
    _, spec, _ = built
    with pytest.raises(ValueError, match='block count'):
        tsg.check_extent(spec, 3)
    tsg.check_extent(spec, SHARDS)


def test_split_must_divide(worlds):
    deg = np.ones((ROWS, COLS), np.float32)
    with pytest.raises(ValueError, match='must divide'):
        worlds[SHARDS].run(tss.matvec_sharded,
                           (tst.LatticeSpec(ROWS, COLS), deg[:6], deg[:6]),
                           (None, 0, 0))


def test_world_defaults_to_the_card(monkeypatch):
    # no devices named: every rank on the card, raising without CUDA
    # before any rank starts
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        World(2)
