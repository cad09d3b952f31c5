"""The port's arbitrary-graph ops against the JAX package's ``ops/graph``.

Same numpy inputs through both, on lattices and on an irregular
Delaunay adjacency (its own copy of the helper in tests/test_graph.py):
``build`` gives identical arrays (n <= 512, where the deflation basis
comes from a dense ``eigh``), the operators agree to float32 rounding
(1e-5 of the largest entry), the noise given JAX's own normals to 1e-6,
the solves in the ELL and banded layouts to 1e-4. Above 512 sites the
basis comes from Lanczos with a random start: the test there compares the
spanned subspaces, and injects the JAX basis through ``fixed_from_jax``
to compare a solve.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from occuspytial_tpu.ops import graph as jgr
from occuspytial_tpu_torch.convert import fixed_from_jax
from occuspytial_tpu_torch.models import field
from occuspytial_tpu_torch.ops import graph as tgr
from occuspytial_tpu_torch.ops.icar import lattice_precision

torch.set_num_threads(1)


def delaunay_precision(n_sites, seed=0, rho=1.0):
    """ICAR/CAR precision on an irregular planar adjacency."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    tri = Delaunay(rng.uniform(0, 1, (n_sites, 2)))
    rows, cols = [], []
    for simplex in tri.simplices:
        for a in range(3):
            i, j = simplex[a], simplex[(a + 1) % 3]
            rows += [i, j]
            cols += [j, i]
    adj = sps.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n_sites, n_sites)
    ).tocsr()
    adj = sps.csr_matrix((adj > 0).astype(float))
    deg = np.asarray(adj.sum(axis=1)).ravel()
    return (sps.diags(deg) - rho * adj).tocsr()


# (name, Q, deflate, block)
CASES = {
    'rook': (lambda: lattice_precision(6, 9, 4), 8, 'auto'),
    'queen_car': (lambda: lattice_precision(6, 9, 8, 0.6), 8, 'auto'),
    'delaunay': (lambda: delaunay_precision(80), 8, 'auto'),
    'delaunay_car': (lambda: delaunay_precision(80, rho=0.7), 0, 'auto'),
    'banded_lattice': (lambda: lattice_precision(20, 20, 8), 16, 'auto'),
    'banded_delaunay': (lambda: delaunay_precision(400, seed=4), 16, 256),
    'banded_plain': (lambda: delaunay_precision(300, seed=6), 0, 128),
}


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@functools.lru_cache(maxsize=None)
def _built(case):
    """(case, Q, JAX spec, JAX fixed, port spec, port fixed), built once
    per case."""
    make_q, deflate, block = CASES[case]
    q = make_q()
    jspec, jarr = jgr.build(q, deflate=deflate, block=block)
    pspec, parr = field.setup_graph(q, q.shape[0], deflate, block)
    jfixed = {k: jnp.asarray(v) for k, v in jarr.items()}
    pfixed = {k: torch.as_tensor(v) for k, v in parr.items()}
    return case, q, jspec, jfixed, pspec, pfixed


@pytest.fixture(params=sorted(CASES))
def built(request):
    return _built(request.param)


def _jax_noise_normals(spec, key):
    k_e, k_d = jax.random.split(key)
    parts = [np.asarray(jax.random.normal(k_e, (spec.n_edges,),
                                          jnp.float32))]
    if spec.has_surplus:
        parts.append(np.asarray(jax.random.normal(k_d, (spec.n,),
                                                  jnp.float32)))
    return np.concatenate(parts)


def test_build_arrays_identical(built):
    case, q, jspec, jfixed, _, _ = built
    _, deflate, block = CASES[case]
    pspec, parr = tgr.build(q, deflate=deflate, block=block)
    _, jarr = jgr.build(q, deflate=deflate, block=block)
    assert _spec_fields(pspec) == _spec_fields(jspec)
    assert set(parr) - set(jarr) == {'gr_inc_idx', 'gr_inc_w'}
    for name, want in jarr.items():
        assert parr[name].dtype == want.dtype, name
        np.testing.assert_array_equal(parr[name], want, err_msg=name)
    assert tgr.noise_dim(pspec) == _jax_noise_normals(
        jspec, jax.random.key(0)).size
    if case.startswith('banded'):
        assert pspec.block > 0 and pspec.n_pad % pspec.block == 0
    else:
        assert pspec.block == 0


def _spec_fields(s):
    return (s.n, s.k_max, s.n_edges, s.has_surplus, s.deflate, s.block,
            s.n_pad)


def test_build_rejects_what_jax_rejects():
    bad = [
        (np.array([[2.0, 1.0], [1.0, 2.0]]), 'off-diagonal'),
        (np.array([[0.5, -1.0], [-1.0, 0.5]]), 'exceeds'),
        (np.array([[2.0, -1.0, 0.0], [0.0, 2.0, -1.0], [0.0, 0.0, 2.0]]),
         'symmetric'),
        (np.ones((2, 3)), 'square'),
    ]
    for q, match in bad:
        with pytest.raises(ValueError, match=match) as want:
            jgr.build(q)
        with pytest.raises(ValueError, match=match) as got:
            tgr.build(q)
        assert str(got.value) == str(want.value)
    q = lattice_precision(50, 50, 8)
    for block, match in ((100, 'multiple of 128'), (128, None)):
        if match is None:
            tgr.build(q, deflate=0, block=block)
            continue
        with pytest.raises(ValueError, match=match):
            tgr.build(q, deflate=0, block=block)
    with pytest.raises(ValueError, match='covering the'):
        tgr.build(lattice_precision(200, 200, 8), deflate=0, block=128)
    with pytest.raises(ValueError, match='sites'):
        field.setup_graph(q, 99, 0, 'auto')


def test_matvec_and_quad_form_match_jax(built):
    _, q, jspec, jfixed, pspec, pfixed = built
    v = np.random.default_rng(0).standard_normal((3, 2, pspec.n)).astype(
        np.float32)
    want = jgr.matvec(jfixed, jnp.asarray(v))
    got = tgr.matvec(pspec, pfixed, torch.as_tensor(v))
    _close(got, want, 1e-5)
    np.testing.assert_allclose(got.double().numpy(),
                               v.astype(np.float64) @ q.toarray(), atol=1e-4)
    want_q = jax.vmap(jax.vmap(lambda u: jgr.quad_form(jfixed, u)))(
        jnp.asarray(v))
    got_q = tgr.quad_form(pspec, pfixed, torch.as_tensor(v))
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-5)


@pytest.mark.parametrize('case', [c for c in sorted(CASES)
                                  if c.startswith('banded')])
def test_banded_matvec_matches_jax(case):
    _, _, jspec, jfixed, pspec, pfixed = _built(case)
    v = np.random.default_rng(3).standard_normal((2, 3, pspec.n_pad))
    v[..., pspec.n:] = 0.0
    v = v.astype(np.float32)
    want = jgr.banded_matvec(jspec, jfixed, jnp.asarray(v))
    got = tgr.banded_matvec(pspec, pfixed, torch.as_tensor(v))
    _close(got, want, 1e-5)
    assert float(got[..., pspec.n:].abs().max()) == 0.0


def test_precond_apply_matches_jax(built):
    _, _, jspec, jfixed, pspec, pfixed = built
    rng = np.random.default_rng(4)
    r = rng.standard_normal((2, pspec.n)).astype(np.float32)
    omega = rng.uniform(0.05, 0.3, pspec.n).astype(np.float32)
    want = jgr.precond_apply(jspec, jfixed, 3.7, jnp.asarray(omega),
                             jnp.asarray(r))
    got = tgr.precond_apply(pspec, pfixed, 3.7, torch.as_tensor(omega),
                            torch.as_tensor(r))
    _close(got, want, 1e-5)


def test_noise_matches_jax_given_its_normals(built):
    _, _, jspec, jfixed, pspec, pfixed = built
    keys = jax.random.split(jax.random.key(9), 3)
    want = np.stack([np.asarray(jgr.noise(jspec, jfixed, k)) for k in keys])
    eps = np.stack([_jax_noise_normals(jspec, k) for k in keys])
    got = tgr.noise(pspec, pfixed, torch.as_tensor(eps))
    _close(got, want, 1e-6)


@pytest.mark.parametrize('rho', [1.0, 0.7])
@pytest.mark.parametrize('make_q', [
    lambda rho: lattice_precision(5, 4, 8, rho),
    lambda rho: lattice_precision(4, 5, 4, rho),
    lambda rho: delaunay_precision(20, seed=3, rho=rho),
])
def test_noise_factor_times_its_transpose_is_q(make_q, rho):
    """Unit vectors through ``noise`` give the columns of B: B B' = Q."""
    q = make_q(rho)
    spec, arr = tgr.build(q, deflate=0)
    assert spec.has_surplus == (rho < 1.0)
    fixed = {k: torch.as_tensor(v) for k, v in arr.items()}
    b = tgr.noise(spec, fixed, torch.eye(tgr.noise_dim(spec))).double()
    b = b.numpy().T
    np.testing.assert_allclose(b @ b.T, q.toarray(), atol=1e-6)


def _system(n, chains, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((chains, 2, n)).astype(np.float32),
        (0.1 * rng.standard_normal((chains, 2, n))).astype(np.float32),
        rng.uniform(0.05, 0.3, (chains, n)).astype(np.float32),
        rng.uniform(0.5, 20.0, chains).astype(np.float32),
    )


def _jax_cg(jspec, jfixed, rhs, x0, omega, tau, iters):
    return jax.vmap(
        lambda r, x, o, t: jgr.cg_solve(jspec, jfixed, r, x, o, t, iters,
                                        return_resid=True)
    )(*map(jnp.asarray, (rhs, x0, omega, tau)))


@pytest.mark.parametrize('iters', [4, 30])
def test_cg_solve_matches_jax(built, iters):
    _, q, jspec, jfixed, pspec, pfixed = built
    rhs, x0, omega, tau = _system(pspec.n, 3, 5)
    want, want_rel = _jax_cg(jspec, jfixed, rhs, x0, omega, tau, iters)
    got, rel = tgr.cg_solve(pspec, pfixed, *map(torch.as_tensor,
                                                (rhs, x0, omega, tau)),
                            iters, return_resid=True)
    _close(got, want, 1e-4)
    np.testing.assert_allclose(rel.numpy(), np.asarray(want_rel),
                               rtol=1e-2, atol=1e-6)
    no_rel = tgr.cg_solve(pspec, pfixed, *map(torch.as_tensor,
                                              (rhs, x0, omega, tau)), iters)
    assert torch.equal(no_rel, got)


def test_constrained_mvnorm_matches_jax_and_sums_to_zero(built):
    _, _, jspec, jfixed, pspec, pfixed = built
    rng = np.random.default_rng(2)
    b = rng.standard_normal(pspec.n).astype(np.float32)
    omega = rng.uniform(0.05, 0.25, pspec.n).astype(np.float32)
    warm = np.zeros((2, pspec.n), np.float32)
    key = jax.random.key(3)
    eta, warm2 = jgr.constrained_mvnorm(
        jspec, jfixed, key, jnp.asarray(b), jnp.asarray(omega),
        jnp.asarray(2.0, jnp.float32), jnp.asarray(warm), 30,
    )
    k1, k2 = jax.random.split(key)
    eps1 = np.asarray(jax.random.normal(k1, (pspec.n,), jnp.float32))
    eps = _jax_noise_normals(jspec, k2)
    got, gwarm = tgr.constrained_mvnorm(
        pspec, pfixed, *(torch.tensor(a)[None] for a in (b, omega)),
        torch.tensor([2.0]), torch.tensor(warm)[None], 30,
        torch.tensor(eps1)[None], torch.tensor(eps)[None],
    )
    _close(got, np.asarray(eta)[None], 1e-4)
    _close(gwarm, np.asarray(warm2)[None], 1e-4)
    assert abs(float(got.sum())) < 1e-3


def test_lanczos_basis_spans_the_jax_subspace_and_injects():
    """At n > 512 ``_bottom_eigs`` runs shift-invert Lanczos from a random
    start: the port's and the JAX package's bases must span the same
    subspace (projector difference), and with the JAX basis handed over
    by ``fixed_from_jax`` the port's banded deflated solve gives JAX's."""
    q = delaunay_precision(600, seed=7)
    m = 16
    vals_p, vecs_p = tgr._bottom_eigs(q, m)
    vals_j, vecs_j = jgr._bottom_eigs(q, m)
    np.testing.assert_allclose(vals_p, vals_j, rtol=1e-6, atol=1e-9)
    proj = vecs_p @ vecs_p.T - vecs_j @ vecs_j.T
    assert np.linalg.norm(proj, 2) < 1e-6
    # the port's Lanczos start is fixed: every build gives the same basis
    np.testing.assert_array_equal(tgr._bottom_eigs(q, m)[1], vecs_p)

    jspec, jarr = jgr.build(q, deflate=m)
    pspec, parr = field.setup_graph(q, q.shape[0], m, 'auto')
    assert pspec.block > 0 and pspec.deflate == m
    pfixed = {k: torch.as_tensor(v) for k, v in parr.items()}
    pfixed.update(fixed_from_jax(
        {k: v for k, v in jarr.items() if k.startswith('gr_')},
        device='cpu',
    ))
    assert pfixed['gr_perm'].dtype == torch.int64
    assert pfixed['gr_defl_vecs'].dtype == torch.float32
    jfixed = {k: jnp.asarray(v) for k, v in jarr.items()}
    rhs, x0, omega, tau = _system(pspec.n, 2, 8)
    want, _ = _jax_cg(jspec, jfixed, rhs, x0, omega, tau, 6)
    got = tgr.cg_solve(pspec, pfixed, *map(torch.as_tensor,
                                           (rhs, x0, omega, tau)), 6)
    _close(got, want, 1e-4)
