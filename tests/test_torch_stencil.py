"""The port's lattice stencil ops against the JAX package's ``ops/stencil``.

Same numpy inputs through both; the setup arrays must be identical, the
operators agree to float32 rounding (1e-5 of the largest entry), the
noise given JAX's own normals to 1e-6 and the solves to 1e-4. Lattices
from 4 x 5 to 16 x 16, rook and queen, rho 1 and below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occuspytial_tpu.ops import stencil as jst
from occuspytial_tpu_torch.ops import stencil as tst
from occuspytial_tpu_torch.ops.icar import lattice_precision

torch.set_num_threads(1)

SPECS = [(4, 5, 4, 1.0), (4, 5, 8, 0.7), (6, 9, 8, 1.0), (16, 16, 8, 1.0),
         (7, 11, 4, 0.5)]


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _pair(spec_args):
    """(JAX spec, port spec, port fixed tensors, JAX fixed arrays)."""
    js, ps = jst.LatticeSpec(*spec_args), tst.LatticeSpec(*spec_args)
    jfixed = {k: jnp.asarray(v) for k, v in jst.setup(js).items()}
    pfixed = {k: torch.as_tensor(v) for k, v in tst.setup(ps).items()}
    return js, ps, jfixed, pfixed


def _jax_noise_normals(js, key):
    """The normals ``jst.noise`` draws from ``key``, flattened in the
    layout the port's ``noise`` reads."""
    dirs = [(0, 1), (1, 0)] + ([(1, 1), (1, -1)] if js.max_neighbors == 8
                               else [])
    keys = jax.random.split(key, len(dirs) + 1)
    parts = [
        jax.random.normal(k, (js.rows - dr, js.cols - abs(dc)), jnp.float32)
        .ravel() for (dr, dc), k in zip(dirs, keys[:-1])
    ]
    if js.rho < 1.0:
        parts.append(jax.random.normal(keys[-1], (js.rows, js.cols),
                                       jnp.float32).ravel())
    return np.concatenate([np.asarray(p) for p in parts])


@pytest.mark.parametrize('spec_args', SPECS)
def test_setup_arrays_identical(spec_args):
    js, ps, _, _ = _pair(spec_args)
    want, got = jst.setup(js), tst.setup(ps)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(tst.degree_grid(ps), jst.degree_grid(js))
    np.testing.assert_array_equal(tst.symbol_grid(ps), jst.symbol_grid(js))
    for m in (ps.rows, ps.cols):
        for a, b in zip(tst.dct_basis(m), jst.dct_basis(m)):
            np.testing.assert_array_equal(a, b)
    assert tst.noise_dim(ps) == _jax_noise_normals(js, jax.random.key(0)).size


def test_lattice_spec_validates():
    with pytest.raises(ValueError, match='one of'):
        tst.LatticeSpec(4, 5, 6)
    assert tst.LatticeSpec(4, 5).n == 20


@pytest.mark.parametrize('spec_args', SPECS)
def test_matvec_and_quad_form_match_jax(spec_args):
    js, ps, jfixed, pfixed = _pair(spec_args)
    v = np.random.default_rng(0).standard_normal((3, 2, ps.n)).astype(
        np.float32)
    want = jst.matvec(js, jfixed['lat_deg'], jnp.asarray(v))
    got = tst.matvec(ps, pfixed, torch.as_tensor(v))
    _close(got, want, 1e-5)
    # and the JAX hot-loop product form
    _close(got, jax.vmap(jax.vmap(
        lambda u: jst.matvec_mxu(js, jfixed, u)))(jnp.asarray(v)), 1e-5)
    dense = lattice_precision(*spec_args).toarray()
    np.testing.assert_allclose(got.double().numpy(),
                               v.astype(np.float64) @ dense, atol=1e-4)
    want_q = jax.vmap(jax.vmap(
        lambda u: jst.quad_form(js, jfixed['lat_deg'], u)))(jnp.asarray(v))
    got_q = tst.quad_form(ps, pfixed, torch.as_tensor(v))
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-5)


@pytest.mark.parametrize('spec_args', SPECS)
def test_noise_matches_jax_given_its_normals(spec_args):
    js, ps, jfixed, pfixed = _pair(spec_args)
    keys = jax.random.split(jax.random.key(7), 3)
    want = np.stack([
        np.asarray(jst.noise(js, jfixed['lat_deg'], k)) for k in keys
    ])
    eps = np.stack([_jax_noise_normals(js, k) for k in keys])
    got = tst.noise(ps, pfixed, torch.as_tensor(eps))
    _close(got, want, 1e-6)


@pytest.mark.parametrize('spec_args', [(4, 5, 4, 1.0), (4, 5, 8, 1.0),
                                       (4, 5, 4, 0.7), (5, 4, 8, 0.7)])
def test_noise_factor_times_its_transpose_is_q(spec_args):
    """Unit vectors through ``noise`` give the columns of B: B B' = Q."""
    _, ps, _, pfixed = _pair(spec_args)
    eye = torch.eye(tst.noise_dim(ps))
    b = tst.noise(ps, pfixed, eye).double().numpy().T  # (n, noise_dim)
    dense = lattice_precision(*spec_args).toarray()
    np.testing.assert_allclose(b @ b.T, dense, atol=1e-6)


@pytest.mark.parametrize('spec_args', SPECS)
def test_precond_apply_matches_jax(spec_args):
    js, ps, jfixed, pfixed = _pair(spec_args)
    v = np.random.default_rng(1).standard_normal((2, ps.n)).astype(
        np.float32)
    want = jst.precond_apply(js, jfixed, 3.7, 0.2, jnp.asarray(v))
    got = tst.precond_apply(ps, pfixed, 3.7, 0.2, torch.as_tensor(v))
    _close(got, want, 1e-5)


def _system(n, chains, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((chains, 2, n)).astype(np.float32),
        (0.1 * rng.standard_normal((chains, 2, n))).astype(np.float32),
        rng.uniform(0.05, 0.3, (chains, n)).astype(np.float32),
        rng.uniform(0.5, 20.0, chains).astype(np.float32),
    )


@pytest.mark.parametrize('spec_args', SPECS)
@pytest.mark.parametrize('iters', [3, 15])
def test_cg_solve_matches_jax(spec_args, iters):
    js, ps, jfixed, pfixed = _pair(spec_args)
    rhs, x0, omega, tau = _system(ps.n, 3, 2)
    want, want_rel = jax.vmap(
        lambda r, x, o, t: jst.cg_solve(js, jfixed, r, x, o, t, iters,
                                        return_resid=True)
    )(jnp.asarray(rhs), jnp.asarray(x0), jnp.asarray(omega),
      jnp.asarray(tau))
    got, rel = tst.cg_solve(ps, pfixed, *map(torch.as_tensor,
                                             (rhs, x0, omega, tau)),
                            iters, return_resid=True)
    _close(got, want, 1e-4)
    np.testing.assert_allclose(rel.numpy(), np.asarray(want_rel),
                               rtol=1e-3, atol=1e-7)
    if iters == 15:
        # and it solves the system
        dense = lattice_precision(*spec_args).toarray()
        for c in range(3):
            lam = tau[c] * dense + np.diag(omega[c].astype(np.float64))
            np.testing.assert_allclose(
                got[c].double().numpy(),
                np.linalg.solve(lam, rhs[c].T.astype(np.float64)).T,
                atol=5e-3 * max(1.0, np.abs(got[c].numpy()).max()))


@pytest.mark.parametrize('spec_args', [(8, 8, 8, 1.0), (6, 9, 4, 0.7)])
def test_constrained_mvnorm_matches_jax_and_sums_to_zero(spec_args):
    js, ps, jfixed, pfixed = _pair(spec_args)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(ps.n).astype(np.float32)
    omega = rng.uniform(0.05, 0.25, ps.n).astype(np.float32)
    warm = np.zeros((2, ps.n), np.float32)
    key = jax.random.key(5)
    eta, warm2, rel = jst.constrained_mvnorm(
        js, jfixed, key, jnp.asarray(b), jnp.asarray(omega),
        jnp.asarray(2.0, jnp.float32), jnp.asarray(warm), 15,
        return_resid=True,
    )
    k1, k2 = jax.random.split(key)
    eps1 = np.asarray(jax.random.normal(k1, (ps.n,), jnp.float32))
    eps = _jax_noise_normals(js, k2)
    got, gwarm, grel = tst.constrained_mvnorm(
        ps, pfixed, _t(b)[None], _t(omega)[None], torch.tensor([2.0]),
        _t(warm)[None], 15, _t(eps1)[None], _t(eps)[None],
        return_resid=True,
    )
    _close(got, np.asarray(eta)[None], 1e-4)
    _close(gwarm, np.asarray(warm2)[None], 1e-4)
    assert abs(float(got.sum())) < 1e-3
    assert float(grel[0]) == pytest.approx(float(rel), rel=1e-2, abs=1e-6)
    # without the residual: the same draw
    got2, _ = tst.constrained_mvnorm(
        ps, pfixed, _t(b)[None], _t(omega)[None], torch.tensor([2.0]),
        _t(warm)[None], 15, _t(eps1)[None], _t(eps)[None],
    )
    assert torch.equal(got2, got)


# (lattice, device, dtype, band) -> whether the solve is the CUDA kernel
_DISPATCH = [
    ((100, 100, 8, 1.0), 'cuda', torch.float32, None, True),
    ((20, 30, 4, 0.7), 'cuda:0', torch.float32, None, True),
    ((1, 100, 8, 1.0), 'cuda', torch.float32, None, True),
    ((100, 100, 8, 1.0), 'cpu', torch.float32, None, False),
    ((100, 100, 8, 1.0), 'cuda', torch.float64, None, False),
    ((100, 100, 8, 1.0), 'cuda', torch.float32, 'band', False),
    ((101, 100, 8, 1.0), 'cuda', torch.float32, None, False),
    ((100, 101, 4, 1.0), 'cuda', torch.float32, None, False),
    ((320, 320, 8, 1.0), 'cuda', torch.float32, None, False),
]


@pytest.mark.parametrize('lattice, device, dtype, band, want', _DISPATCH)
def test_solve_takes_the_kernel_by_device_dtype_band_and_size(
        lattice, device, dtype, band, want):
    """``cg_solve`` launches the stencil PCG kernel for a float32 solve of
    the whole field on a CUDA device whose lattice fits the kernel's
    on-chip budget (100 x 100 at most), and the torch path otherwise: the
    CPU, float64, a band of a 2-D run, larger lattices."""
    spec = tst.LatticeSpec(*lattice)
    band = object() if band else None
    assert tst.takes_kernel(spec, torch.device(device), dtype, band) is want


def test_cpu_solve_stays_in_torch():
    """On the CPU ``cg_solve`` is ``cg_solve_plain`` bit for bit and the
    kernel's wrapper refuses the tensors."""
    from occuspytial_tpu_torch.ops.cuda_stencil import stencil_pcg_cuda

    ps = tst.LatticeSpec(6, 9, 8, 1.0)
    pfixed = {k: torch.as_tensor(v) for k, v in tst.setup(ps).items()}
    args = tuple(map(torch.as_tensor, _system(ps.n, 3, 4)))
    got = tst.cg_solve(ps, pfixed, *args, 5, return_resid=True)
    want = tst.cg_solve_plain(ps, pfixed, *args, 5, return_resid=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='CUDA'):
        stencil_pcg_cuda(ps, pfixed, *args, 5)
