"""The port's CUDA kernels and main path on the card (marked ``cuda``).

Each kernel is held against its plain torch version on the same CUDA
tensors. Every test skips without a card, so on a CPU-only machine this
file counts no passes. The file imports no JAX (the card machine has
none); run it there with

    python -m pytest tests/test_torch_cuda.py -q -o addopts='' \
        --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from chip_smoke import make_lattice_dataset
from occuspytial_tpu_torch import (
    LogitICARGibbs,
    LogitRSRGibbs,
    ProbitICARGibbs,
    ProbitRSRGibbs,
    rng,
)
from occuspytial_tpu_torch.ops import cg as tcg
from occuspytial_tpu_torch.ops import polyagamma as tpg
from occuspytial_tpu_torch.ops.cuda_cg import icar_cg_solve_cuda
from occuspytial_tpu_torch.ops.cuda_pg import pg_devroye_cuda
from occuspytial_tpu_torch.ops.icar import icar_spectral, lattice_precision
from occuspytial_tpu_torch.utils import make_data

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card; the CPU run holds the plain version')
    return torch.device('cuda')


def test_pg_kernel_matches_plain(dev):
    sub = rng.words(rng.chain_keys(4, 8, rng.RUN, dev), 0, 0, 2)
    z = torch.linspace(-20.0, 20.0, 4034, device=dev).expand(8, 4034)
    z = z.contiguous()
    before = pg_devroye_cuda.launches
    got = pg_devroye_cuda(sub, z)
    torch.cuda.synchronize()
    assert pg_devroye_cuda.launches == before + 1
    want = tpg.pg_devroye(sub, z)
    rel = ((got - want).abs() / want.abs()).cpu().numpy()
    # transcendental functions may round differently in the kernel and in
    # torch's CUDA ops, which can move a lane across an accept boundary
    assert (rel <= 1e-5).mean() >= 0.999
    with pytest.raises(TypeError):
        pg_devroye_cuda(sub, z.double())


@pytest.mark.parametrize('m', [1, 31, 128, 1000, 4034])
def test_pg_fused_entry_takes_z_and_strided_keys(dev, m):
    """The kernel computes its mixture inputs from z and reads the key
    words through their row stride (on the sampler's path they are a
    slice of the step's words): one launch, the plain sampler's draws,
    at lane counts on and off the 128-lane chunks."""
    words = rng.words(rng.chain_keys(9, 5, rng.RUN, dev), 2, 0, 6)
    sub = words[:, 2:4]
    assert not sub.is_contiguous()
    gen = torch.Generator(device=dev).manual_seed(m)
    z = 6.0 * torch.randn((5, m), device=dev, generator=gen)
    z[0, 0] = 0.0
    z[-1, -1] = 80.0
    before = pg_devroye_cuda.launches
    got = pg_devroye_cuda(sub, z)
    torch.cuda.synchronize()
    assert pg_devroye_cuda.launches == before + 1
    want = tpg.pg_devroye(sub.contiguous(), z)
    assert bool(torch.isfinite(got).all()) and bool((got > 0).all())
    rel = ((got - want).abs() / want.abs()).cpu().numpy()
    # the mass that picks a lane's branch comes from other library
    # functions in the kernel (erfcx) than in torch (log_ndtr): at most
    # one lane in 1000 may take another branch
    assert (rel <= 1e-5).mean() >= 0.999
    with pytest.raises(ValueError):
        pg_devroye_cuda(sub.to(torch.int32), z)


def _cg_system(dev, n, seed=0):
    """U, S of a lattice ICAR precision (n = 200) or, for any other n, a
    random orthogonal U with eigenvalues in [0, 8], one of them 0."""
    if n == 200:
        q = lattice_precision(10, 20).toarray().astype(np.float64)
        s, u, _ = icar_spectral(q)
        return (torch.as_tensor(u, dtype=torch.float32, device=dev),
                torch.as_tensor(s, dtype=torch.float32, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.linalg.qr(torch.randn((n, n), device=dev, generator=gen))[0]
    s = 8.0 * torch.rand(n, device=dev, generator=gen)
    s[0] = 0.0
    return u.contiguous(), s


def _cg_args(dev, chains, rows, n, seed=0):
    u, s = _cg_system(dev, n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [
        torch.randn((chains, rows, n), device=dev, generator=gen),
        0.1 * torch.randn((chains, rows, n), device=dev, generator=gen),
        0.05 + 0.25 * torch.rand((chains, n), device=dev, generator=gen),
        0.5 + torch.rand(chains, device=dev, generator=gen),
        u, s, 8,
    ]


@pytest.mark.parametrize('n', [200, 333])
@pytest.mark.parametrize('rows', [2, 6, 8])
@pytest.mark.parametrize('chains', [1, 3, 64, 200])
def test_cg_kernel_shapes_off_the_tile_grid(dev, chains, rows, n):
    """Chain and row counts on and off the 48-row tiles, n off the
    64-column tiles (200) and not a multiple of 4 (333, staged by 4-byte
    copies): the kernel agrees with the plain solve as at the main
    shape, converged and, cut short after 1 and 2 iterations from a zero
    start, on residuals that are far from rounding (above 1e-4, where a
    converged one reads 1e-7) and are held to 1e-3 of themselves."""
    args = _cg_args(dev, chains, rows, n)
    got = icar_cg_solve_cuda(*args, return_resid=True)
    want = tcg.icar_cg_solve_spectral(*args, return_resid=True)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert float(((got[2] - want[2]).abs()
                  / (want[2].abs() + 1e-3)).max()) <= 1e-3
    args[1] = torch.zeros_like(args[1])
    for iters in (1, 2):
        args[6] = iters
        got = icar_cg_solve_cuda(*args, return_resid=True)
        want = tcg.icar_cg_solve_spectral(*args, return_resid=True)
        for g, w in zip(got[:2], want[:2]):
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
        assert float(want[2].min()) >= 1e-4
        assert float(((got[2] - want[2]).abs() / want[2]).max()) <= 1e-3


@pytest.mark.parametrize('iters', [0, 1, 3])
def test_cg_kernel_iteration_counts(dev, iters):
    """No iteration (the warm start's own residual), one and a few."""
    args = _cg_args(dev, 5, 6, 200)
    args[6] = iters
    got = icar_cg_solve_cuda(*args, return_resid=True)
    want = tcg.icar_cg_solve_spectral(*args, return_resid=True)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_cg_kernel_takes_tensors_off_16_byte_alignment(dev):
    """Views that start 4 bytes into their storage are staged by 4-byte
    copies, with the same bits as the aligned 16-byte path."""
    args = _cg_args(dev, 5, 6, 200)
    want = icar_cg_solve_cuda(*args, return_resid=True)
    shifted = []
    for a in args[:2]:
        buf = torch.empty(a.numel() + 1, device=dev)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        shifted.append(view)
    got = icar_cg_solve_cuda(*shifted, *args[2:], return_resid=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('n', [200, 333])
def test_cg_kernel_is_bit_reproducible(dev, n):
    args = _cg_args(dev, 64, 6, n)
    a = icar_cg_solve_cuda(*args, return_resid=True)
    b = icar_cg_solve_cuda(*args, return_resid=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize('n', [200, 333])
@pytest.mark.parametrize('rows', [2, 6, 8])
def test_cg_kernel_chain_independence(dev, rows, n):
    """Chain c's three outputs are bit for bit the same alone, among
    other chains whose inputs differ, and at another chain count: rows of
    several chains share a tile, but every sum is taken in an order that
    depends on n alone."""
    args = _cg_args(dev, 64, rows, n)
    full = icar_cg_solve_cuda(*args, return_resid=True)
    keep = slice(5, 8)
    few = icar_cg_solve_cuda(*(a[keep] for a in args[:4]), *args[4:],
                             return_resid=True)
    gen = torch.Generator(device=dev).manual_seed(9)
    mixed_args = []
    for a in args[:4]:
        fresh = 0.05 + torch.rand(a.shape, device=dev, generator=gen)
        fresh[keep] = a[keep]
        mixed_args.append(fresh)
    mixed = icar_cg_solve_cuda(*mixed_args, *args[4:], return_resid=True)
    for f, w, x in zip(full, few, mixed):
        assert torch.equal(f[keep], w)
        assert torch.equal(f[keep], x[keep])
    assert not torch.equal(full[0][:5], mixed[0][:5])


def test_cg_kernel_wrapper_raises_on_what_it_does_not_take(dev):
    u, s = _cg_system(dev, 200)
    ok = _cg_args(dev, 2, 6, 200)
    # more elements than the kernel's 32-bit indices reach; expanded
    # views, so nothing of that size is allocated
    huge = torch.zeros(1, device=dev).expand(2 ** 15, 8, 2 ** 13)
    with pytest.raises(ValueError, match='elements'):
        icar_cg_solve_cuda(huge, huge, huge[:, 0], torch.ones(2 ** 15),
                           u, s, 8)
    with pytest.raises(TypeError):
        icar_cg_solve_cuda(ok[0].double(), *ok[1:])
    with pytest.raises(ValueError):
        icar_cg_solve_cuda(ok[0], ok[1][:, :5], *ok[2:])
    with pytest.raises(ValueError):
        icar_cg_solve_cuda(*ok[:4], u[:100, :100], s[:100], 8)


@pytest.mark.parametrize('tau', [1.0, 1e4])
def test_cg_kernel_matches_plain(dev, tau):
    q = lattice_precision(10, 20).toarray().astype(np.float64)
    s, u, _ = icar_spectral(q)
    gen = torch.Generator(device=dev).manual_seed(0)
    chains, rows, n = 4, 6, q.shape[0]
    args = (
        torch.randn((chains, rows, n), device=dev, generator=gen),
        0.1 * torch.randn((chains, rows, n), device=dev, generator=gen),
        0.05 + 0.25 * torch.rand((chains, n), device=dev, generator=gen),
        torch.full((chains,), tau, device=dev),
        torch.as_tensor(u, dtype=torch.float32, device=dev),
        torch.as_tensor(s, dtype=torch.float32, device=dev),
        8,
    )
    before = icar_cg_solve_cuda.launches
    got = icar_cg_solve_cuda(*args, return_resid=True)
    torch.cuda.synchronize()
    assert icar_cg_solve_cuda.launches == before + 1
    want = tcg.icar_cg_solve_spectral(*args, return_resid=True)
    # float32 sums in another order: 1e-4 of the largest entry; relative
    # residuals below 1e-6 are rounding and compare absolutely (the
    # starved solves below compare them relatively)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert float(((got[2] - want[2]).abs()
                  / (want[2].abs() + 1e-3)).max()) <= 1e-3


@pytest.mark.parametrize('tau, iters', [(1.0, 1), (1.0, 2), (1e4, 1)])
def test_cg_kernel_starved_residual_matches_plain(dev, tau, iters):
    """From a zero start, one or two iterations leave relative residuals
    of 1e-3 to 1e-1: the kernel's agree with the plain solve's to 1e-3 of
    themselves, with no absolute floor."""
    q = lattice_precision(10, 20).toarray().astype(np.float64)
    s, u, _ = icar_spectral(q)
    gen = torch.Generator(device=dev).manual_seed(1)
    chains, rows, n = 4, 6, q.shape[0]
    args = (
        torch.randn((chains, rows, n), device=dev, generator=gen),
        torch.zeros((chains, rows, n), device=dev),
        0.05 + 0.25 * torch.rand((chains, n), device=dev, generator=gen),
        torch.full((chains,), tau, device=dev),
        torch.as_tensor(u, dtype=torch.float32, device=dev),
        torch.as_tensor(s, dtype=torch.float32, device=dev),
        iters,
    )
    got = icar_cg_solve_cuda(*args, return_resid=True)
    want = tcg.icar_cg_solve_spectral(*args, return_resid=True)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert float(want[2].min()) >= 1e-3
    assert bool(((got[2] - want[2]).abs() <= 1e-3 * want[2]).all())


def test_main_path_runs_and_is_reproducible(dev):
    Q, W, X, y, *_ = make_data(n=150, ns=100, p=3, q=2, random_state=10)
    draws = []
    for _ in range(2):
        s = LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                           cg_iters=15)
        assert s.pg_method == 'pallas_packed'
        before = pg_devroye_cuda.launches
        post = s.sample(20, chains=4, progressbar=False)
        assert pg_devroye_cuda.launches == before + 21  # + cold check
        draws.append(post)
    for name in ('alpha', 'beta', 'tau'):
        assert np.isfinite(draws[0][name]).all()
        # deterministic segment sums: one seed gives one run on the card
        np.testing.assert_array_equal(draws[0][name], draws[1][name])
    with pytest.raises(TypeError):
        LogitICARGibbs(Q, W, X, y, dtype='float64', solver='cg').sample(
            2, progressbar=False)


def _run_twice(make, size, chains):
    draws = []
    for _ in range(2):
        draws.append(make().sample(size, chains=chains, progressbar=False))
    for name in ('alpha', 'beta', 'tau'):
        assert np.isfinite(draws[0][name]).all()
        np.testing.assert_array_equal(draws[0][name], draws[1][name])
    return draws[0]


def test_logit_rsr_launches_the_pg_kernel_once_per_step(dev):
    """RSR draws both PG fields in one launch a step and runs no
    cold-start solver check (no '+1'); one seed gives one run."""
    Q, W, X, y, *_ = make_data(n=150, ns=100, p=3, q=2, random_state=10)

    def make():
        s = LogitRSRGibbs(Q, W, X, y, random_state=4, q=15, solver='cg')
        assert s.pg_method == 'pallas_packed' and not s._solves_lambda
        return s

    before = pg_devroye_cuda.launches
    post = _run_twice(make, 20, 4)
    assert pg_devroye_cuda.launches == before + 2 * 20
    assert post['beta'].shape == (4, 20, 3)


@pytest.mark.parametrize('cls', ['icar', 'rsr'])
@pytest.mark.parametrize('collapsed', [True, False])
def test_probit_samplers_run_and_are_reproducible(dev, cls, collapsed):
    """The probit paths launch no hand-written kernel: their draws come
    from torch ops alone, bit for bit the same twice."""
    Q, W, X, y, *_ = make_lattice_dataset(10, 10, ns=50, seed=3)
    sampler = {'icar': ProbitICARGibbs, 'rsr': ProbitRSRGibbs}[cls]
    before = (pg_devroye_cuda.launches, icar_cg_solve_cuda.launches)
    _run_twice(lambda: sampler(Q, W, X, y, random_state=4,
                               collapsed=collapsed), 10, 8)
    assert (pg_devroye_cuda.launches, icar_cg_solve_cuda.launches) == before


# ---------------------- the large-n eta regimes ------------------------ #

def _large_n_ops():
    """(module, spec, CPU fixed tensors) for a queen lattice with rho < 1
    (stencil), and the banded and ELL layouts of a CAR graph on it."""
    from occuspytial_tpu_torch.models import etasetup
    from occuspytial_tpu_torch.ops import graph as tgr
    from occuspytial_tpu_torch.ops import stencil as tst

    out = []
    lat = tst.LatticeSpec(20, 30, 8, 0.8)
    out.append((tst, lat, {k: torch.as_tensor(v)
                           for k, v in tst.setup(lat).items()}))
    q = lattice_precision(20, 30, 8, 0.9)
    for block in ('auto', 0):
        spec, arrays = etasetup.setup_graph(q, 600, 32, block)
        out.append((tgr, spec, {k: torch.as_tensor(v)
                                for k, v in arrays.items()}))
    assert out[1][1].block == 128 and out[2][1].block == 0
    return out


def test_large_n_ops_match_their_cpu_results(dev):
    """Every op of the stencil and graph regimes on the card against the
    same op on the CPU: float32 sums in other orders, 1e-5 of the largest
    entry for the operators, 1e-4 for the solves."""
    from occuspytial_tpu_torch.ops import graph as tgr

    gen = np.random.default_rng(0)
    for mod, spec, fixed in _large_n_ops():
        gfixed = {k: v.to(dev) for k, v in fixed.items()}
        n = spec.n
        v = torch.tensor(gen.standard_normal((4, 3, n)), dtype=torch.float32)
        eps = torch.tensor(gen.standard_normal((4, mod.noise_dim(spec))),
                           dtype=torch.float32)
        omega = torch.tensor(gen.uniform(0.05, 0.3, (4, n)),
                             dtype=torch.float32)
        tau = torch.tensor(gen.uniform(0.5, 30.0, 4), dtype=torch.float32)
        cases = [
            (lambda f, a: mod.matvec(spec, f, a[0]), 1e-5),
            (lambda f, a: mod.quad_form(spec, f, a[0]), 1e-5),
            (lambda f, a: mod.noise(spec, f, a[1]), 1e-5),
            (lambda f, a: mod.cg_solve(spec, f, a[0], 0.1 * a[0], a[2],
                                       a[3], 12, return_resid=True)[0],
             1e-4),
        ]
        if mod is tgr:
            cases.append((lambda f, a: tgr.precond_apply(
                spec, f, a[3][:, None, None], a[2][:, None], a[0]), 1e-5))
            if spec.block:
                vp = torch.nn.functional.pad(v, (0, spec.n_pad - n))
                cases.append((lambda f, a: tgr.banded_matvec(
                    spec, f, vp.to(a[0].device)), 1e-5))
        else:
            cases.append((lambda f, a: mod.precond_apply(
                spec, f, 3.0, 0.2, a[0]), 1e-5))
        args = (v, eps, omega, tau)
        gargs = tuple(a.to(dev) for a in args)
        for fn, tol in cases:
            want = fn(fixed, args)
            got = fn(gfixed, gargs).cpu()
            scale = max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= tol * scale


def test_large_n_noise_is_bit_reproducible(dev):
    """The graph noise sums each site's incident edges in a fixed order (no
    atomics): two launches give the same bits; so does the stencil's."""
    for mod, spec, fixed in _large_n_ops():
        gfixed = {k: v.to(dev) for k, v in fixed.items()}
        gen = torch.Generator(device=dev).manual_seed(1)
        eps = torch.randn((64, mod.noise_dim(spec)), device=dev,
                          generator=gen)
        a = mod.noise(spec, gfixed, eps)
        b = mod.noise(spec, gfixed, eps)
        assert torch.equal(a, b)


@pytest.mark.parametrize('regime', ['stencil', 'graph'])
def test_large_n_logit_launches_the_pg_kernel_and_is_reproducible(dev,
                                                                  regime):
    """The matrix-free logit paths draw PG through the kernel once a step
    plus once for the cold-start check; one seed gives one run."""
    import scipy.sparse as sps

    Q, W, X, y, *_ = make_lattice_dataset(20, 30, ns=300, seed=5)
    kw = (dict(lattice=(20, 30, 8)) if regime == 'stencil'
          else dict(solver='graph'))
    q_in = sps.csr_matrix(Q) if regime == 'graph' else Q

    def make():
        s = LogitICARGibbs(q_in, W, X, y, random_state=4, **kw)
        assert s.solver == regime and s.pg_method == 'pallas_packed'
        return s

    before = (pg_devroye_cuda.launches, icar_cg_solve_cuda.launches)
    post = _run_twice(make, 12, 8)
    assert pg_devroye_cuda.launches == before[0] + 2 * 13
    assert icar_cg_solve_cuda.launches == before[1]
    assert post['beta'].shape == (8, 12, 3)


@pytest.mark.parametrize('regime', ['stencil', 'graph'])
def test_large_n_probit_runs_and_is_reproducible(dev, regime):
    import scipy.sparse as sps

    Q, W, X, y, *_ = make_lattice_dataset(20, 30, ns=300, seed=5)
    kw = (dict(lattice=(20, 30, 8)) if regime == 'stencil'
          else dict(solver='graph'))
    q_in = sps.csr_matrix(Q) if regime == 'graph' else Q
    before = (pg_devroye_cuda.launches, icar_cg_solve_cuda.launches)
    _run_twice(lambda: ProbitICARGibbs(q_in, W, X, y, random_state=4, **kw),
               10, 8)
    assert (pg_devroye_cuda.launches, icar_cg_solve_cuda.launches) == before


def test_sample_parallel_two_workers_on_one_card(dev):
    """Two worker processes on one card against one process: the same
    chains, the parent's cold-start check plus each worker's launches."""
    from occuspytial_tpu_torch.parallel import sample_parallel

    Q, W, X, y, *_ = make_data(n=150, ns=100, p=3, q=2, random_state=10)
    s = LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                       cg_impl='pallas', cg_iters=15)
    before = (pg_devroye_cuda.launches, icar_cg_solve_cuda.launches)
    post = sample_parallel(s, size=6, chains=8, mesh=['cuda:0'] * 2)
    assert pg_devroye_cuda.launches == before[0] + 1 + 2 * 6
    assert icar_cg_solve_cuda.launches == before[1] + 1 + 2 * 3 * 6
    assert s.final_carry.keys.device.type == 'cuda'
    local = s.sample(6, chains=8, progressbar=False)
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_allclose(post[name], local[name], rtol=2e-4,
                                   atol=1e-5)


def test_halo_exchange_on_cuda_tensors_under_gloo(dev):
    """gloo all-reduces CUDA tensors: four ranks on one card give the
    single-device lattice and banded graph matvecs bit for bit."""
    import scipy.sparse as sps

    from occuspytial_tpu_torch.ops import graph, stencil
    from occuspytial_tpu_torch.parallel import sharded_graph as sg
    from occuspytial_tpu_torch.parallel import sharded_stencil as ss
    from occuspytial_tpu_torch.parallel._spmd import World

    spec = stencil.LatticeSpec(16, 20, 8)
    deg = stencil.degree_grid(spec).astype(np.float32)
    v = np.random.default_rng(0).standard_normal((3, 16, 20)).astype(
        np.float32)
    single = stencil.matvec(
        spec, {'lat_deg': torch.as_tensor(deg, device=dev)},
        torch.as_tensor(v.reshape(3, -1), device=dev)).cpu().numpy()
    gspec, arrs = graph.build(
        sps.csr_matrix(lattice_precision(32, 16, 8)), deflate=0, block=128)
    assert gspec.n_pad // gspec.block == 4
    panels = (arrs['gr_bd_diag'], arrs['gr_bd_sub'], arrs['gr_bd_sup'])
    u = np.random.default_rng(1).standard_normal((2, gspec.n_pad)).astype(
        np.float32)
    fixed = {k: torch.as_tensor(a, device=dev) for k, a in arrs.items()}
    gsingle = graph.banded_matvec(gspec, fixed,
                                  torch.as_tensor(u, device=dev)).cpu().numpy()
    with World(4, ['cuda:0'] * 4) as w:
        got = w.run(ss.matvec_sharded, (spec, deg, v), (None, 0, -2),
                    out_dim=-2)
        gmv = w.run(sg.banded_matvec_sharded,
                    panels + (u.reshape(2, 4, gspec.block),), (0, 0, 0, -2),
                    out_dim=-2)
    assert np.array_equal(got.reshape(3, -1), single)
    np.testing.assert_allclose(gmv.reshape(2, -1), gsingle, rtol=1e-6,
                               atol=1e-6 * np.abs(gsingle).max())
