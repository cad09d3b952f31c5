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

from chip_smoke import HEAD, LARGE, make_lattice_dataset
from occuspytial_tpu_torch import (
    LogitICARGibbs,
    LogitRSRGibbs,
    ProbitICARGibbs,
    ProbitRSRGibbs,
    rng,
    tracing,
)
from occuspytial_tpu_torch.models.base import KERNEL_COUNTERS, GibbsBase
from occuspytial_tpu_torch.ops import cg as tcg
from occuspytial_tpu_torch.ops import polyagamma as tpg
from occuspytial_tpu_torch.ops.cuda_cg import icar_cg_solve_cuda, k3_operands
from occuspytial_tpu_torch.ops.cuda_pg import pg_devroye_cuda
from occuspytial_tpu_torch.ops.cuda_rng import threefry_plan
from occuspytial_tpu_torch.ops.cuda_rsr import collapsed_rsr_cuda
from occuspytial_tpu_torch.ops.cuda_stencil import stencil_pcg_cuda
from occuspytial_tpu_torch.ops.icar import icar_spectral, lattice_precision
from occuspytial_tpu_torch.parallel.sharded_stencil import bands
from occuspytial_tpu_torch.utils import make_data

pytestmark = pytest.mark.cuda

#: eager steps a sampler runs on clones before it captures its step: their
#: kernel launches count (GibbsBase._graph_warmup_steps)
WARM = GibbsBase._graph_warmup_steps


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card; the CPU run holds the plain version')
    return torch.device('cuda')


def test_pg_kernel_matches_plain(dev):
    sub = rng.words(rng.chain_keys(4, 8, rng.RUN, dev), 0, 0, 2)
    z = torch.linspace(-20.0, 20.0, 4034, device=dev).expand(8, 4034)
    z = z.contiguous()
    before = pg_devroye_cuda.counter.launches
    got = pg_devroye_cuda(sub, z)
    torch.cuda.synchronize()
    assert pg_devroye_cuda.counter.launches == before + 1
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
    before = pg_devroye_cuda.counter.launches
    got = pg_devroye_cuda(sub, z)
    torch.cuda.synchronize()
    assert pg_devroye_cuda.counter.launches == before + 1
    want = tpg.pg_devroye(sub.contiguous(), z)
    assert bool(torch.isfinite(got).all()) and bool((got > 0).all())
    rel = ((got - want).abs() / want.abs()).cpu().numpy()
    # the mass that picks a lane's branch comes from other library
    # functions in the kernel (erfcx) than in torch (log_ndtr): at most
    # one lane in 1000 may take another branch
    assert (rel <= 1e-5).mean() >= 0.999
    with pytest.raises(ValueError):
        pg_devroye_cuda(sub.to(torch.int32), z)


@pytest.mark.parametrize('m', [37, 4034])
def test_pg_kernel_lane_table(dev, m):
    """A lane table draws column j as global lane lanes[j]: the kernel
    with a random table equals the full-width draw at those lanes bit for
    bit, and the plain sampler with the same table to rounding."""
    sub = rng.words(rng.chain_keys(6, 4, rng.RUN, dev), 0, 0, 2)
    gen = torch.Generator(device=dev).manual_seed(m)
    total = 3 * m + 11
    z_full = 5.0 * torch.randn((4, total), device=dev, generator=gen)
    lanes = torch.randperm(total, device=dev, generator=gen)[:m]
    full = pg_devroye_cuda(sub, z_full)
    before = pg_devroye_cuda.counter.launches
    got = pg_devroye_cuda(sub, z_full[:, lanes].contiguous(), lanes)
    torch.cuda.synchronize()
    assert pg_devroye_cuda.counter.launches == before + 1
    assert torch.equal(got, full[:, lanes])
    want = tpg.pg_devroye(sub, z_full[:, lanes], lanes)
    rel = ((got - want).abs() / want.abs()).cpu().numpy()
    assert (rel <= 1e-5).mean() >= 0.999
    with pytest.raises(ValueError):
        pg_devroye_cuda(sub, z_full[:, :m], lanes.to(torch.int32))


def _stencil_sampler(**kw):
    """A logit stencil sampler on the card (20 x 30 lattice, 1 sweep)."""
    Q, W, X, y, *_ = make_lattice_dataset(20, 30, ns=300, seed=5)
    return LogitICARGibbs(Q, W, X, y, random_state=4, lattice=(20, 30, 8),
                          **kw)


#: name -> the step plan's word counts (:func:`_cell_plan`)
_CELL_PLANS = {}


def _cell_plan(name, dev):
    """The step plan's word counts of a benchmark cell's sampler, built on
    the card: icar1k's is chip_smoke.py's headline problem (1,000 sites),
    lattice10k's its 100 x 100 stencil lattice."""
    if name not in _CELL_PLANS:
        if name == 'icar1k':
            Q, W, X, y, *_ = make_data(**HEAD)
            s = LogitICARGibbs(Q, W, X, y, random_state=HEAD['random_state'],
                               device=dev)
        else:
            Q, W, X, y, *_ = make_lattice_dataset(
                LARGE['rows'], LARGE['cols'], ns=LARGE['ns'],
                seed=LARGE['seed'], min_v=LARGE['min_v'],
                max_v=LARGE['max_v'])
            s = LogitICARGibbs(Q, W, X, y, random_state=LARGE['seed'],
                               lattice=(LARGE['rows'], LARGE['cols'], 8),
                               device=dev)
        _CELL_PLANS[name] = s._plan.counts
    return _CELL_PLANS[name]


def _plan_case(name, dev):
    """(counts, tables) of a draw plan: the benchmark cells' step plans,
    odd word counts, and the word tables of the second of two row bands
    of a 2-D stencil run (``_band_tables``)."""
    if name in ('icar1k', 'lattice10k'):
        return _cell_plan(name, dev), None
    if name == 'odd':
        return {0: 1, 5: 7, 9: 333, 200: 65}, None
    s = _stencil_sampler()
    band = bands(s.lattice, s.data.visit_site, 2)[1]
    return s._plan.counts, s._band_tables(band)


@pytest.mark.parametrize('chains', [1, 64])
@pytest.mark.parametrize('case', ['icar1k', 'lattice10k', 'odd', 'band'])
def test_threefry_plan_kernel_is_the_torch_words_bit_for_bit(dev, case,
                                                             chains):
    """One launch gives the int64 torch ops' word plane and, through the
    plan's slices and word tables, every update's words: the step as a
    Python int and as a 0-d device tensor, below and above 2**32 (its low
    32 bits count)."""
    counts, tables = _plan_case(case, dev)
    plan = rng.DrawPlan(counts, dev, tables)
    plan_cpu = rng.DrawPlan(counts, 'cpu', tables)
    keys = rng.chain_keys(2 ** 33 + 7, chains, rng.RUN, dev)
    for value in (12, 2 ** 32 + 5):
        want = rng.plan_words(keys.cpu(), plan_cpu.x1, value)
        want_upd = plan_cpu(keys.cpu(), value)
        for step in (value, torch.tensor(value, device=dev)):
            before = threefry_plan.counter.launches
            assert torch.equal(threefry_plan(keys, plan.x1, step).cpu(),
                               want)
            got = plan(keys, step)
            assert threefry_plan.counter.launches == before + 2
            assert set(got) == set(counts)
            for uid, w in got.items():
                assert torch.equal(w.cpu(), want_upd[uid])
    # the low 32 bits: step 5 and step 2**32 + 5 draw the same words
    assert torch.equal(plan(keys, 5)[0], plan(keys, 2 ** 32 + 5)[0])


def test_threefry_plan_kernel_in_a_captured_graph(dev):
    """A captured plan reads the step tensor the graph advances in place:
    replay t gives the eager words of step 7 + t, and the kernel's
    counter counts each replay's launch."""
    plan = rng.DrawPlan(_cell_plan('icar1k', dev), dev)
    keys = rng.chain_keys(3, 64, rng.RUN, dev)
    step = torch.full((), 7, dtype=torch.int64, device=dev)
    plan(keys, step)
    recorded = threefry_plan.counter.recorded
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = plan(keys, step)
        step += 1
    assert threefry_plan.counter.recorded == recorded + 1
    threefry_plan.counter.launches = 0
    for t in range(4):
        graph.replay()
        want = plan(keys, 7 + t)
        for uid in got:
            assert torch.equal(got[uid], want[uid])
    torch.cuda.synchronize()
    # the replays' four and the four eager calls
    assert threefry_plan.counter.launches == 8
    assert int(step) == 11


def test_threefry_plan_kernel_refuses_what_it_does_not_take(dev):
    keys = rng.chain_keys(3, 4, rng.RUN, dev)
    x1 = torch.arange(10, device=dev)
    with pytest.raises(ValueError, match='one CUDA device'):
        threefry_plan(keys, x1.cpu(), 0)
    with pytest.raises(ValueError, match='0-d int64'):
        threefry_plan(keys, x1, torch.tensor(0, dtype=torch.int32,
                                             device=dev))
    with pytest.raises(ValueError, match='0-d int64'):
        threefry_plan(keys, x1, torch.tensor([0], device=dev))
    with pytest.raises(ValueError, match='contiguous'):
        threefry_plan(keys, x1[::2], 0)


class _Recorded:
    """A draw plan that keeps a copy of every call's words."""

    def __init__(self, plan):
        self.plan, self.words = plan, []

    def __call__(self, keys, step):
        w = self.plan(keys, step)
        self.words.append({k: v.clone() for k, v in w.items()})
        return w


def test_stencil_steps_draw_the_torch_words_through_the_kernel(dev,
                                                                monkeypatch):
    """Eight host-loop steps of the logit stencil sampler with the plan
    kernel draw, update for update, the words of the same steps with the
    plan forced onto the int64 torch ops, and the two runs and the
    captured run give the same draws; the kernel launches once a plan
    call."""
    def run(force_torch, eager):
        s = _stencil_sampler()
        s._force_eager = eager
        s._plan = _Recorded(s._plan)
        with monkeypatch.context() as m:
            if force_torch:
                m.setattr(rng, 'threefry_plan', rng.plan_words)
            before = threefry_plan.counter.launches
            post = s.sample(8, chains=8, progressbar=False)
            launches = threefry_plan.counter.launches - before
        return post, s._plan.words, launches

    post_k, words_k, launches_k = run(False, True)
    post_t, words_t, launches_t = run(True, True)
    post_g, _, launches_g = run(False, False)
    assert len(words_k) == len(words_t) == 8
    for a, b in zip(words_k, words_t):
        assert set(a) == set(b)
        for uid in a:
            assert torch.equal(a[uid], b[uid])
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(post_k[name], post_t[name])
        np.testing.assert_array_equal(post_g[name], post_t[name])
    # the init plan's launch and the steps' (none with the torch path)
    assert launches_k == 8 + 1 and launches_t == 0
    # the captured run: 8 replays, the warm-up step and the init plan
    assert launches_g == 8 + WARM + 1


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
    """Chain and row counts on and off the 64-row tiles, n off the
    48-column tiles (200) and not a multiple of 4 (333, through operands
    and vectors padded to a row stride of 336): the kernel agrees with
    the plain solve as at the main
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
    """Views that start 4 bytes into their storage (which TMA cannot
    read) are copied to aligned buffers first, with the same bits as the
    aligned path."""
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


def test_cg_kernel_at_the_main_path_shapes(dev):
    """64 chains x 6 rows x n = 1000, 8 iterations, as the headline
    problem's sampler calls it (operands prepared once), against the
    plain solve."""
    args = _cg_args(dev, 64, 6, 1000)
    ops = k3_operands(args[4])
    before = icar_cg_solve_cuda.counter.launches
    got = icar_cg_solve_cuda(*args, return_resid=True, operands=ops)
    torch.cuda.synchronize()
    assert icar_cg_solve_cuda.counter.launches == before + 1
    want = tcg.icar_cg_solve_spectral(*args, return_resid=True)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    assert float(((got[2] - want[2]).abs()
                  / (want[2].abs() + 1e-3)).max()) <= 1e-3


@pytest.mark.parametrize('n', [200, 333, 1000])
def test_cg_kernel_operands_given_or_made(dev, n):
    """The operands prepared once (k3_operands: U and U' K-major, head and
    remainder, rows padded to a multiple of 4) give the bits of a call
    that prepares its own; the wrapper refuses operands of another
    shape."""
    args = _cg_args(dev, 3, 6, n)
    ops = k3_operands(args[4])
    assert ops.shape == (4, n, (n + 3) // 4 * 4)
    made = icar_cg_solve_cuda(*args, return_resid=True)
    given = icar_cg_solve_cuda(*args, return_resid=True, operands=ops)
    for a, b in zip(made, given):
        assert torch.equal(a, b)
        assert a.is_contiguous()
    assert made[0].shape == (3, 6, n)
    with pytest.raises(ValueError, match='operands'):
        icar_cg_solve_cuda(*args, operands=ops[:2])


@pytest.mark.parametrize('n', [333, 1000])
def test_cg_kernel_replays_in_a_cuda_graph(dev, n):
    """A launch captured in a CUDA graph (its tensor maps baked into the
    node, its scratch from the graph's pool) replays to the bits of an
    eager launch, on new inputs copied into the captured buffers, and
    counts once a replay."""
    args = _cg_args(dev, 8, 6, n)
    ops = k3_operands(args[4])
    static = [a.clone() for a in args[:4]]
    icar_cg_solve_cuda(*static, *args[4:], return_resid=True, operands=ops)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = icar_cg_solve_cuda(*static, *args[4:], return_resid=True,
                                 operands=ops)
    for seed in (1, 2):
        fresh = _cg_args(dev, 8, 6, n, seed=seed)
        for buf, new in zip(static, fresh[:4]):
            buf.copy_(new)
        before = icar_cg_solve_cuda.counter.launches
        graph.replay()
        torch.cuda.synchronize()
        assert icar_cg_solve_cuda.counter.launches == before + 1
        want = icar_cg_solve_cuda(*fresh[:4], *args[4:], return_resid=True,
                                  operands=ops)
        for a, b in zip(out, want):
            assert torch.equal(a, b)


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
    before = icar_cg_solve_cuda.counter.launches
    got = icar_cg_solve_cuda(*args, return_resid=True)
    torch.cuda.synchronize()
    assert icar_cg_solve_cuda.counter.launches == before + 1
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


# ------------------ the stencil PCG kernel (stencil_pcg) ----------------- #

def _stencil_args(dev, lattice, chains, rows, seed=0):
    """(spec, fixed, rhs, x0, omega, tau) on the card: a lattice's
    arrays, a warm start near the right-hand sides, omega and tau at the
    sampler's scales."""
    from occuspytial_tpu_torch.ops import stencil as tst

    spec = tst.LatticeSpec(*lattice)
    fixed = {k: torch.as_tensor(v, device=dev)
             for k, v in tst.setup(spec).items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    rhs = torch.randn((chains, rows, spec.n), device=dev, generator=gen)
    x0 = 0.1 * torch.randn((chains, rows, spec.n), device=dev,
                           generator=gen)
    omega = 0.05 + 0.25 * torch.rand((chains, spec.n), device=dev,
                                     generator=gen)
    tau = 1.0 + 29.0 * torch.rand(chains, device=dev, generator=gen)
    return spec, fixed, rhs, x0, omega, tau


@pytest.mark.parametrize('resid', [True, False])
@pytest.mark.parametrize('iters', [0, 1, 15])
@pytest.mark.parametrize('rows', [2, 6])
@pytest.mark.parametrize('lattice', [(10, 12, 4, 1.0), (9, 15, 4, 0.6),
                                     (20, 30, 8, 1.0), (20, 30, 8, 0.8),
                                     (100, 100, 8, 1.0)])
def test_stencil_kernel_matches_the_torch_path(dev, lattice, rows, iters,
                                               resid):
    """Rook and queen lattices, rho 1 and below, square and not, up to
    the kernel's 100 x 100: one launch agrees with the torch solve
    (``cg_solve_plain``) on the same card to float32 rounding, 1e-4 of
    the largest entry, and its residual to 1e-3 of itself."""
    from occuspytial_tpu_torch.ops import stencil as tst
    from occuspytial_tpu_torch.ops.cuda_stencil import stencil_pcg_cuda

    spec, fixed, *args = _stencil_args(dev, lattice, 3, rows)
    assert tst.takes_kernel(spec, dev, torch.float32)
    before = stencil_pcg_cuda.counter.launches
    got = tst.cg_solve(spec, fixed, *args, iters, return_resid=resid)
    torch.cuda.synchronize()
    assert stencil_pcg_cuda.counter.launches == before + 1
    want = tst.cg_solve_plain(spec, fixed, *args, iters,
                              return_resid=resid)
    if resid:
        (got, got_rel), (want, want_rel) = got, want
        assert got_rel.shape == want_rel.shape == (3,)
        assert float(((got_rel - want_rel).abs()
                      / (want_rel + 1e-3)).max()) <= 1e-3
    assert got.shape == want.shape
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale


def test_stencil_kernel_is_bit_reproducible(dev):
    from occuspytial_tpu_torch.ops.cuda_stencil import stencil_pcg_cuda

    spec, fixed, *args = _stencil_args(dev, (100, 100, 8, 1.0), 4, 6)
    a = stencil_pcg_cuda(spec, fixed, *args, 15, return_resid=True)
    b = stencil_pcg_cuda(spec, fixed, *args, 15, return_resid=True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize('lattice', [(20, 30, 8, 0.8), (100, 100, 8, 1.0)])
def test_stencil_kernel_chain_independence(dev, lattice):
    """A chain's solution and residual are the same bits among 2 chains
    and among 3: a block owns one field, its sums in a fixed order."""
    from occuspytial_tpu_torch.ops.cuda_stencil import stencil_pcg_cuda

    spec, fixed, *args = _stencil_args(dev, lattice, 3, 6, seed=2)
    three = stencil_pcg_cuda(spec, fixed, *args, 15, return_resid=True)
    two = stencil_pcg_cuda(spec, fixed, *(a[:2] for a in args), 15,
                           return_resid=True)
    for u, v in zip(two, three):
        assert torch.equal(u, v[:2])


def test_stencil_kernel_replays_in_a_cuda_graph(dev):
    """A launch captured in a CUDA graph replays to the bits of an eager
    launch, on new inputs copied into the captured buffers, and its
    counter counts ``per_replay`` (1) x replays and the capture none."""
    from occuspytial_tpu_torch.ops.cuda_stencil import stencil_pcg_cuda

    spec, fixed, *args = _stencil_args(dev, (20, 30, 8, 1.0), 4, 6)
    static = [a.clone() for a in args]
    stencil_pcg_cuda(spec, fixed, *static, 15, return_resid=True)
    torch.cuda.synchronize()
    counter = stencil_pcg_cuda.counter
    recorded = counter.recorded
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = stencil_pcg_cuda(spec, fixed, *static, 15, return_resid=True)
    torch.cuda.synchronize()
    assert counter.recorded == recorded + 1
    counter.launches = 0
    for seed in (1, 2, 3):
        fresh = _stencil_args(dev, (20, 30, 8, 1.0), 4, 6, seed=seed)[2:]
        for buf, new in zip(static, fresh):
            buf.copy_(new)
        graph.replay()
        want = stencil_pcg_cuda(spec, fixed, *fresh, 15, return_resid=True)
        for a, b in zip(out, want):
            assert torch.equal(a, b)
    # three replays and the three eager launches beside them
    assert counter.launches == 6


def test_stencil_kernel_refuses_what_it_does_not_take(dev):
    from occuspytial_tpu_torch.ops import stencil as tst
    from occuspytial_tpu_torch.ops.cuda_stencil import stencil_pcg_cuda

    spec, fixed, rhs, x0, omega, tau = _stencil_args(dev, (10, 12, 4, 1.0),
                                                     2, 2)
    with pytest.raises(TypeError, match='float32'):
        stencil_pcg_cuda(spec, fixed, rhs.double(), x0, omega, tau, 3)
    with pytest.raises(TypeError, match='float32'):
        stencil_pcg_cuda(spec, {k: v.double() for k, v in fixed.items()},
                         rhs, x0, omega, tau, 3)
    with pytest.raises(ValueError, match='CUDA'):
        stencil_pcg_cuda(spec, fixed, rhs.cpu(), x0.cpu(), omega.cpu(),
                         tau.cpu(), 3)
    with pytest.raises(ValueError, match='is on'):
        stencil_pcg_cuda(spec, fixed, rhs, x0.cpu(), omega, tau, 3)
    with pytest.raises(ValueError, match='shape'):
        stencil_pcg_cuda(spec, fixed, rhs, x0[:, :1], omega, tau, 3)
    with pytest.raises(ValueError, match='rhs'):
        stencil_pcg_cuda(spec, fixed, rhs[0], x0, omega, tau, 3)
    with pytest.raises(ValueError, match='negative'):
        stencil_pcg_cuda(spec, fixed, rhs, x0, omega, tau, -1)
    big = tst.LatticeSpec(101, 100, 8)
    with pytest.raises(ValueError, match='exceeds'):
        stencil_pcg_cuda(big, fixed, rhs, x0, omega, tau, 3)
    # what the kernel does not take, cg_solve leaves to torch
    assert not tst.takes_kernel(big, dev, torch.float32)
    assert not tst.takes_kernel(spec, dev, torch.float64)
    before = stencil_pcg_cuda.counter.launches
    got = tst.cg_solve(spec, {k: v.double() for k, v in fixed.items()},
                       rhs.double(), x0.double(), omega.double(),
                       tau.double(), 3)
    assert got.dtype == torch.float64
    assert stencil_pcg_cuda.counter.launches == before


# ----------------- the collapsed probit RSR sweep kernel ----------------- #

@pytest.fixture(scope='module')
def rsr_cell():
    """ProbitRSRGibbs on the card at the benchmark cell's shapes: 1,000
    sites (40 x 25 queen lattice), p = 3, q = 128."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card; the CPU run holds the plain version')
    Q, W, X, y, *_ = make_lattice_dataset(40, 25, ns=500, seed=7)
    s = ProbitRSRGibbs(Q, W, X, y, random_state=4, q=128, device='cuda')
    assert (s.q_dim, s.n_beta) == (128, 3) and s._takes_kernel
    return s


def _rsr_inputs(s, chains, seed=0):
    """(tau, u, eps_beta, eps_eta) of ``chains`` chains, float32 on the
    sampler's device: tau over the posterior's range and beyond."""
    gen = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=s.device)

    return (t(gen.uniform(0.2, 40.0, chains)),
            t(1.5 * gen.standard_normal((chains, s.n))),
            t(gen.standard_normal((chains, s.n_beta))),
            t(gen.standard_normal((chains, s.q_dim))))


def _rsr_kernel(s, tau, u, eps_beta, eps_eta):
    f = s.fixed
    return collapsed_rsr_cuda(tau, u @ f['K'], u @ f['X'], eps_beta, eps_eta,
                              f)


def _rsr_plain(s, fixed, tau, u, eps_beta, eps_eta):
    """The torch path the kernel replaces (the sampler's own methods) on
    the arrays ``fixed``."""
    chol = s._collapsed_factor(tau, fixed)
    beta = s._update_beta_collapsed({}, u, tau, fixed, eps_beta, chol)
    eta, _ = s._update_eta_collapsed({'beta': beta}, u, tau, fixed,
                                     eps_eta, chol)
    return beta, eta


@pytest.mark.parametrize('chains', [1, 3, 37, 256])
def test_collapsed_rsr_kernel_matches_the_torch_path(dev, rsr_cell, chains):
    """The kernel's (beta, eta) against a float64 run of the torch path on
    the same float32 inputs: within 4x the float32 torch path's own
    largest error (or 1e-5 of the largest entry), every entry finite."""
    s = rsr_cell
    args = _rsr_inputs(s, chains, seed=chains)
    got = _rsr_kernel(s, *args)
    plain = _rsr_plain(s, s.fixed, *args)
    f64 = {k: v.double().cpu() for k, v in s.fixed.items()
           if torch.is_tensor(v) and v.is_floating_point()}
    ref = _rsr_plain(s, f64, *(a.double().cpu() for a in args))
    for name, g, p, r in zip(('beta', 'eta'), got, plain, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), name
        err = float((g.double().cpu() - r).abs().max())
        err_plain = float((p.double().cpu() - r).abs().max())
        assert err <= max(4 * err_plain, 1e-5 * float(r.abs().max())), (
            name, err, err_plain)


@pytest.mark.parametrize('lattice, p, q', [((12, 12), 5, 70),
                                           ((10, 10), 1, 33),
                                           ((12, 12), 6, 96)])
def test_collapsed_rsr_kernel_off_the_cell_shapes(dev, lattice, p, q):
    """q off the 32-row panels (padded with identity) and p from 1 to the
    kernel's 6: the kernel against the float64 torch path as at the
    cell's shapes."""
    Q, W, X, y, *_ = make_lattice_dataset(*lattice, ns=60, seed=3, p=p)
    s = ProbitRSRGibbs(Q, W, X, y, random_state=4, q=q, device=dev)
    assert (s.q_dim, s.n_beta) == (q, p) and s._takes_kernel
    args = _rsr_inputs(s, 37, seed=q)
    got = _rsr_kernel(s, *args)
    plain = _rsr_plain(s, s.fixed, *args)
    f64 = {k: v.double().cpu() for k, v in s.fixed.items()
           if torch.is_tensor(v) and v.is_floating_point()}
    ref = _rsr_plain(s, f64, *(a.double().cpu() for a in args))
    for name, g, pl, r in zip(('beta', 'eta'), got, plain, ref):
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), name
        err = float((g.double().cpu() - r).abs().max())
        err_plain = float((pl.double().cpu() - r).abs().max())
        assert err <= max(4 * err_plain, 1e-5 * float(r.abs().max())), (
            name, err, err_plain)


def test_collapsed_rsr_kernel_marks_a_failed_factor_nan(dev, rsr_cell):
    """An indefinite A (a negative tau) gives NaN beta and eta rows for
    that chain alone; the other chains are bit for bit their own run's."""
    s = rsr_cell
    tau, *rest = _rsr_inputs(s, 8)
    bad = tau.clone()
    bad[3] = -5.0
    beta, eta = _rsr_kernel(s, bad, *rest)
    ok_beta, ok_eta = _rsr_kernel(s, tau, *rest)
    assert bool(torch.isnan(beta[3]).all() and torch.isnan(eta[3]).all())
    keep = torch.arange(8, device=dev) != 3
    assert torch.equal(beta[keep], ok_beta[keep])
    assert torch.equal(eta[keep], ok_eta[keep])


def test_collapsed_rsr_kernel_chain_independence(dev, rsr_cell):
    """A chain's draws are the same bits at 1 and at 256 chains, and from
    launch to launch, given the same kernel inputs (the site contractions
    K'u and X'u are cuBLAS products outside the kernel, whose bits may
    depend on the batch)."""
    s, f = rsr_cell, rsr_cell.fixed
    tau, u, eb, ee = _rsr_inputs(s, 256, seed=5)
    args = (tau, u @ f['K'], u @ f['X'], eb, ee)
    full = collapsed_rsr_cuda(*args, f)
    assert all(torch.equal(a, b)
               for a, b in zip(full, collapsed_rsr_cuda(*args, f)))
    for i in (0, 77, 255):
        one = collapsed_rsr_cuda(*(a[i:i + 1] for a in args), f)
        assert torch.equal(one[0], full[0][i:i + 1])
        assert torch.equal(one[1], full[1][i:i + 1])


def test_collapsed_rsr_kernel_refuses_what_it_does_not_take(dev, rsr_cell):
    """CPU tensors, float64, shapes that disagree and sizes beyond the
    kernel's raise before any launch."""
    s = rsr_cell
    tau, u, eb, ee = _rsr_inputs(s, 4)
    f = s.fixed
    ku, xu = u @ f['K'], u @ f['X']
    before = collapsed_rsr_cuda.counter.launches
    with pytest.raises(ValueError):
        collapsed_rsr_cuda(tau.cpu(), ku, xu, eb, ee, f)
    with pytest.raises(TypeError):
        collapsed_rsr_cuda(tau.double(), ku, xu, eb, ee, f)
    with pytest.raises(ValueError):
        collapsed_rsr_cuda(tau, ku, xu, eb, ee[:, :-1], f)
    wide = torch.zeros((4, 129), device=dev)
    with pytest.raises(ValueError):
        collapsed_rsr_cuda(tau, wide, xu, eb, wide, f)
    assert collapsed_rsr_cuda.counter.launches == before


def test_main_path_runs_and_is_reproducible(dev):
    Q, W, X, y, *_ = make_data(n=150, ns=100, p=3, q=2, random_state=10)
    draws = []
    for _ in range(2):
        s = LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                           cg_iters=15)
        assert s.pg_method == 'pallas_packed'
        before = pg_devroye_cuda.counter.launches
        post = s.sample(20, chains=4, progressbar=False)
        # 20 replays, the warm-up step and the cold-start check
        assert pg_devroye_cuda.counter.launches == before + 20 + WARM + 1
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

    before = pg_devroye_cuda.counter.launches
    post = _run_twice(make, 20, 4)
    assert pg_devroye_cuda.counter.launches == before + 2 * (20 + WARM)
    assert post['beta'].shape == (4, 20, 3)


@pytest.mark.parametrize('cls', ['icar', 'rsr'])
@pytest.mark.parametrize('collapsed', [True, False])
def test_probit_samplers_run_and_are_reproducible(dev, cls, collapsed):
    """The probit paths launch neither K1 nor K3; the collapsed RSR
    ladder launches the collapsed RSR kernel once a sweep a step (warm-up
    step included), the other paths not at all; bit for bit the same
    twice."""
    Q, W, X, y, *_ = make_lattice_dataset(10, 10, ns=50, seed=3)
    sampler = {'icar': ProbitICARGibbs, 'rsr': ProbitRSRGibbs}[cls]
    counters = (pg_devroye_cuda.counter, icar_cg_solve_cuda.counter,
                collapsed_rsr_cuda.counter)
    before = [c.launches for c in counters]
    made = []

    def make():
        made.append(sampler(Q, W, X, y, random_state=4,
                            collapsed=collapsed))
        return made[-1]

    _run_twice(make, 10, 8)
    sweeps = made[0].spatial_sweeps
    want = 2 * sweeps * (10 + WARM) if cls == 'rsr' and collapsed else 0
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, want]


# ---------------------- the large-n eta regimes ------------------------ #

def _large_n_ops():
    """(module, spec, CPU fixed tensors) for a queen lattice with rho < 1
    (stencil), and the banded and ELL layouts of a CAR graph on it."""
    from occuspytial_tpu_torch.models import field
    from occuspytial_tpu_torch.ops import graph as tgr
    from occuspytial_tpu_torch.ops import stencil as tst

    out = []
    lat = tst.LatticeSpec(20, 30, 8, 0.8)
    out.append((tst, lat, {k: torch.as_tensor(v)
                           for k, v in tst.setup(lat).items()}))
    q = lattice_precision(20, 30, 8, 0.9)
    for block in ('auto', 0):
        spec, arrays = field.setup_graph(q, 600, 32, block)
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

    counters = (pg_devroye_cuda.counter, icar_cg_solve_cuda.counter,
                stencil_pcg_cuda.counter)
    before = [c.launches for c in counters]
    post = _run_twice(make, 12, 8)
    # the lattice solve is one kernel launch a step and one for the
    # cold-start check
    steps = 2 * (12 + WARM + 1)
    want = [steps, 0, steps if regime == 'stencil' else 0]
    assert [c.launches - b for c, b in zip(counters, before)] == want
    assert post['beta'].shape == (8, 12, 3)


@pytest.mark.parametrize('regime', ['stencil', 'graph'])
def test_large_n_probit_runs_and_is_reproducible(dev, regime):
    import scipy.sparse as sps

    Q, W, X, y, *_ = make_lattice_dataset(20, 30, ns=300, seed=5)
    kw = (dict(lattice=(20, 30, 8)) if regime == 'stencil'
          else dict(solver='graph'))
    q_in = sps.csr_matrix(Q) if regime == 'graph' else Q
    before = (pg_devroye_cuda.counter.launches, icar_cg_solve_cuda.counter.launches)
    solves = stencil_pcg_cuda.counter.launches
    _run_twice(lambda: ProbitICARGibbs(q_in, W, X, y, random_state=4, **kw),
               10, 8)
    assert (pg_devroye_cuda.counter.launches, icar_cg_solve_cuda.counter.launches) == before
    want = 2 * (10 + WARM + 1) if regime == 'stencil' else 0
    assert stencil_pcg_cuda.counter.launches == solves + want


def test_sample_parallel_two_workers_on_one_card(dev):
    """Two worker processes on one card against one process: the same
    chains, the parent's cold-start check plus each worker's launches."""
    from occuspytial_tpu_torch.parallel import sample_parallel

    Q, W, X, y, *_ = make_data(n=150, ns=100, p=3, q=2, random_state=10)
    s = LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                       cg_impl='pallas', cg_iters=15)
    before = (pg_devroye_cuda.counter.launches, icar_cg_solve_cuda.counter.launches)
    post = sample_parallel(s, size=6, chains=8, mesh=['cuda:0'] * 2)
    # each worker captures its step after one warm-up step
    assert pg_devroye_cuda.counter.launches == before[0] + 1 + 2 * (6 + WARM)
    assert icar_cg_solve_cuda.counter.launches == (before[1] + 1
                                           + 2 * 3 * (6 + WARM))
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


# ------------------- chain-count invariance, per sampler ---------------- #

def _invariance_cases():
    """(id, factory) for every sampler and eta regime of chip_smoke.py
    phases 5-12, at the small widths of the tests above."""
    import scipy.sparse as sps

    def head():
        return make_data(n=150, ns=100, p=3, q=2, random_state=10)[:4]

    def lat():
        return make_lattice_dataset(10, 10, ns=50, seed=3)[:4]

    def big():
        return make_lattice_dataset(20, 30, ns=300, seed=5)[:4]

    def graph_q(d):
        return (sps.csr_matrix(d[0]),) + tuple(d[1:])

    return {
        'logit-cg-xla': lambda: LogitICARGibbs(
            *head(), random_state=4, solver='cg', cg_iters=15),
        'logit-cg-pallas': lambda: LogitICARGibbs(
            *head(), random_state=4, solver='cg', cg_iters=15,
            cg_impl='pallas'),
        'logit-rsr': lambda: LogitRSRGibbs(*head(), random_state=4, q=15),
        'probit-spectral': lambda: ProbitICARGibbs(*lat(), random_state=4),
        'probit-rsr': lambda: ProbitRSRGibbs(*lat(), random_state=4),
        'probit-rsr-ordered': lambda: ProbitRSRGibbs(
            *lat(), random_state=4, collapsed=False),
        'logit-stencil': lambda: LogitICARGibbs(
            *big(), random_state=4, lattice=(20, 30, 8)),
        'logit-graph': lambda: LogitICARGibbs(
            *graph_q(big()), random_state=4, solver='graph'),
        'probit-stencil': lambda: ProbitICARGibbs(
            *big(), random_state=4, lattice=(20, 30, 8)),
        'probit-graph': lambda: ProbitICARGibbs(
            *graph_q(big()), random_state=4, solver='graph'),
    }


#: chains 0-1 among 2 chains against among 3 after 6 steps: the same bits,
#: except where a sum over the sites is a torch reduction or a batched
#: product whose CUDA kernel shape follows the number of rows reduced
#: together (the 6-row solve stacks: 12 rows against 18): the spectral
#: CG's products, the graph solve's inner products and the logit blocked
#: update's site sums around the stencil solve (the solve itself is one
#: kernel with its sums in a fixed order). There the measured bound
#: (NVIDIA H100 80GB HBM3, 700 W; scripts/torch_chain_invariance.py):
#: alpha and beta within 3.6e-7, tau within 1.003e-6 of itself; asserted
#: as (rtol, atol).
_COUNT_BOUND = {'logit-cg-xla': (2e-6, 1e-6), 'logit-stencil': (2e-6, 1e-6),
                'logit-graph': (2e-6, 1e-6)}


@pytest.mark.parametrize('case', list(_invariance_cases()))
def test_chain0_invariant_to_chain_count_on_the_card(dev, case):
    """A chain's draws depend on its own key alone: chains 0-1 run among
    2 chains and among 3 give the same bits (the CPU tests'
    ``test_chain0_invariant_to_chain_count``, on the card), or stay within
    the measured bound of :data:`_COUNT_BOUND`."""
    s = _invariance_cases()[case]()
    a = s.sample(6, chains=2, progressbar=False)
    b = s.sample(6, chains=3, progressbar=False)
    bound = _COUNT_BOUND.get(case)
    for name in ('alpha', 'beta', 'tau'):
        if bound is None:
            np.testing.assert_array_equal(a[name], b[name][:2])
        else:
            np.testing.assert_allclose(a[name], b[name][:2], rtol=bound[0],
                                       atol=bound[1])


def test_sample_parallel_2d_gloo_on_one_card(dev):
    """The 2-D sampler: a 1 x 2 gloo mesh of two ranks on cuda:0 (two
    lattice bands) against the in-process run, K1 once a step in each
    rank plus the parent's cold-start check."""
    from occuspytial_tpu_torch.parallel import mesh_2d, sample_parallel_2d

    Q, W, X, y, *_ = make_lattice_dataset(20, 30, ns=300, seed=5)

    def make():
        return LogitICARGibbs(Q, W, X, y, random_state=4,
                              lattice=(20, 30, 8))

    s = make()
    before = pg_devroye_cuda.counter.launches
    post = sample_parallel_2d(s, 6, mesh_2d(1, 2, ['cuda:0'] * 2),
                              chains=4)
    assert pg_devroye_cuda.counter.launches == before + 1 + 2 * 6
    assert s.final_carry.keys.device.type == 'cuda'
    local = make().sample(6, chains=4, progressbar=False)
    for name in ('alpha', 'beta'):
        np.testing.assert_allclose(post[name], local[name], rtol=2e-3,
                                   atol=2e-4)
    np.testing.assert_allclose(post['tau'], local['tau'], rtol=2e-3)


def test_sample_parallel_2d_dense_cg_kernel_on_one_card(dev):
    """The 2-D sampler in the dense ``'cg'`` regime through the CUDA CG
    kernel: a 1 x 2 gloo mesh of two ranks on cuda:0 (two runs of 300
    sites), each launching K3 on its chain row's gathered field three
    times a step and K1 with its lane table once, against the in-process
    run."""
    from occuspytial_tpu_torch.parallel import mesh_2d, sample_parallel_2d

    Q, W, X, y, *_ = make_lattice_dataset(20, 30, ns=300, seed=5)

    def make():
        return LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                              cg_iters=15, cg_impl='pallas')

    s = make()
    before = (pg_devroye_cuda.counter.launches, icar_cg_solve_cuda.counter.launches)
    post = sample_parallel_2d(s, 6, mesh_2d(1, 2, ['cuda:0'] * 2),
                              chains=4)
    # the parent's cold-start check launches each kernel once
    assert pg_devroye_cuda.counter.launches == before[0] + 1 + 2 * 6
    assert icar_cg_solve_cuda.counter.launches == before[1] + 1 + 2 * 3 * 6
    assert s.last_solver_resid < s.solver_check_tol
    local = make().sample(6, chains=4, progressbar=False)
    for name in ('alpha', 'beta'):
        np.testing.assert_allclose(post[name], local[name], rtol=2e-3,
                                   atol=2e-4)
    np.testing.assert_allclose(post['tau'], local['tau'], rtol=2e-3)


def test_sample_parallel_2d_rsr_one_rank_is_bit_identical(dev):
    """``LogitRSRGibbs`` (``pg_method='pallas_packed'``) on a 1 x 1 mesh
    on cuda:0: the band is the field, so its draws and final carry are the
    in-process run's, bit for bit."""
    from occuspytial_tpu_torch.parallel import mesh_2d, sample_parallel_2d

    Q, W, X, y, *_ = make_lattice_dataset(10, 10, ns=50, seed=3)

    def make():
        return LogitRSRGibbs(Q, W, X, y, random_state=3,
                             pg_method='pallas_packed')

    s = make()
    post = sample_parallel_2d(s, 6, mesh_2d(1, 1, ['cuda:0'],
                                            backend='gloo'), chains=8)
    local_s = make()
    local = local_s.sample(6, chains=8, progressbar=False)
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(post[name], local[name])
    for name, val in local_s.final_carry.states.items():
        assert torch.equal(s.final_carry.states[name], val), name


@pytest.mark.parametrize('block', [128, 0], ids=['banded', 'ell'])
def test_graph_band_operators_on_the_card(dev, block):
    """The graph band operators of the 2-D sampler (matvec, quad form,
    noise, solve) in two gloo ranks on cuda:0 against the CPU field ops on
    the same inputs, banded and ELL."""
    import scipy.sparse as sps
    from test_torch_parallel_2d_graph import band_ops_inputs, run_band_ops

    from occuspytial_tpu_torch.models import field
    from occuspytial_tpu_torch.ops import graph as tgr
    from occuspytial_tpu_torch.parallel._spmd import World

    q = sps.csr_matrix(lattice_precision(16, 10, 8))
    spec, arrays = field.setup_graph(q, q.shape[0], 24, block)
    inputs = band_ops_inputs(spec)
    iters = 6
    with World(2, ['cuda:0'] * 2) as w:
        mv, qf, nz, sol = run_band_ops(w, spec, arrays, inputs, iters)
    fixed = {k: torch.as_tensor(a) for k, a in arrays.items()}
    v = torch.as_tensor(inputs['v'])
    want = {
        'matvec': tgr.matvec(spec, fixed, v).numpy(),
        'quad_form': tgr.quad_form(spec, fixed, v).numpy(),
        'noise': tgr.noise(spec, fixed,
                           torch.as_tensor(inputs['eps'])).numpy(),
        'cg_solve': tgr.cg_solve(
            spec, fixed, *(torch.as_tensor(inputs[k])
                           for k in ('rhs', 'x0', 'omega', 'tau')),
            iters).numpy(),
    }
    for got, (name, ref) in zip((mv, qf, nz, sol), want.items()):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


# ------------------- the captured step (the graph runner) --------------- #

def test_kernels_count_their_launches_in_replays_of_a_captured_graph(dev):
    """Each kernel's device counter counts every launch that runs: a
    capture adds nothing to it (only to ``recorded``) and each replay of
    the graph adds its launches."""
    sub = rng.words(rng.chain_keys(4, 8, rng.RUN, dev), 0, 0, 2)
    z = torch.linspace(-5.0, 5.0, 300, device=dev).expand(8, 300)
    z = z.contiguous()
    s_np, u_np, _ = icar_spectral(
        lattice_precision(6, 6).toarray().astype(np.float64))
    u = torch.as_tensor(u_np, dtype=torch.float32, device=dev)
    s_eig = torch.as_tensor(s_np, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    rhs = torch.randn(8, 2, 36, device=dev, generator=gen)
    omega = torch.rand(8, 36, device=dev, generator=gen) + 0.1
    tau = torch.full((8,), 2.0, device=dev)
    counters = (pg_devroye_cuda.counter, icar_cg_solve_cuda.counter)

    def body():
        icar_cg_solve_cuda(rhs, torch.zeros_like(rhs), omega, tau, u,
                           s_eig, 4)
        return pg_devroye_cuda(sub, z)

    want = body()
    torch.cuda.synchronize()
    recorded = [c.recorded for c in counters]
    for c in counters:
        c.launches = 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = body()
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [0, 0]
    assert [c.recorded - r for c, r in zip(counters, recorded)] == [1, 1]
    for _ in range(5):
        graph.replay()
    assert [c.launches for c in counters] == [5, 5]
    assert torch.equal(got, want)


def _graph_cases():
    """Every one-process path of chip_smoke.py phases 5-12 (the cases of
    :func:`_invariance_cases`), the logit ``'chol'`` regime and the
    truncated-series Pólya-Gamma draw, at small widths."""
    def head():
        return make_data(n=150, ns=100, p=3, q=2, random_state=10)[:4]

    cases = dict(_invariance_cases())
    cases['logit-chol'] = lambda: LogitICARGibbs(*head(), random_state=4,
                                                 solver='chol')
    cases['logit-pg-gamma'] = lambda: LogitICARGibbs(
        *head(), random_state=4, solver='cg', cg_iters=15,
        pg_method='gamma')
    return cases


@pytest.mark.parametrize('case', list(_graph_cases()))
def test_graph_runner_matches_the_eager_loop(dev, case):
    """Eight replays of the captured step give the host loop's draws,
    recorded fields and final carry, bit for bit."""
    s = _graph_cases()[case]()
    assert not s._runs_eagerly()
    s.track = ('eta', 'z')
    carry = s.init_carry(4)
    want_carry, want = s._run_eager(carry, 8)
    got_carry, got = s._graph_runner(carry, 8).run(carry, 8)
    for name, val in want.items():
        assert torch.equal(got[name], val), name
    assert got_carry.step == want_carry.step == 8
    assert torch.equal(got_carry.keys, want_carry.keys)
    for name, val in want_carry.states.items():
        assert torch.equal(got_carry.states[name], val), name


def _small_cg_sampler():
    Q, W, X, y, *_ = make_data(n=150, ns=100, p=3, q=2, random_state=10)
    return LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                          cg_iters=15, cg_impl='pallas')


def test_graph_replays_advance_the_step(dev):
    """Each replay draws the next step's words: a run cut into chunks of
    5 (5, 5, 5, 1 replays of the graph captured for the whole run) is the
    whole run, and K1/K3 and the draw plan count once per replay."""
    s = _small_cg_sampler()
    whole = s.sample(16, chains=4, progressbar=False)
    carry = s.final_carry
    runner = s._graph_runners[(4, ())]
    assert runner.per_replay == [1, 3, 1, 0, 0]
    s.scan_chunk = 5
    counters = (pg_devroye_cuda.counter, icar_cg_solve_cuda.counter,
                threefry_plan.counter)
    before = [c.launches for c in counters]
    cut = s.sample(16, chains=4, progressbar=False)
    assert s._graph_runners[(4, ())] is runner
    # the cold-start check ran once; no warm-up: the graph is cached; the
    # init plan launches once
    assert [c.launches - b for c, b in zip(counters, before)] \
        == [16, 48, 16 + 1]
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(cut[name], whole[name])
    for name, val in carry.states.items():
        assert torch.equal(s.final_carry.states[name], val), name


def test_resume_and_sample_until_reuse_one_graph(dev):
    """``resume_from`` and every block of ``sample_until`` load the carry
    into the same captured step; the carry a run leaves is a copy that a
    later run does not overwrite; a resumed run is one longer run."""
    s = _small_cg_sampler()
    first = s.sample(8, chains=4, progressbar=False)
    kept = s.final_carry
    kept_tau = kept.states['tau'].clone()
    graph = s._graph_runners[(4, ())].graph
    second = s.sample(8, chains=4, progressbar=False, resume_from=kept)
    assert s._graph_runners[(4, ())].graph is graph
    assert torch.equal(kept.states['tau'], kept_tau)
    one = _small_cg_sampler().sample(16, chains=4, progressbar=False)
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(
            np.concatenate([first[name], second[name]], axis=1), one[name])
    with pytest.raises(RuntimeError, match='no convergence'):
        s.sample_until(rhat_tol=1.0 + 1e-9, chains=4, check_every=8,
                       max_size=16)
    assert s._graph_runners[(4, ())].graph is graph


def test_tracked_run_holds_one_chunk_on_the_card(dev):
    """``track=('eta',)`` at config 5 (10,000 sites, 32 chains, 1024
    draws: 1.31 GB of eta) keeps at most one 256 MB chunk of it on the
    card: the peak stays within the untracked run's plus the budget."""
    import gc

    Q, W, X, y, *_ = make_lattice_dataset(100, 100, ns=5000, seed=11,
                                          min_v=2, max_v=5)
    peaks, budget = {}, GibbsBase._auto_chunk_output_budget
    for track in ((), ('eta',)):
        s = LogitICARGibbs(Q, W, X, y, random_state=11,
                           lattice=(100, 100, 8))
        s.track = track
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        post = s.sample(1024, chains=32, progressbar=False)
        torch.cuda.synchronize()
        peaks[track] = torch.cuda.max_memory_allocated()
        if track:
            assert s._graph_runners[(32, track)].length == budget // (
                32 * 10000 * 4)
            assert post['eta'].shape == (32, 1024, 10000)
            assert np.isfinite(post['eta'][:, -1]).all()
        del s
        gc.collect()
        torch.cuda.empty_cache()
    assert peaks[('eta',)] <= peaks[()] + budget, peaks


def test_a_step_that_reads_back_makes_the_run_raise(dev, monkeypatch):
    """A step that reads a value back to the host cannot be captured: the
    run raises, and nothing runs in the host loop instead."""
    s = _small_cg_sampler()
    step = s._step

    def reading_step(keys, t, state, fixed):
        out = step(keys, t, state, fixed)
        float(out['tau'].sum())
        return out

    eager = []
    monkeypatch.setattr(s, '_step', reading_step)
    monkeypatch.setattr(s, '_run_eager',
                        lambda *a, **k: eager.append(a))
    with pytest.raises(RuntimeError):
        s.sample(4, chains=2, progressbar=False)
    assert not eager and not s._graph_runners
    assert not hasattr(s, 'final_carry')
    torch.cuda.synchronize()


# ------------- the captured band step of a 2-D run under NCCL ----------- #

@pytest.mark.parametrize('regime', ['stencil', 'cg-pallas'])
def test_2d_nccl_band_step_is_captured_and_matches_the_host_loop(dev,
                                                                 regime):
    """On a 1 x 1 NCCL mesh the rank replays its band step captured as
    one CUDA graph with its all-reduces inside (in the dense ``'cg'``
    regime with ``cg_impl='pallas'`` K3 runs in that graph too): the
    draws and the final carry are the host loop's (``_force_eager``), bit
    for bit, and K1/K3 and the draw plan count the warm-up step and
    ``per_replay`` x ``replays``, plus the parent's cold-start check and
    init plan."""
    from occuspytial_tpu_torch.parallel import mesh_2d, sample_parallel_2d

    Q, W, X, y, *_ = make_lattice_dataset(20, 30, ns=300, seed=5)
    # K1, K3, the draw plan, the stencil PCG and the collapsed RSR sweep:
    # a band solves in torch, the parent's cold-start check on the whole
    # field by the kernel
    if regime == 'stencil':
        kw = dict(lattice=(20, 30, 8))
        per_step, cold = [1, 0, 1, 0, 0], [1, 0, 1, 1, 0]
    else:
        kw = dict(solver='cg', cg_iters=15, cg_impl='pallas')
        per_step, cold = [1, 3, 1, 0, 0], [1, 1, 1, 0, 0]
    counters = KERNEL_COUNTERS
    size, runs = 8, {}
    for eager in (False, True):
        s = LogitICARGibbs(Q, W, X, y, random_state=4, **kw)
        s._force_eager = eager
        before = [c.launches for c in counters]
        post = sample_parallel_2d(s, size, mesh_2d(1, 1, ['cuda:0']),
                                  chains=4)
        runs[eager] = (s, post, [c.launches - b
                                 for c, b in zip(counters, before)])
    (s_g, post_g, got_g), (s_e, post_e, got_e) = runs[False], runs[True]
    assert [r['captured'] for r in s_g.rank_runs] == [True]
    assert [r['captured'] for r in s_e.rank_runs] == [False]
    run = s_g.rank_runs[0]
    assert run['per_replay'] == per_step and run['replays'] == size
    assert got_g == [k * (size + WARM) + c for k, c in zip(per_step, cold)]
    assert got_e == [k * size + c for k, c in zip(per_step, cold)]
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(post_g[name], post_e[name])
    assert torch.equal(s_g.final_carry.keys, s_e.final_carry.keys)
    for name, val in s_e.final_carry.states.items():
        assert torch.equal(s_g.final_carry.states[name], val), name
    assert [len(t) for t in s_g.rank_step_seconds] == [size]


def test_2d_tracked_nccl_run_holds_one_chunk_on_the_card(dev):
    """The 2-D counterpart of
    :func:`test_tracked_run_holds_one_chunk_on_the_card`: a 1 x 1 NCCL
    run of config 5 (10,000 sites, 32 chains, 1024 draws: 1.31 GB of
    eta) with ``track=('eta',)`` keeps at most one 256 MB chunk of it on
    its rank's card: the rank's peak stays within the untracked run's
    plus the budget."""
    from occuspytial_tpu_torch.parallel import mesh_2d, sample_parallel_2d

    Q, W, X, y, *_ = make_lattice_dataset(100, 100, ns=5000, seed=11,
                                          min_v=2, max_v=5)
    peaks, budget = {}, GibbsBase._auto_chunk_output_budget
    for track in ((), ('eta',)):
        s = LogitICARGibbs(Q, W, X, y, random_state=11,
                           lattice=(100, 100, 8))
        s.track = track
        post = sample_parallel_2d(s, 1024, mesh_2d(1, 1, ['cuda:0']),
                                  chains=32)
        [run] = s.rank_runs
        assert run['captured'] and run['replays'] == 1024
        peaks[track] = run['peak_bytes']
        if track:
            assert post['eta'].shape == (32, 1024, 10000)
            assert np.isfinite(post['eta'][:, -1]).all()
    assert peaks[('eta',)] <= peaks[()] + budget, peaks


# ----------------------- the step's phase spans ------------------------- #

@pytest.fixture
def traced():
    """Nothing accumulated before the test; tracing off after it."""
    tracing.report(reset=True)
    yield
    tracing.disable()
    tracing.report(reset=True)


def _marks_run_by(fn):
    """Marker kernels that ran on the card during ``fn()``, counted in a
    profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if 'span_mark_kernel' in e.name)


def test_a_step_captured_with_tracing_off_holds_no_mark(dev, traced):
    """A graph captured with tracing off launches no marker kernel and
    marks nothing; turned on, tracing recaptures the step with two marks
    a phase (as ``captured_marks`` lists them, ``step`` first and last)
    and the same K1/K3 launches a replay."""
    s = _small_cg_sampler()
    s.sample(8, chains=4, progressbar=False)
    off = s._graph_runners[(4, ())]

    def block():
        s.sample(8, chains=4, progressbar=False, resume_from=s.final_carry)

    assert _marks_run_by(block) == 0
    assert tracing.report() == {}
    known = len(tracing.captured_marks(dev))
    tracing.enable()
    block()
    on = s._graph_runners[(4, ())]
    assert on is not off
    assert on.per_replay == off.per_replay == [1, 3, 1, 0, 0]
    # step, draws, pg, alpha, z and store; tau, beta_eta, eta_solve and
    # asis a sweep
    spans = 6 + 4 * s.spatial_sweeps
    assert _marks_run_by(block) == 8 * 2 * spans
    marks = tracing.captured_marks(dev)[known:]
    assert len(marks) == 2 * spans
    assert marks[0] == (-1, 0) and marks[-1] == (0, -1)


def test_draws_are_bit_identical_with_tracing_on_and_off_on_the_card(
        dev, traced):
    runs = []
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        s = _small_cg_sampler()
        s.scan_chunk = 5
        post = s.sample(16, chains=4, progressbar=False)
        runs.append((post, s.final_carry))
    (post_off, carry_off), (post_on, carry_on) = runs
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_array_equal(post_on[name], post_off[name])
    for name, val in carry_off.states.items():
        assert torch.equal(carry_on.states[name], val), name


def test_phases_cover_the_step_and_the_stretch_on_the_card(dev, traced):
    """At the headline's width (1000 sites, 64 chains, K3): the step's
    child phases cover the step within 5% (the rest is the marks
    between them), and the steps with the gaps between them cover the
    stretch's wall time within 3%."""
    import time

    Q, W, X, y, *_ = make_lattice_dataset(40, 25, ns=500, seed=7)
    s = LogitICARGibbs(Q, W, X, y, random_state=7, solver='cg',
                       cg_impl='pallas')
    tracing.enable()
    s.sample(64, chains=64, progressbar=False)
    tracing.report(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        s.sample(64, chains=64, progressbar=False,
                 resume_from=s.final_carry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = tracing.report()
    spans = rep['spans']
    step = spans['step']['sum_s']
    children = sum(v['sum_s'] for v in spans.values()
                   if v['parent'] == 'step')
    assert 0.95 * step <= children <= step, (children, step)
    assert spans['step']['count'] == 8 * 64
    assert rep['launch_gap']['count'] == 8 * 63
    assert rep['block_boundary']['count'] == 7
    covered = (step + rep['launch_gap']['sum_s']
               + rep['block_boundary']['sum_s'])
    assert abs(covered - wall) <= 0.03 * wall, (covered, wall)
