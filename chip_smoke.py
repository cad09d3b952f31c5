#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``occuspytial_tpu_torch/csrc`` (nvcc,
sm_90a), holds each against its plain PyTorch version at the shapes of
the main path, runs ``LogitICARGibbs`` on the benchmark's headline
problem (n = 1000 sites, 64 chains) through both eta-solve
implementations, then ``LogitRSRGibbs`` (n = 1000, q = 100, 64 chains),
the two probit samplers on the 10 x 10 lattice (1024 and 512 chains),
and both ICAR samplers' matrix-free eta regimes on the 10,000-site
lattice (``solver='stencil'`` and ``'graph'``, 32 and 64 chains), then
``parallel.sample_parallel`` (the headline problem's chains over worker
processes), the site-sharded lattice and graph solves over
``torch.distributed`` worlds (gloo ranks on one card, NCCL one rank per
card) and ``parallel.sample_parallel_2d`` (over a chains x sites mesh
of ranks: both ICAR samplers' lattice and graph regimes, then the dense
regimes and the RSR samplers), then holds the captured Gibbs step (the
default runner on the card, a CUDA graph replayed once a step) against
the host loop on every one-process path and in the ranks of an NCCL 2-D
run (whose captured band step holds its all-reduces), with a tracked
2-D run that keeps one chunk of draws on the card, and prints one
JSON line of per-kernel numbers and, last, ``{"ok": true, "device":
{...}}``. After the build (phase 2), phase 2b holds the phase-span
marker kernel against its plain arithmetic; after the PG kernel (phase
3), phase 3b holds the Threefry draw-plan kernel bit for bit against the
torch-op plan at the headline problem's step plan and times both, and
phase 10 does the same at the 10,000-site stencil sampler's, and holds
the stencil PCG kernel against the torch solve at that sampler's eta
solve and times both; phase 9 holds the collapsed RSR kernel against
the torch path at the benchmark cell's sweep (256 chains, q = 128) and
times both and the library calls. Every run of a sampler on the card
checks the draw-plan kernel's launches (one a ``DrawPlan`` call) beside
K1's and K3's, the lattice runs the stencil PCG's (one a lattice
solve), and phase 9 the collapsed RSR kernel's (one a collapsed
sweep). Any failed check raises, so
the script exits non-zero without that line; it also fails without
CUDA. ``--stop-after N`` ends after phase N (a quick build-and-check
run).
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# headline problem of bench.py (config 4)
HEAD = dict(n=1000, ns=500, p=3, q=3, min_v=2, max_v=10, random_state=7)
CHAINS = 64
# phase 5 runs the bench's depth (bench.py:390-401)
MAIN_SIZE, MAIN_BURNIN = 3008, 512
CG_SIZE, CG_BURNIN = 512, 128
# phase 6 (cg_impl='pallas') at the bench's depth, as phase 5
ALT_SIZE, ALT_BURNIN = MAIN_SIZE, MAIN_BURNIN
# bench.py configs 3, 2 and 2b at their widths, depth cut from 3008 / 512
# and 2048 / 512 draws
RSR_Q = 100
LATTICE = dict(rows=10, cols=10, ns=50, seed=3)
PROBIT_ICAR_CHAINS, PROBIT_RSR_CHAINS = 1024, 512
NEW_SIZE, NEW_BURNIN = 512, 128
# bench.py configs 5 and 5g: the 100 x 100 queen lattice (10,000 sites) as
# a lattice (32 chains) and as a general sparse graph (64 chains), depth
# cut from 1024 / 128 draws; the probit family on the same data at 32
# chains and a shorter depth; the graph's seeded rerun
LARGE = dict(rows=100, cols=100, ns=5000, seed=11, min_v=2, max_v=5)
LARGE_CHAINS = {'stencil': 32, 'graph': 64}
LARGE_SIZE, LARGE_BURNIN = 512, 128
PROBIT_LARGE_CHAINS = 32
PROBIT_LARGE_SIZE, PROBIT_LARGE_BURNIN = 256, 64
RERUN_SIZE = 16
# phase 13: sample_parallel on the headline problem (phase 6's sampler)
PAR_SIZE_A, PAR_SIZE_B = 16, 6
# phase 14: the sharded solves on config 5's lattice (32 chains x 6 rows)
# and config 5g's graph in 256-site tiles (40 blocks; 64 chains x 6 rows)
SHARD_RANKS = 4
STENCIL_ROWS, GRAPH_ROWS = 32 * 6, 64 * 6
STENCIL_ITERS, GRAPH_ITERS = 200, 24
# and cut short, where the preconditioner and the sums decide the iterate
SHORT_ITERS = 3
GRAPH_BLOCK, GRAPH_RANK = 256, 512
# phase 15: sample_parallel_2d on config 5 (phase 10's data and seed, 32
# chains), 4 site ranks (25-row bands); phase 16: the same on config 5g
# (64 chains) in phase 14's 256-site tiles (10 blocks a rank: phase 11's
# 128-site tiles give 79 blocks, which no 4-rank mesh divides)
TWO_D_STEPS, TWO_D_SITES = 6, 4
# phase 17: sample_parallel_2d for the dense regimes and the RSR samplers
# at the widths of configs 4, 3, 2, 2b and 1 (config 1 runs one chain in
# the bench: 4 here)
DENSE_CHOL_CHAINS = 4
# phase 18: the captured step against the host loop, steps each way, and
# the replays traced by torch.profiler
GRAPH_STEPS, GRAPH_PROFILE_STEPS = 32, 8
# phase 19: sample_parallel_2d under NCCL, captured against the host loop
# (GRAPH_STEPS each way), and a track-ed config 5 run (1.31 GB of eta)
TRACK_SIZE = 1024

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor
#: op/s, dense TF32 tensor-core op/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12

#: operations one Pólya-Gamma rejection round must cost a lane on its
#: cheapest path (the exponential tail): 2 Threefry blocks (20 rounds x
#: add/rotate/xor + 5 key injections, ~70 integer ops each) plus ~60 float
#: operations (the proposal and the 4-term series test, about 6
#: transcendental calls); the body paths need 4 blocks. Counted at the
#: float32 rate, so the bound holds for every path
PG_OPS_PER_ROUND = 2 * 70 + 60
#: operations the mixture inputs cost a lane once: c, k_exp and the mass
#: (about 12 transcendental calls, erfcx and erfc among them)
PG_OPS_INPUTS = 120
#: 32-bit integer operations of one H100 SXM (NVIDIA's Hopper tuning
#: guide: 64 a clock on each of 132 SMs at the 1,980 MHz boost clock)
PEAK_INT32 = 132 * 64 * 1.98e9
#: integer operations one Threefry-2x32 evaluation costs: 20 rounds of
#: add, rotate (one funnel shift) and xor, 5 key injections of 3, the
#: first key add and the parity word
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2 + 2

def make_lattice_dataset(rows, cols, ns, seed, p=3, qa=3, min_v=2,
                         max_v=10, neighbors=8):
    """Simulated occupancy dataset on a (rows x cols) lattice: the JAX
    bench's ``make_lattice_dataset`` (bench.py:93-117, configs 1, 2 and
    2b), draw for draw, on the port's own helpers."""
    from occuspytial_tpu_torch.ops.icar import lattice_precision
    from occuspytial_tpu_torch.utils import get_generator

    n = rows * cols
    gen = get_generator(seed)
    Q = lattice_precision(rows, cols, neighbors).astype(float)
    X = gen.uniform(-2, 2, (n, p))
    X[:, 0] = 1
    beta = gen.standard_normal(p)
    alpha = gen.standard_normal(qa)
    psi = 1 / (1 + np.exp(-(X @ beta)))
    z = gen.binomial(1, psi)
    sites = gen.choice(n, ns, replace=False)
    W, y = {}, {}
    for site in sites:
        v = gen.integers(min_v, max_v, endpoint=True)
        w = gen.uniform(-2, 2, (v, qa))
        w[:, 0] = 1
        d = 1 / (1 + np.exp(-(w @ alpha)))
        W[int(site)] = w
        y[int(site)] = gen.binomial(1, z[site] * d)
    return Q, W, X, y, alpha, beta


def phase(name):
    print(f'--- {name}', flush=True)
    return time.perf_counter()


def done(t0):
    print(f'    phase seconds: {time.perf_counter() - t0:.3f}', flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls=10, reps=5):
    """Mean milliseconds of ``fn()`` replayed from a CUDA graph that
    captured ``calls`` calls (no host work between them), by CUDA events
    over ``reps`` replays after one warm-up call and one warm-up replay."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def min_pooled_ess(post):
    """Min pooled bulk-ESS over every alpha, beta and tau component
    (bench.py's metric)."""
    from occuspytial_tpu_torch import diagnostics as dg

    vals = []
    for name in ('alpha', 'beta', 'tau'):
        arr = np.asarray(post[name])
        cols = arr[..., None] if arr.ndim == 2 else arr
        vals += [dg.ess_bulk(cols[:, :, j]) for j in range(cols.shape[2])]
    return float(np.nanmin(vals))


def check_posterior(post, chains, kept, dims):
    """Every draw finite, every array (chains, kept[, dim])."""
    for name, dim in dims.items():
        arr = np.asarray(post[name])
        want = (chains, kept) + ((dim,) if dim else ())
        check(arr.shape == want, f'{name} shape {arr.shape} != {want}')
        check(np.isfinite(arr).all(), f'non-finite {name} draws')


def check_state(carry):
    """Every floating state entry of the final carry finite."""
    for name, val in carry.states.items():
        if val.is_floating_point():
            check(bool(val.isfinite().all()), f'non-finite state {name}')


def run_timed(sampler, size, burnin, chains, counters):
    """``sampler.sample`` with every kernel count set to 0 just before;
    returns the posterior, the wall seconds and the counts just after."""
    import torch

    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    ts = time.perf_counter()
    post = sampler.sample(size, burnin=burnin, chains=chains,
                          progressbar=False)
    torch.cuda.synchronize()
    sec = time.perf_counter() - ts
    return post, sec, [c.launches for c in counters]


def init_plans(s):
    """Draw-plan calls (:class:`rng.DrawPlan`, one launch each on the
    card) of ``s.init_carry``: the common start's, the probit eps's and a
    reduced basis's eta."""
    from occuspytial_tpu_torch import ProbitICARGibbs, ProbitRSRGibbs

    return (1 + isinstance(s, (ProbitICARGibbs, ProbitRSRGibbs))
            + hasattr(s, 'q_dim'))


def warmup_steps():
    """Eager steps a sampler runs on clones of its carry before it
    captures its step; their kernel launches count."""
    from occuspytial_tpu_torch.models.base import GibbsBase

    return GibbsBase._graph_warmup_steps


def eager_reference(s, size, chains):
    """``s.sample(size, chains=chains)`` through the host loop
    (``_run_eager``), the loop a gloo or timed 2-D rank runs: the draws as
    {name: (chains, size[, dim])} and ``s.final_carry`` set."""
    carry, out = s._run_eager(s.init_carry(chains), size)
    s.final_carry = carry
    return {k: np.moveaxis(v.cpu().numpy(), 0, 1) for k, v in out.items()}


@contextlib.contextmanager
def torch_lattice_solves():
    """Every lattice solve in torch ops (``ops/stencil.py:
    cg_solve_plain``), as a band of a 2-D run makes it, not by the stencil
    PCG kernel: the one-process reference a 1 x 1 mesh is held to bit for
    bit."""
    from occuspytial_tpu_torch.ops import stencil

    takes = stencil.takes_kernel
    stencil.takes_kernel = lambda *args, **kwargs: False
    try:
        yield
    finally:
        stencil.takes_kernel = takes


def report(label, post, size, sec):
    ess = min_pooled_ess(post)
    print(f'    {label}: {size / sec:.2f} it/s, min pooled bulk-ESS '
          f'{ess:.1f}, ESS/s {ess / sec:.2f}, wall {sec:.2f} s')
    for name in ('alpha', 'beta', 'tau'):
        print(f'    {name} mean {np.asarray(post[name]).mean(axis=(0, 1))}')
    return ess


def mean_parity(post_a, post_b):
    """Posterior means of alpha and beta agree by a two-sample z-test
    (Z = 6, floor 0.05, the pattern of tests/test_parity.py); returns the
    worst difference as a share of its tolerance."""
    from occuspytial_tpu_torch import diagnostics as dg

    worst = 0.0
    for name in ('alpha', 'beta'):
        a, b = np.asarray(post_a[name]), np.asarray(post_b[name])
        for j in range(a.shape[2]):
            ratio = dg.mean_z_ratio(a[:, :, j], b[:, :, j])
            check(ratio < 1.0, f'{name}[{j}] means differ: {ratio:.3f} '
                               'of the tolerance')
            worst = max(worst, ratio)
    return worst


def plane_drift(eta):
    """Worst chain's |sum eta| / sum |eta|: float32 rounding on the
    sum-to-zero hyperplane, ~1/sqrt(n) for a field off it."""
    return float((eta.sum(dim=-1).abs() / eta.abs().sum(dim=-1)).max())


def chain_count_diff(solve, rhs, x0, omega, tau, keep):
    """Max |difference| between chains ``keep`` of one batched solve and
    the same chains solved alone (0.0: the same bits at both counts)."""
    full = solve(rhs, x0, omega, tau)
    few = solve(rhs[keep], x0[keep], omega[keep], tau[keep])
    return float((full[keep] - few).abs().max())


def timed_rank(fn, reps, *args):
    """Per-rank: ``fn(*args)`` once, then ``reps`` more calls timed on the
    host clock between card synchronisations; returns (the output, its
    milliseconds a call as a 1-vector)."""
    import torch
    import torch.distributed as dist

    def sync():
        if out.is_cuda:
            torch.cuda.synchronize()

    out = fn(*args)
    sync()
    dist.barrier()
    ts = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    sync()
    ms = (time.perf_counter() - ts) * 1e3 / reps
    return out, torch.tensor([ms])


def parallel_phase(dev, kind, card, counters, data, post_6, sec_6):
    """Phase 13: ``sample_parallel`` on the headline problem with
    ``cg_impl='pallas'`` and phase 6's seed. Returns the K1, K3 and
    draw-plan launches of the full-width two-worker run."""
    import torch

    from occuspytial_tpu_torch import LogitICARGibbs
    from occuspytial_tpu_torch.parallel import chain_mesh, sample_parallel

    t0 = phase('13 sample_parallel: headline problem, cg_impl=pallas, '
               'chains over worker processes')

    def make():
        return LogitICARGibbs(*data, random_state=HEAD['random_state'] + 1,
                              device=dev, cg_impl='pallas')

    # (a) one worker on one card, against the same run in this process:
    # the same chain count at the same shapes, so the same bits
    s = make()
    mesh = chain_mesh(n_devices=1)
    post_p = sample_parallel(s, PAR_SIZE_A, chains=CHAINS, mesh=mesh)
    carry_p = s.final_carry
    post_l = s.sample(PAR_SIZE_A, chains=CHAINS, progressbar=False)
    carry_l = s.final_carry
    same = all(np.array_equal(post_p[k], post_l[k])
               for k in ('alpha', 'beta', 'tau'))
    same = same and torch.equal(carry_p.keys, carry_l.keys) and all(
        torch.equal(carry_p.states[k], carry_l.states[k])
        for k in carry_l.states)
    print(f'    (a) mesh {[str(d) for d in mesh]}, {PAR_SIZE_A} steps, '
          f'{CHAINS} chains: draws and final carry '
          f'{"bit-identical" if same else "differ"} to one process')
    check(same, 'one worker on the card differs from one process')
    # (b) two workers on one card: 32 chains each
    post_p = sample_parallel(s, PAR_SIZE_B, chains=CHAINS,
                             mesh=['cuda:0'] * 2)
    post_l = s.sample(PAR_SIZE_B, chains=CHAINS, progressbar=False)
    diff = 0.0
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_allclose(post_p[name], post_l[name], rtol=2e-4,
                                   atol=1e-5)
        diff = max(diff, float(np.abs(post_p[name] - post_l[name]).max()))
    print(f'    (b) 2 workers on cuda:0, {PAR_SIZE_B} steps: max |diff| '
          f'{diff:.3e}' + (' (bit-identical)' if diff == 0.0 else ''))
    # (c) two workers at full width
    s = make()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    ts = time.perf_counter()
    post = sample_parallel(s, CG_SIZE, burnin=CG_BURNIN, chains=CHAINS,
                           mesh=['cuda:0'] * 2)
    wall = time.perf_counter() - ts
    pg_n, cg_n, plan_n = (c.launches for c in counters)
    # the parent's cold-start check launches each kernel once and its
    # init the draw plan once; each worker then launches K1 and the plan
    # once a step and K3 three times a step, in its warm-up steps and in
    # its captured step's replays
    steps = CG_SIZE + warmup_steps()
    check(pg_n == 1 + 2 * steps,
          f'parallel K1 launches {pg_n} != {1 + 2 * steps}')
    check(cg_n == 1 + 2 * 3 * steps,
          f'parallel K3 launches {cg_n} != {1 + 2 * 3 * steps}')
    check(plan_n == 1 + 2 * steps,
          f'parallel draw-plan launches {plan_n} != {1 + 2 * steps}')
    check_posterior(post, CHAINS, CG_SIZE - CG_BURNIN,
                    {'alpha': s.n_alpha, 'beta': s.n_beta, 'tau': 0})
    check_state(s.final_carry)
    check(s.last_solver_resid <= s.solver_check_tol,
          f'parallel solver residual {s.last_solver_resid}')
    worst = mean_parity(post_6, post)
    ess = min_pooled_ess(post)
    busy = max(s.worker_seconds)
    print(f'    (c) 2 workers on cuda:0, {CHAINS} chains ({CHAINS // 2} '
          f'each), {CG_SIZE}/{CG_BURNIN} draws: K1 {pg_n}, K3 {cg_n}, '
          f'draw plan {plan_n} launches, last_solver_resid '
          f'{s.last_solver_resid:.3e}, worst mean z-ratio vs phase 6 '
          f'{worst:.3f}')
    print(f'    {kind} ({card}): {CG_SIZE / wall:.2f} it/s over the whole '
          f'call ({wall:.2f} s, worker start-up included), '
          f'{CG_SIZE / busy:.2f} it/s over the workers\' sampling '
          f'({", ".join(f"{x:.2f}" for x in s.worker_seconds)} s), min '
          f'pooled bulk-ESS {ess:.1f}, ESS/s {ess / wall:.2f}')
    print(f'    phase 6 in one process ({card}): {ALT_SIZE / sec_6:.2f} it/s')
    done(t0)
    return pg_n, cg_n, plan_n


def sharded_phase(dev, card):
    """Phase 14: the site-sharded stencil and graph solves at config 5's
    width over gloo ranks on one card and an NCCL world of one rank per
    card, against the single-device operators and a float64 host solve.
    Returns config 5g's graph build, ``(Q, (spec, arrays))``, which phase
    16's samplers take (:func:`two_d_samplers`)."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla
    import torch

    from occuspytial_tpu_torch.ops import graph, stencil
    from occuspytial_tpu_torch.ops.cg import pcg
    from occuspytial_tpu_torch.ops.icar import lattice_precision
    from occuspytial_tpu_torch.parallel import sharded_graph as sg
    from occuspytial_tpu_torch.parallel import sharded_stencil as ss
    from occuspytial_tpu_torch.parallel._spmd import World

    t0 = phase(f'14 sharded solves: config 5 lattice and 5g graph, gloo '
               f'({SHARD_RANKS} ranks on cuda:0) and NCCL')
    n_cards = torch.cuda.device_count()
    # the worlds start side by side; each run waits for its ranks
    worlds = {
        f'gloo x{SHARD_RANKS}': World(SHARD_RANKS, ['cuda:0'] * SHARD_RANKS),
        'gloo x1': World(1, ['cuda:0']),
        f'nccl x{n_cards}': World(n_cards,
                                  [f'cuda:{i}' for i in range(n_cards)],
                                  backend='nccl'),
    }
    gloo4, gloo1, nccl = worlds
    try:
        q5 = sps.csr_matrix(lattice_precision(LARGE['rows'], LARGE['cols'],
                                              8).astype(float))
        gen = np.random.default_rng(14)

        def rel(a, b):
            return float(np.abs(a - b).max() / np.abs(b).max())

        def short_check(label, solve, args, dims, want):
            """The sharded CG cut short at ``SHORT_ITERS`` in every world
            against the single-device PCG ``want`` at the same depth."""
            for name, w in worlds.items():
                e = rel(w.run(solve, args, dims), want)
                print(f'    {label} CG cut short at {SHORT_ITERS} '
                      f'iterations, {name} vs one device: {e:.3e}')
                check(e <= 1e-5, f'{label} sharded CG cut short differs '
                      f'from one device ({name})')

        def host_check(label, q, x, rhs, omega, tau):
            """Each row's relative residual in float64 and its relative
            distance to a float64 sparse solve."""
            lam = (tau * q + sps.diags(omega.astype(np.float64))).tocsc()
            x64 = spla.splu(lam).solve(rhs.T.astype(np.float64)).T
            res = lam @ x.T.astype(np.float64) - rhs.T
            rr = np.linalg.norm(res, axis=0) / np.linalg.norm(rhs, axis=1)
            err = (np.linalg.norm(x - x64, axis=1)
                   / np.linalg.norm(x64, axis=1))
            print(f'    {label}: per-row relative residual (float64) max '
                  f'{rr.max():.3e} median {np.median(rr):.3e}; distance '
                  f'to the float64 solve max {err.max():.3e}')
            check(np.isfinite(x).all(), f'{label} non-finite')

        # -- the lattice
        spec = stencil.LatticeSpec(LARGE['rows'], LARGE['cols'], 8)
        ss.check_extent(spec, SHARD_RANKS)
        deg = stencil.degree_grid(spec).astype(np.float32)
        n = spec.n
        v = gen.standard_normal((STENCIL_ROWS, spec.rows, spec.cols)).astype(
            np.float32)
        single = stencil.matvec(
            spec, {'lat_deg': torch.as_tensor(deg, device=dev)},
            torch.as_tensor(v.reshape(STENCIL_ROWS, n), device=dev),
        ).cpu().numpy()
        omega = gen.uniform(0.05, 0.3, n).astype(np.float32)
        tau = np.float32(gen.uniform(1.0, 30.0))
        rhs = gen.standard_normal((STENCIL_ROWS, n)).astype(np.float32)
        args = (spec, deg, rhs, np.zeros_like(rhs), omega, tau,
                STENCIL_ITERS)
        dims = (None, 0, -1, -1, 0, None, None)
        sol, ms = {}, {}
        for name, w in worlds.items():
            got = w.run(ss.matvec_sharded, (spec, deg, v), (None, 0, -2),
                        out_dim=-2).reshape(STENCIL_ROWS, n)
            e = rel(got, single)
            print(f'    stencil matvec, {name}: {e:.3e} of max |Qv| '
                  + ('(bit-identical)' if e == 0.0 else ''))
            check(e <= 1e-6, f'stencil sharded matvec differs ({name})')
            sol[name], t = w.run(timed_rank, (ss.cg_solve_sharded, 2) + args,
                                 (None, None) + dims)
            ms[name] = float(t.max()) / STENCIL_ITERS
        for name in (gloo4, nccl):
            e = rel(sol[name], sol[gloo1])
            print(f'    stencil CG ({STENCIL_ITERS} iterations, '
                  f'{STENCIL_ROWS} rows), {name} vs 1 rank: {e:.3e}')
            check(e <= 1e-4, f'stencil sharded CG differs ({name})')
        host_check('stencil CG, gloo', q5, sol[gloo4], rhs, omega,
                   float(tau))
        # one device: the lattice matvec in the PCG, the Jacobi diagonal
        fixed = {'lat_deg': torch.as_tensor(deg, device=dev)}
        om = torch.as_tensor(omega, device=dev)
        jac = 1.0 / (float(tau) * fixed['lat_deg'].reshape(-1) + om)
        want = pcg(
            lambda x: float(tau) * stencil.matvec(spec, fixed, x) + om * x,
            lambda r: r * jac, torch.as_tensor(rhs, device=dev),
            torch.zeros(rhs.shape, device=dev), SHORT_ITERS,
        ).cpu().numpy()
        short_check('stencil', ss.cg_solve_sharded,
                    args[:-1] + (SHORT_ITERS,), dims, want)
        print(f'    stencil CG ms per iteration ({card}): '
              + ', '.join(f'{k} {v:.3f} ({"NCCL" if "nccl" in k else "gloo, staged through the host"})'
                          for k, v in ms.items()))

        # -- the graph
        (gspec, arrs), build_sec = timed_call(
            graph.build, q5, deflate=GRAPH_RANK, block=GRAPH_BLOCK)
        print(f'    graph build (block {GRAPH_BLOCK}, rank {GRAPH_RANK}) '
              f'{build_sec:.2f} s: {gspec}')
        sg.check_extent(gspec, SHARD_RANKS)
        nb, bs = gspec.n_pad // gspec.block, gspec.block
        panels = (arrs['gr_bd_diag'], arrs['gr_bd_sub'], arrs['gr_bd_sup'])
        perm, pad = arrs['gr_perm'], gspec.n_pad - gspec.n
        v = np.pad(gen.standard_normal((GRAPH_ROWS, n))[:, perm],
                   ((0, 0), (0, pad))).astype(np.float32)
        fixed = {k: torch.as_tensor(a, device=dev) for k, a in arrs.items()}
        single = graph.banded_matvec(gspec, fixed, torch.as_tensor(
            v, device=dev)).cpu().numpy()
        omega = gen.uniform(0.05, 0.3, n).astype(np.float32)
        tau = np.float32(gen.uniform(1.0, 30.0))
        rhs = gen.standard_normal((GRAPH_ROWS, n)).astype(np.float32)
        rhs_p = np.pad(rhs[:, perm], ((0, 0), (0, pad))).astype(np.float32)
        omega_p = np.pad(omega[perm], (0, pad),
                         constant_values=1.0).astype(np.float32)
        args = (panels, rhs_p, np.zeros_like(rhs_p), omega_p, tau,
                GRAPH_ITERS, arrs['gr_defl_vecs_p'], arrs['gr_defl_vals'])
        dims = ((0, 0, 0), -1, -1, 0, None, None, 0, None)
        sol, ms = {}, {}
        for name, w in worlds.items():
            got = w.run(sg.banded_matvec_sharded,
                        panels + (v.reshape(GRAPH_ROWS, nb, bs),),
                        (0, 0, 0, -2), out_dim=-2).reshape(GRAPH_ROWS, -1)
            e = rel(got, single)
            print(f'    graph matvec, {name}: {e:.3e} of max |Qv| '
                  + ('(bit-identical)' if e == 0.0 else ''))
            check(e <= 1e-6, f'graph sharded matvec differs ({name})')
            sol[name], t = w.run(timed_rank, (sg.cg_solve_sharded, 2) + args,
                                 (None, None) + dims)
            ms[name] = float(t.max()) / GRAPH_ITERS
        for name in (gloo4, nccl):
            e = rel(sol[name], sol[gloo1])
            print(f'    graph CG ({GRAPH_ITERS} iterations, {GRAPH_ROWS} '
                  f'rows, deflation rank {GRAPH_RANK}), {name} vs 1 rank: '
                  f'{e:.3e}')
            check(e <= 1e-4, f'graph sharded CG differs ({name})')
        x = sol[gloo4][:, :n][:, arrs['gr_iperm']]
        host_check('graph CG, gloo', q5, x, rhs, omega, float(tau))
        # one device: the banded matvec and the deflated-Jacobi apply of
        # ops/graph in the PCG, with cbar over the padded lanes as the
        # sharded solve takes it
        om = torch.as_tensor(omega_p, device=dev)
        jac = 1.0 / (float(tau) * fixed['gr_deg_p'] + om)
        want = pcg(
            lambda x: float(tau) * graph.banded_matvec(gspec, fixed, x)
            + om * x,
            lambda r: graph._deflated_jacobi(
                jac, fixed['gr_defl_vecs_p'], fixed['gr_defl_vals'],
                float(tau), torch.mean(om), r),
            torch.as_tensor(rhs_p, device=dev),
            torch.zeros(rhs_p.shape, device=dev), SHORT_ITERS,
        ).cpu().numpy()
        short_check('graph', sg.cg_solve_sharded,
                    args[:5] + (SHORT_ITERS,) + args[6:], dims, want)
        print(f'    graph CG ms per iteration ({card}): '
              + ', '.join(f'{k} {v:.3f} ({"NCCL" if "nccl" in k else "gloo, staged through the host"})'
                          for k, v in ms.items()))
    finally:
        for w in worlds.values():
            w.close()
    done(t0)
    return q5, (gspec, arrs)


def timed_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and its seconds on the host clock."""
    tb = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - tb


@contextlib.contextmanager
def graph_reused(built):
    """Within the block, ``ops/graph.build`` of phase 14's Q at its rank
    and tile size returns phase 14's result (``built``: ``(Q, (spec,
    arrays))``) instead of building it again; the build is a function of
    Q alone (shift-invert Lanczos from a fixed start vector). Any other
    build runs as it is."""
    from occuspytial_tpu_torch.ops import graph

    q_built, (spec, arrays) = built
    build = graph.build

    def reuse(Q, deflate=64, dtype=np.float32, block='auto'):
        if (deflate == GRAPH_RANK and block == GRAPH_BLOCK
                and dtype is np.float32 and Q.shape == q_built.shape
                and abs(Q - q_built).max() == 0):
            return spec, {k: v.copy() for k, v in arrays.items()}
        return build(Q, deflate=deflate, dtype=dtype, block=block)

    graph.build = reuse
    try:
        yield
    finally:
        graph.build = build


def two_d_meshes():
    """The meshes of phases 15-19: ``'gloo'`` 1 x 4 ranks on cuda:0,
    ``'gloo1'`` one gloo rank, ``'nccl'`` one NCCL rank a card and
    ``'nccl1'`` one NCCL rank (the same mesh on one card). Used in a
    ``with`` block, each keeps its ranks up from one run to the next."""
    import torch

    from occuspytial_tpu_torch.parallel import mesh_2d

    n_cards = torch.cuda.device_count()
    meshes = {
        'gloo': mesh_2d(1, TWO_D_SITES, ['cuda:0'] * TWO_D_SITES),
        'gloo1': mesh_2d(1, 1, ['cuda:0'], backend='gloo'),
        'nccl': mesh_2d(1, n_cards),
    }
    meshes['nccl1'] = (meshes['nccl'] if n_cards == 1
                       else mesh_2d(1, 1, ['cuda:0']))
    check([m.backend for m in meshes.values()]
          == ['gloo', 'gloo', 'nccl', 'nccl'],
          f'mesh backends: {meshes}')
    return meshes


def two_d_samplers(dev, regime, graph_built=None):
    """Phase 15's or 16's two samplers (logit, probit) on config 5 or 5g,
    each with its build seconds: cls -> (sampler, seconds). On config 5g
    both take ``graph_built``, phase 14's build (:func:`graph_reused`)."""
    import scipy.sparse as sps

    from occuspytial_tpu_torch import LogitICARGibbs, ProbitICARGibbs

    Q, W, X, y = make_lattice_dataset(
        LARGE['rows'], LARGE['cols'], ns=LARGE['ns'], seed=LARGE['seed'],
        min_v=LARGE['min_v'], max_v=LARGE['max_v'])[:4]
    if regime == 'graph':
        q_in = sps.csr_matrix(Q)
        kw = dict(solver='graph', graph_rank=GRAPH_RANK,
                  graph_block=GRAPH_BLOCK)
        with graph_reused(graph_built):
            return {cls: timed_call(cls, q_in, W, X, y,
                                    random_state=LARGE['seed'], device=dev,
                                    **kw)
                    for cls in (LogitICARGibbs, ProbitICARGibbs)}
    kw = dict(lattice=(LARGE['rows'], LARGE['cols'], 8))
    return {cls: timed_call(cls, Q, W, X, y, random_state=LARGE['seed'],
                            device=dev, **kw)
            for cls in (LogitICARGibbs, ProbitICARGibbs)}


def two_d_phase(dev, card, counters, meshes, regime, graph_built=None):
    """Phase 15 (``regime='stencil'``) or 16 (``'graph'``):
    ``sample_parallel_2d`` at the full width of config 5 (the 100 x 100
    lattice, 32 chains, phase 10's seed) or config 5g (the same lattice as
    a sparse Q, 64 chains, deflation rank 512 and 256-site tiles: 40
    blocks, 10 a rank) against the same runs in one process. Each family's
    sampler is built once; every run takes a shallow copy of it, whose
    cold-start solver check has not run (``.copy()`` would reseed). On
    config 5g both take phase 14's graph build (``graph_built``). The
    runs go over ``meshes`` (:func:`two_d_meshes`). The NCCL run (c)
    replays each rank's captured band step; the gloo runs and the timed
    runs loop on the host. Returns K1's launches in (a), the draw
    plan's in (a) and (c), and the two samplers, cls -> sampler."""
    import copy

    import torch

    from occuspytial_tpu_torch import LogitICARGibbs, ProbitICARGibbs
    from occuspytial_tpu_torch.parallel import sample_parallel_2d

    graph = regime == 'graph'
    chains = LARGE_CHAINS[regime]
    if graph:
        t0 = phase(f'16 sample_parallel_2d: config 5g (the 100 x 100 '
                   f'lattice as a sparse Q, {chains} chains, rank '
                   f'{GRAPH_RANK}, {GRAPH_BLOCK}-site tiles), chains x sites '
                   f'meshes')
    else:
        t0 = phase(f'15 sample_parallel_2d: config 5 (100 x 100 lattice, '
                   f'{chains} chains), chains x sites meshes')
    n_cards = torch.cuda.device_count()
    built = two_d_samplers(dev, regime, graph_built)
    for cls, (s, sec) in built.items():
        if graph:
            g, iters = s.graph, s.cg_iters
            n_pad = -(-s.n // GRAPH_BLOCK) * GRAPH_BLOCK
            check((g.block, g.n_pad, g.deflate, iters)
                  == (GRAPH_BLOCK, n_pad, GRAPH_RANK, 7)
                  and (g.n_pad // g.block) % TWO_D_SITES == 0,
                  f'graph layout {g} cg_iters {iters}')
            print(f'    {cls.__name__} build {sec:.2f} s (phase 14\'s graph '
                  f'reused): {g}, cg_iters {iters}')
    built = {cls: s for cls, (s, _) in built.items()}

    def make(cls):
        return copy.copy(built[cls])

    def run(cls, mesh, timed=False):
        s = make(cls)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        post = sample_parallel_2d(s, TWO_D_STEPS, mesh, chains=chains,
                                  timed=timed)
        launches = [c.launches for c in counters]
        captured = mesh.backend == 'nccl' and not timed
        check(all(r['captured'] == captured for r in s.rank_runs),
              f'{mesh.backend} ranks, timed={timed}: captured '
              f'{[r["captured"] for r in s.rank_runs]}')
        check_posterior(post, chains, TWO_D_STEPS,
                        {'alpha': 3, 'beta': 3, 'tau': 0})
        check_state(s.final_carry)
        check(s.last_solver_resid < s.solver_check_tol,
              f'2-D residual {s.last_solver_resid}')
        drift = plane_drift(s.final_carry.states['eta'])
        check(drift < 1e-4, f'2-D eta off the hyperplane: {drift:.2e}')
        # steady ms a step: the slowest rank's mean over the steps after
        # the first two, which pay the rank's cold start (cuBLAS handles,
        # communicators, first kernel loads)
        ms = 1e3 * max(float(np.mean(t[2:])) for t in s.rank_step_seconds)
        cold = 1e3 * max(float(t[0]) for t in s.rank_step_seconds)
        return s, post, launches, (ms, cold), drift

    def close(post, want, names, label):
        worst = 0.0
        for name in names:
            np.testing.assert_allclose(
                post[name], want[name], rtol=2e-3,
                atol=0.0 if name == 'tau' else 2e-4, err_msg=label)
            worst = max(worst, float(np.abs(post[name] - want[name]).max()))
        return worst

    # the references run the host loop, as the gloo ranks do (phases 18
    # and 19 hold the captured step against it)
    ref, ref_ms, ref_carry = {}, {}, {}
    for cls in (LogitICARGibbs, ProbitICARGibbs):
        s = make(cls)
        s.init_carry(1)  # the cold-start check, outside the timing
        torch.cuda.synchronize()
        ts = time.perf_counter()
        ref[cls] = eager_reference(s, TWO_D_STEPS, chains)
        torch.cuda.synchronize()
        ref_ms[cls] = 1e3 * (time.perf_counter() - ts) / TWO_D_STEPS
        ref_carry[cls] = s.final_carry
    gloo = meshes['gloo']

    # (a) logit, 1 x 4, gloo, four ranks on cuda:0
    s, post_a, (pg_a, cg_a, plan_a), ms_a, drift = run(LogitICARGibbs,
                                                       gloo)
    want = TWO_D_SITES * TWO_D_STEPS + 1
    check(pg_a == want, f'2-D K1 launches {pg_a} != {want}')
    check(cg_a == 0, f'the 2-D {regime} path launched the K3 CG')
    # a band plan a step in every rank, and the parent's init plan
    check(plan_a == want, f'2-D draw-plan launches {plan_a} != {want}')
    diff = close(post_a, ref[LogitICARGibbs], ('alpha', 'beta', 'tau'),
                 '(a) against one process')
    print(f'    (a) logit, {gloo.shape}, gloo, 4 ranks on cuda:0: K1 '
          f'{pg_a} launches ({TWO_D_SITES} ranks x {TWO_D_STEPS} steps + '
          f'the cold-start check), K3 {cg_a}, draw plan {plan_a} (the '
          f'same steps + the init plan), every site rank of the row '
          f'holds the same alpha, beta and tau, |sum eta| / sum |eta| '
          f'{drift:.2e}, last_solver_resid {s.last_solver_resid:.3e}, max '
          f'|diff| against one process {diff:.3e} (rtol 2e-3, atol 2e-4)')
    # (b) one rank: the band is the field. A band solves its lattice in
    # torch, the one-process sampler by the stencil PCG kernel (equal to
    # float32 rounding): on the lattice the bit-for-bit reference solves
    # in torch too
    want_b, carry_b = ref[LogitICARGibbs], ref_carry[LogitICARGibbs]
    if not graph:
        with torch_lattice_solves():
            s = make(LogitICARGibbs)
            s.init_carry(1)
            want_b = eager_reference(s, TWO_D_STEPS, chains)
            carry_b = s.final_carry
    s_b, post_b, _, ms_b, _ = run(LogitICARGibbs, meshes['gloo1'])
    same = all(np.array_equal(post_b[k], want_b[k])
               for k in ('alpha', 'beta', 'tau'))
    same = same and all(
        torch.equal(s_b.final_carry.states[k], v)
        for k, v in carry_b.states.items())
    print(f'    (b) logit, 1 x 1, gloo: draws and final carry '
          f'{"bit-identical" if same else "differ"} to one process')
    check(same, 'a 1 x 1 mesh differs from one process')
    # (c) NCCL, one rank a card
    nccl = meshes['nccl']
    _, post_c, (pg_c, _, plan_c), ms_c, _ = run(LogitICARGibbs, nccl)
    # each rank's warm-up step, then one a replay
    want_c = n_cards * (TWO_D_STEPS + warmup_steps()) + 1
    check(pg_c == want_c, f'NCCL K1 launches {pg_c} != {want_c}')
    check(plan_c == want_c, f'NCCL draw-plan launches {plan_c} != {want_c}')
    diff_c = close(post_c, post_a, ('alpha', 'beta', 'tau'), '(c) vs (a)')
    diff_cl = close(post_c, ref[LogitICARGibbs], ('alpha', 'beta', 'tau'),
                    '(c) vs one process')
    print(f'    (c) logit, {nccl.shape}, NCCL over {n_cards} card(s), the '
          f'captured band step: K1 {pg_c}, draw plan {plan_c} launches, '
          f'max |diff| against (a) {diff_c:.3e}, against one process '
          f'{diff_cl:.3e}')
    # (d) probit
    s_d, post_d, (pg_d, _, plan_d), ms_d, drift = run(ProbitICARGibbs,
                                                      gloo)
    check(pg_d == 0, 'the probit path launched the PG kernel')
    want_d = TWO_D_SITES * TWO_D_STEPS + init_plans(s_d)
    check(plan_d == want_d,
          f'2-D probit draw-plan launches {plan_d} != {want_d}')
    diff_d = close(post_d, ref[ProbitICARGibbs], ('beta', 'tau'),
                   '(d) against one process')
    print(f'    (d) probit, {gloo.shape}, gloo: max |diff| of beta and tau '
          f'against one process {diff_d:.3e}, |sum eta| / sum |eta| '
          f'{drift:.2e}')
    # (e) ms a step (the ranks' sampling seconds, start-up excluded), and
    # each all-reduce label's share in runs that synchronise around every
    # all-reduce: 'dct' (the lattice preconditioner's coefficient field),
    # 'perm' (the graph solve's moves to and from the block runs),
    # 'gather', 'halo' (graph) and 'sum'
    shares = {}
    for label, mesh in (('gloo', gloo), ('NCCL', nccl)):
        st, _, _, (ms, _), _ = run(LogitICARGibbs, mesh, timed=True)
        steady = [float(np.sum(t[2:])) for t in st.rank_step_seconds]
        by = {k: max(c[k][0] / t for c, t in
                     zip(st.rank_collectives, steady))
              for k in st.rank_collectives[0]}
        coll = max(sum(v[0] for v in c.values()) / t
                   for c, t in zip(st.rank_collectives, steady))
        calls = {k: v[1] for k, v in st.rank_collectives[0].items()}
        shares[label] = (by, calls, coll, ms)
    print(f'    (e) ms a step ({card}), steady (steps 3-{TWO_D_STEPS}, the '
          f'slowest rank) and [first step]: one process logit '
          f'{ref_ms[LogitICARGibbs]:.3f}, probit '
          f'{ref_ms[ProbitICARGibbs]:.3f}; (a) gloo x{TWO_D_SITES} '
          f'{ms_a[0]:.3f} [{ms_a[1]:.1f}], (b) gloo x1 {ms_b[0]:.3f} '
          f'[{ms_b[1]:.1f}], (c) NCCL x{n_cards} {ms_c[0]:.3f} '
          f'[{ms_c[1]:.1f}], (d) probit gloo x{TWO_D_SITES} {ms_d[0]:.3f} '
          f'[{ms_d[1]:.1f}]')
    for label, (by, calls, coll, ms) in shares.items():
        how = (' (stages through the host)' if label == 'gloo'
               else '')
        print(f'    (e) {label}{how}, steps 3-{TWO_D_STEPS} of a run '
              f'synchronised around each all-reduce ({ms:.3f} ms a step), '
              f'share of the step by all-reduce: '
              + ', '.join(f'{k} {v:.3f} ({calls[k]} calls)'
                          for k, v in sorted(by.items()))
              + f'; all all-reduces {coll:.3f}')
    done(t0)
    return pg_a, (plan_a, plan_c), built


def dense_2d_phase(dev, card, counters, meshes, head, lattice):
    """Phase 17: ``sample_parallel_2d`` for the dense eta regimes and the
    RSR samplers, each case at the width of its bench configuration
    (``head``: config 4's data, ``lattice``: configs 1, 2 and 2b's),
    against a run of the same sampler and seed in one process. A case's
    sampler is built once; each run takes a shallow copy of it, whose
    cold-start solver check has not run. Every 2-D run is timed: the
    card is synchronised around each all-reduce. Every chain is held to
    one process within rtol 2e-3 / atol 2e-4 at every step, unless it
    leaves that tolerance after an exact accept decision of K1 flipped
    (:func:`flipped` inside: the rounding of the partitioned sums moved a
    lane's input across a rejection boundary). The timed ranks loop on
    the host. Returns K1's, K3's and the draw plan's launches in (a) and
    the samplers, case -> sampler."""
    import copy

    import torch

    from occuspytial_tpu_torch import (
        LogitICARGibbs,
        LogitRSRGibbs,
        ProbitICARGibbs,
        ProbitRSRGibbs,
    )
    from occuspytial_tpu_torch.ops.sites import lincomb
    from occuspytial_tpu_torch.parallel import sample_parallel_2d

    t0 = phase(f'17 sample_parallel_2d: the dense regimes and the RSR '
               f'samplers at their bench widths, {TWO_D_STEPS} steps, '
               f'chains x sites meshes')
    seed, lat_seed = HEAD['random_state'], LATTICE['seed']
    # case: (sampler, data, seed, keywords, chains)
    cases = {
        'a': (LogitICARGibbs, head, seed, dict(cg_impl='pallas'), CHAINS),
        'c': (LogitICARGibbs, head, seed, dict(cg_impl='xla'), CHAINS),
        'd': (LogitRSRGibbs, head, seed, dict(q=RSR_Q), CHAINS),
        'e': (ProbitICARGibbs, lattice, lat_seed, {}, PROBIT_ICAR_CHAINS),
        'f': (ProbitRSRGibbs, lattice, lat_seed, {}, PROBIT_RSR_CHAINS),
        'g': (LogitICARGibbs, lattice, lat_seed, {}, DENSE_CHOL_CHAINS),
    }
    built = {k: cls(*data, random_state=sd, device=dev, **kw)
             for k, (cls, data, sd, kw, _) in cases.items()}
    check(built['a'].solver == 'cg' and built['a'].cg_impl == 'pallas'
          and built['c'].cg_impl == 'xla' and built['d'].q_dim == RSR_Q
          and built['e'].solver == 'spectral'
          and built['g'].solver == 'chol', 'unexpected phase 17 regimes')

    ref, ref_ms, ref_carry = {}, {}, {}
    for k, s0 in built.items():
        # the field after each step: the input of the next step's K1
        s0.track = ('spatial',)
        s = copy.copy(s0)
        s.init_carry(1)  # the cold-start check, outside the timing
        torch.cuda.synchronize()
        ts = time.perf_counter()
        # the host loop, as the timed ranks run it (phases 18 and 19 hold
        # the captured step against it)
        ref[k] = eager_reference(s, TWO_D_STEPS, cases[k][4])
        torch.cuda.synchronize()
        ref_ms[k] = 1e3 * (time.perf_counter() - ts) / TWO_D_STEPS
        ref_carry[k] = s.final_carry

    def run(k, mesh):
        s = copy.copy(built[k])
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        post = sample_parallel_2d(s, TWO_D_STEPS, mesh, chains=cases[k][4],
                                  timed=True)
        launches = [c.launches for c in counters]
        check(not any(r['captured'] for r in s.rank_runs),
              f'17({k}): a timed rank replayed a captured step')
        check_posterior(post, cases[k][4], TWO_D_STEPS,
                        {'alpha': s.n_alpha, 'beta': s.n_beta, 'tau': 0})
        check_state(s.final_carry)
        if 'solver_resid' in s.final_carry.states:
            check(s.last_solver_resid < s.solver_check_tol,
                  f'17({k}) residual {s.last_solver_resid}')
        return s, post, launches

    def out_of_tolerance(post, want):
        """(chains, steps) mask of the draws of alpha, beta or tau outside
        rtol 2e-3 / atol 2e-4 (tau: rtol alone) of one process."""
        bad = 0
        for name in ('alpha', 'beta', 'tau'):
            a, b = np.asarray(post[name]), np.asarray(want[name])
            atol = 0.0 if name == 'tau' else 2e-4
            out = np.abs(a - b) > atol + 2e-3 * np.abs(b)
            bad = bad | (out if out.ndim == 2 else out.any(-1))
        return bad

    def flipped(s, post, want, c, upto):
        """The first step t <= ``upto`` at which K1, given chain c's state
        after step t - 1 from either run (inputs within the tolerance),
        draws some lane out of the tolerance: an exact accept decision of
        the rejection sampler that the rounding of the partitioned sums
        flipped. None if there is none."""
        x, w_flat = s.fixed['X'], s.fixed['W_flat']
        keys = s.final_carry.keys[c:c + 1]
        for t in range(1, upto + 1):
            lins, omegas = [], []
            for p in (post, want):
                def prev(name, p=p):
                    return torch.as_tensor(
                        np.asarray(p[name])[c:c + 1, t - 1], device=dev)

                lin = torch.cat([
                    lincomb(prev('beta'), x.T) + prev('spatial'),
                    lincomb(prev('alpha'), w_flat.T)], dim=-1)
                lins.append(lin)
                omegas.append(s._pg(s._plan(keys, t)[0], lin))
            if (torch.allclose(*lins, rtol=2e-3, atol=2e-4)
                    and not torch.allclose(*omegas, rtol=2e-3, atol=2e-4)):
                return t
        return None

    def close(k, s, post, want):
        """Max |diff| of alpha, beta and tau against one process over the
        chains within the tolerance at every step, and the others: a
        logit chain may leave it only after a K1 decision flipped
        (:func:`flipped`), from which step on it runs another (equally
        valid) path; any other departure fails."""
        bad = out_of_tolerance(post, want)
        diverged = {}
        for c in np.nonzero(bad.any(axis=1))[0]:
            first = int(np.argmax(bad[c]))
            t = flipped(s, post, want, c, first) if hasattr(s, '_pg') \
                else None
            check(t is not None,
                  f'17({k}) chain {c} leaves the tolerance of one process '
                  f'at step {first} with no flipped K1 decision')
            diverged[int(c)] = (t, first)
        keep = ~bad.any(axis=1)
        worst = max(float(np.abs(np.asarray(post[n])[keep]
                                  - np.asarray(want[n])[keep]).max())
                    for n in ('alpha', 'beta', 'tau'))
        return worst, diverged

    def steady(s):
        """ms a step (steps 3 on, the slowest rank), the first step's
        ms, and each all-reduce label's share of the steady steps."""
        ms = 1e3 * max(float(np.mean(t[2:])) for t in s.rank_step_seconds)
        cold = 1e3 * max(float(t[0]) for t in s.rank_step_seconds)
        spent = [float(np.sum(t[2:])) for t in s.rank_step_seconds]
        shares = {lab: max(c[lab][0] / t
                           for c, t in zip(s.rank_collectives, spent))
                  for lab in s.rank_collectives[0]}
        calls = {lab: v[1] for lab, v in s.rank_collectives[0].items()}
        return ms, cold, shares, calls

    def show(k, label, s, post, launches, mesh):
        diff, diverged = close(k, s, post, ref[k])
        ms, cold, shares, calls = steady(s)
        drift = ''
        if not hasattr(s, 'q_dim'):  # an ICAR field (RSR: eta (chains, q))
            d = plane_drift(s.final_carry.states['eta'])
            check(d < 1e-4, f'17({k}) eta off the hyperplane: {d:.2e}')
            drift = f', |sum eta| / sum |eta| {d:.2e}'
        print(f'    ({k}) {label}, {mesh.shape}, {mesh.backend}: K1 '
              f'{launches[0]}, K3 {launches[1]}, draw plan {launches[2]} '
              f'launches; every site rank '
              f'of a row holds the same alpha, beta and tau{drift}; max '
              f'|diff| against one process {diff:.3e} (rtol 2e-3, atol '
              f'2e-4) over {cases[k][4] - len(diverged)} of '
              f'{cases[k][4]} chains'
              + ''.join(f'; chain {c} leaves it at step {first} after a '
                        f'flipped K1 decision at step {t}'
                        for c, (t, first) in diverged.items()))
        print(f'        ms a step ({card}), synchronised around each '
              f'all-reduce: {ms:.3f} steady (steps 3-{TWO_D_STEPS}, the '
              f'slowest rank), {cold:.1f} first; one process '
              f'{ref_ms[k]:.3f} (its first step included); share of the '
              f'steady steps: '
              + ', '.join(f'{lab} {v:.3f} ({calls[lab]} calls)'
                          for lab, v in sorted(shares.items()))
              + f'; all {sum(shares.values()):.3f}')

    gloo = meshes['gloo']
    steps = TWO_D_SITES * TWO_D_STEPS
    # (a) the headline problem, K3 in every rank on its row's field
    s, post, (pg_a, cg_a, plan_a) = run('a', gloo)
    check(pg_a == 1 + steps, f'17(a) K1 launches {pg_a} != {1 + steps}')
    check(cg_a == 1 + 3 * steps,
          f'17(a) K3 launches {cg_a} != {1 + 3 * steps}')
    check(plan_a == 1 + steps,
          f'17(a) draw-plan launches {plan_a} != {1 + steps}')
    show('a', "LogitICARGibbs 'cg', cg_impl='pallas', config 4, "
              f'{CHAINS} chains', s, post, (pg_a, cg_a, plan_a), gloo)
    # (b) one rank: the band is the field, under gloo and under NCCL
    for mesh in (meshes['gloo1'], meshes['nccl1']):
        s_b, post_b, (pg_b, cg_b, plan_b) = run('a', mesh)
        check((pg_b, cg_b, plan_b)
              == (1 + TWO_D_STEPS, 1 + 3 * TWO_D_STEPS, 1 + TWO_D_STEPS),
              f'17(b) launches {pg_b}, {cg_b}, {plan_b}')
        same = all(np.array_equal(post_b[k], ref['a'][k])
                   for k in ('alpha', 'beta', 'tau'))
        same = same and all(
            torch.equal(s_b.final_carry.states[k], v)
            for k, v in ref_carry['a'].states.items())
        ms, _, shares, _ = steady(s_b)
        print(f'    (b) the same, 1 x 1, {mesh.backend}: draws and final '
              f'carry {"bit-identical" if same else "differ"} to one '
              f'process; K1 {pg_b}, K3 {cg_b}; {ms:.3f} ms a step, '
              f'all-reduces {sum(shares.values()):.3f} of it')
        check(same, f'a 1 x 1 {mesh.backend} mesh differs from one process')
    # (c)-(g) the torch-op CG, RSR, the probit samplers and Cholesky
    labels = {
        'c': (f"LogitICARGibbs 'cg', cg_impl='xla', config 4, {CHAINS} "
              'chains', 1 + steps, 0),
        'd': (f'LogitRSRGibbs q = {RSR_Q}, config 3, {CHAINS} chains',
              steps, 0),
        'e': ("ProbitICARGibbs 'spectral', config 2, "
              f'{PROBIT_ICAR_CHAINS} chains', 0, 0),
        'f': (f'ProbitRSRGibbs, config 2b, {PROBIT_RSR_CHAINS} chains',
              0, 0),
        'g': ("LogitICARGibbs 'chol', config 1, "
              f'{DENSE_CHOL_CHAINS} chains', steps, 0),
    }
    for k, (label, want_pg, want_cg) in labels.items():
        s, post, launches = run(k, gloo)
        # a plan a step in every rank, and the parent's init plans
        want = [want_pg, want_cg, steps + init_plans(s)]
        check(launches == want, f'17({k}) launches {launches} != {want}')
        show(k, label, s, post, launches, gloo)
    done(t0)
    return pg_a, cg_a, plan_a, built


def graph_phase(dev, card, paths, lattice):
    """Phase 18: the captured step (the default runner on the card)
    against the host loop (``_run_eager``) on every one-process path of
    phases 5-12 (``paths``: label -> (sampler, chains)) and on logit
    ``'chol'`` (config 1's ``lattice`` data, 4 chains): from one carry,
    :data:`GRAPH_STEPS` steps each way after the graph's warm-up and
    capture. Per path: draws and final carry bit for bit, ms a step of
    each by CUDA events, the capture's seconds, and K1's and K3's
    launches a replay three ways: by ``torch.profiler`` (kernels by
    name), by the kernels' own device counters, and as recorded into the
    graph. Every path is printed before a failure raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from occuspytial_tpu_torch import LogitICARGibbs
    from occuspytial_tpu_torch.models.base import KERNEL_COUNTERS

    t0 = phase(f'18 graph runner against the eager loop: every one-process '
               f'path, {GRAPH_STEPS} steps each way ({card})')
    chol = LogitICARGibbs(*lattice, random_state=LATTICE['seed'], device=dev)
    check(chol.solver == 'chol', 'config 1 is not the chol regime')
    paths = dict(paths)
    paths["logit 'chol'"] = (chol, DENSE_CHOL_CHAINS)

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / GRAPH_STEPS

    def profiled(runner, carry):
        """Kernels a replay by the profiler, K1, K3 and the draw plan a
        replay by the profiler and by the kernels' counters, over
        GRAPH_PROFILE_STEPS replays after one with the tracer on and its
        events dropped (the first kernels after the tracer starts may go
        unrecorded)."""
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            runner.run(carry, 1)
            torch.cuda.synchronize()
            prof.step()
            for c in KERNEL_COUNTERS:
                c.launches = 0
            runner.run(carry, GRAPH_PROFILE_STEPS)
            torch.cuda.synchronize()
            prof.step()
        counted = [c.launches / GRAPH_PROFILE_STEPS for c in KERNEL_COUNTERS]
        kernels = [e.name for e in prof.events()
                   if e.device_type.name == 'CUDA'
                   and not e.is_user_annotation
                   and not e.name.startswith(('Memcpy', 'Memset'))]
        seen = [sum(tag in n for n in kernels) / GRAPH_PROFILE_STEPS
                for tag in ('pg_devroye', 'icar_cg', 'threefry_plan',
                            'stencil_pcg', 'collapsed_rsr')]
        return len(kernels) / GRAPH_PROFILE_STEPS, seen, counted

    failed = []
    for label, (s, chains) in paths.items():
        check(not s._runs_eagerly(), f'{label} runs eagerly')
        s.track = ()
        # capture anew, timed here (an earlier phase's graph is dropped)
        s.__dict__.pop('_graph_runners', None)
        carry = s.init_carry(chains)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        runner = s._graph_runner(carry, GRAPH_STEPS)
        torch.cuda.synchronize()
        setup = time.perf_counter() - ts
        (c_e, o_e), eager_ms = timed(lambda: s._run_eager(carry,
                                                          GRAPH_STEPS))
        (c_g, o_g), graph_ms = timed(lambda: runner.run(carry, GRAPH_STEPS))
        pairs = [(o_g[k], o_e[k]) for k in o_e] + [(c_g.keys, c_e.keys)] + [
            (c_g.states[k], v) for k, v in c_e.states.items()]
        same = all(torch.equal(a, b) for a, b in pairs)
        # the profiler can lose kernel records (a probit graph replay
        # once counted 977.0 kernels against 1,063.6 in another run, and
        # 7 of its 8 draw-plan launches), so a count the kernels'
        # counters and the graph contradict is traced again, twice at most
        for attempt in range(3):
            per, seen, counted = profiled(runner, carry)
            if seen == counted == runner.per_replay:
                break
            print(f'    {label}: profile {attempt + 1} saw K1, K3, draw '
                  f'plan, stencil PCG, collapsed RSR {seen} a replay '
                  f'({per:.1f} kernels), '
                  f'counters '
                  f'{counted}')
        if same:
            bits = 'draws and final carry bit-identical'
        else:
            diff = max(float((a.double() - b.double()).abs().max())
                       for a, b in pairs if a.is_floating_point())
            bits = f'NOT bit-identical, max |diff| {diff:.3e}'
            failed.append(f'{label}: {bits}')
        if not seen == counted == runner.per_replay:
            failed.append(f'{label}: K1, K3, draw plan, stencil PCG, '
                          f'collapsed RSR a replay by the '
                          f'profiler {seen}, '
                          f'by the kernels\' counters {counted}, recorded '
                          f'in the graph {runner.per_replay}')
        print(f'    {label}, {chains} chains: {bits}; ms a step eager '
              f'{eager_ms:.3f}, graph {graph_ms:.3f} '
              f'({eager_ms / graph_ms:.2f}x); warm-up and capture '
              f'{setup:.3f} s (capture '
              f'{runner.capture_seconds:.3f} s); kernels a replay '
              f'(profiler) {per:.1f}, K1 {seen[0]:g}, K3 {seen[1]:g}, '
              f'draw plan {seen[2]:g}, stencil PCG {seen[3]:g}, collapsed '
              f'RSR {seen[4]:g} (counters '
              f'{", ".join(f"{c:g}" for c in counted)}; recorded '
              f'{", ".join(map(str, runner.per_replay))})')
    check(not failed, '; '.join(failed))
    done(t0)


def nccl_graph_phase(dev, card, counters, nccl, regimes):
    """Phase 19: ``sample_parallel_2d`` under NCCL, one rank a card
    (``nccl``: ``mesh_2d(1, n_cards)``), each rank replaying its band
    step captured as one CUDA graph with its all-reduces inside, against
    the same run in the host loop (``_force_eager``): :data:`GRAPH_STEPS`
    steps each way per regime (``regimes``: label -> (sampler, chains,
    K1, K3 and draw-plan launches a step, the cold-start check's and the
    init's)), draws and final carry bit for bit, ms a step of each
    runner, the capture's seconds, and K1's, K3's and the draw plan's
    launches: the warm-up step's and ``per_replay`` x ``replays`` in
    every rank, plus the parent's cold-start check and init. Then a
    ``track=('eta',)`` run of phase 15's logit sampler at
    :data:`TRACK_SIZE` draws: its rank's peak card memory within the
    untracked captured run's plus the 256 MB budget plus 32 MB. Returns
    K1's, K3's and the draw plan's launches over the captured runs."""
    import copy

    import torch

    from occuspytial_tpu_torch.models.base import GibbsBase
    from occuspytial_tpu_torch.parallel import sample_parallel_2d

    n_cards = torch.cuda.device_count()
    t0 = phase(f'19 sample_parallel_2d, NCCL over {n_cards} card(s): the '
               f'captured band step against the host loop, {GRAPH_STEPS} '
               f'steps each way ({card})')
    warm = warmup_steps()

    def run(s0, chains, size, eager=False, track=()):
        s = copy.copy(s0)
        s.track, s._force_eager = track, eager
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        post = sample_parallel_2d(s, size, nccl, chains=chains)
        launches = [c.launches for c in counters]
        check(all(r['captured'] != eager for r in s.rank_runs),
              f'captured {[r["captured"] for r in s.rank_runs]}, '
              f'eager={eager}')
        check_state(s.final_carry)
        ms = 1e3 * max(float(np.mean(t[2:])) for t in s.rank_step_seconds)
        return s, post, launches, ms

    failed, total = [], [0] * len(counters)
    untracked = None
    for label, (s0, chains, per_step, cold) in regimes.items():
        s_g, post_g, got_g, ms_g = run(s0, chains, GRAPH_STEPS)
        s_e, post_e, got_e, ms_e = run(s0, chains, GRAPH_STEPS, eager=True)
        total = [a + b for a, b in zip(total, got_g)]
        if label == 'logit stencil':
            untracked = max(r['peak_bytes'] for r in s_g.rank_runs)
        pairs = [(post_g[k], post_e[k]) for k in ('alpha', 'beta', 'tau')]
        pairs += [(s_g.final_carry.keys.cpu().numpy(),
                   s_e.final_carry.keys.cpu().numpy())]
        pairs += [(s_g.final_carry.states[k].cpu().numpy(), v.cpu().numpy())
                  for k, v in s_e.final_carry.states.items()]
        same = all(np.array_equal(a, b, equal_nan=True) for a, b in pairs)
        if same:
            bits = 'draws and final carry bit-identical'
        else:
            diff = max(float(np.abs(a.astype(np.float64) - b).max())
                       for a, b in pairs if a.dtype.kind == 'f')
            bits = f'NOT bit-identical, max |diff| {diff:.3e}'
            failed.append(f'{label}: {bits}')
        runs = s_g.rank_runs
        replays = [r['replays'] for r in runs]
        per_replay = [r['per_replay'] for r in runs]
        want_g = [n_cards * (GRAPH_STEPS + warm) * k + c
                  for k, c in zip(per_step, cold)]
        want_e = [n_cards * GRAPH_STEPS * k + c
                  for k, c in zip(per_step, cold)]
        if (per_replay != [list(per_step)] * n_cards
                or replays != [GRAPH_STEPS] * n_cards
                or got_g != want_g or got_e != want_e):
            failed.append(f'{label}: K1, K3, plan, stencil PCG, collapsed '
                          f'RSR launches '
                          f'captured {got_g} '
                          f'(want {want_g}), eager {got_e} (want {want_e}); '
                          f'per replay {per_replay}, replays {replays}')
        capture = max(r['capture_seconds'] for r in runs)
        print(f'    {label}, {chains} chains: {bits}; ms a step (steps '
              f'3-{GRAPH_STEPS}, the slowest rank) eager {ms_e:.3f}, '
              f'captured {ms_g:.3f} ({ms_e / ms_g:.2f}x); capture '
              f'{capture:.3f} s; K1, K3, plan, stencil PCG, collapsed RSR '
              f'launches '
              f'captured {got_g} = '
              f'{n_cards} rank(s) x ({GRAPH_STEPS} replays + {warm} warm-up) '
              f'x {per_replay[0]} a replay + {list(cold)} cold-start check '
              f'and init, '
              f'eager {got_e}')
    check(not failed, '; '.join(failed))

    # the track-ed run: one chunk of eta on the card at a time
    s_t, post_t, _, _ = run(regimes['logit stencil'][0],
                            regimes['logit stencil'][1], TRACK_SIZE,
                            track=('eta',))
    chains = regimes['logit stencil'][1]
    n = s_t.n
    check(post_t['eta'].shape == (chains, TRACK_SIZE, n)
          and np.isfinite(post_t['eta'][:, -1]).all(),
          f'tracked eta {post_t["eta"].shape}')
    budget = GibbsBase._auto_chunk_output_budget
    chunk = budget // (chains * n * 4)
    peak = max(r['peak_bytes'] for r in s_t.rank_runs)
    whole = chains * n * 4 * TRACK_SIZE
    print(f'    track=("eta",), {TRACK_SIZE} draws ({whole / 1e9:.2f} GB of '
          f'eta over the run, {chunk}-draw chunks): rank peak '
          f'{peak / 2**20:.1f} MiB against {untracked / 2**20:.1f} MiB '
          f'untracked (captured, {GRAPH_STEPS} draws); the bound adds '
          f'{budget / 2**20:.0f} MiB + 32 MiB')
    check(peak <= untracked + budget + (32 << 20),
          f'tracked 2-D peak {peak} > {untracked} + {budget} + 32 MiB')
    del post_t
    done(t0)
    return total


def large_n_phases(dev, kind, card, counters):
    """Phases 10-12: both ICAR samplers' matrix-free eta regimes on the
    10,000-site lattice of bench.py configs 5 and 5g. Returns K1's, the
    draw plan's and the stencil PCG's launches on the stencil and graph
    logit paths (regime -> (K1, plan, stencil PCG)), the four samplers
    with their chain counts (label -> (sampler, chains)) and phase 10's
    draw-plan and stencil PCG timings (:func:`threefry_plan_times`,
    :func:`stencil_pcg_times`); ``counters`` are K1's, K3's, the draw
    plan's and the stencil PCG's."""
    import scipy.sparse as sps
    import torch

    from occuspytial_tpu_torch import LogitICARGibbs, ProbitICARGibbs

    Q5, W5, X5, y5, *_ = make_lattice_dataset(
        LARGE['rows'], LARGE['cols'], ns=LARGE['ns'], seed=LARGE['seed'],
        min_v=LARGE['min_v'], max_v=LARGE['max_v'])
    inputs = {'stencil': (Q5, dict(lattice=(LARGE['rows'], LARGE['cols'],
                                            8))),
              'graph': (sps.csr_matrix(Q5), dict(solver='graph'))}
    dims = {'alpha': 3, 'beta': 3, 'tau': 0}
    posts, launches, samplers = {}, {}, {}

    def logit(regime, title):
        t0 = phase(title)
        q_in, kw = inputs[regime]
        chains = LARGE_CHAINS[regime]
        tb = time.perf_counter()
        s = LogitICARGibbs(q_in, W5, X5, y5, random_state=LARGE['seed'],
                           device=dev, **kw)
        build = time.perf_counter() - tb
        check(s.solver == regime and s.spatial_sweeps == 1
              and s.pg_method == 'pallas_packed' and 'Q' not in s.fixed,
              f'unexpected {regime} defaults')
        if regime == 'stencil':
            check(s.cg_iters == 15, 'stencil cg_iters')
        else:
            g = s.graph
            check((g.block, g.n_pad, g.deflate, s.cg_iters)
                  == (128, 10112, 512, 7),
                  f'graph layout {g} cg_iters {s.cg_iters}')
            print(f'    graph: {g}')
        print(f'    build seconds (sampler construction) {build:.2f}')
        post, sec, (pg_n, cg_n, plan_n, solve_n) = run_timed(
            s, LARGE_SIZE, LARGE_BURNIN, chains, counters)
        # one PG and one draw-plan launch a step (warm-up and replays),
        # plus the cold-start check's PG and the init's plan; no K3; on
        # the lattice one stencil PCG launch a step and the check's
        want = LARGE_SIZE + warmup_steps() + 1
        check(pg_n == want, f'{regime} PG launches {pg_n} != {want}')
        check(cg_n == 0, f'{regime} launched the K3 CG')
        check(plan_n == want,
              f'{regime} draw-plan launches {plan_n} != {want}')
        want_solve = want if regime == 'stencil' else 0
        check(solve_n == want_solve,
              f'{regime} stencil PCG launches {solve_n} != {want_solve}')
        check_posterior(post, chains, LARGE_SIZE - LARGE_BURNIN, dims)
        check_state(s.final_carry)
        check(s.last_solver_resid < 0.2,
              f'{regime} residual {s.last_solver_resid}')
        drift = plane_drift(s.final_carry.states['eta'])
        check(drift < 1e-4, f'{regime} eta off the hyperplane: {drift:.2e}')
        print(f'    PG launches {pg_n}, draw-plan launches {plan_n}, '
              f'stencil PCG launches {solve_n}, '
              f'last_solver_resid '
              f'{s.last_solver_resid:.3e}, |sum eta| / sum |eta| '
              f'{drift:.2e}')
        report(f'{kind} ({card})', post, LARGE_SIZE, sec)
        posts[regime], samplers[regime] = post, s
        launches[regime] = (pg_n, plan_n, solve_n)
        return t0

    t0 = logit('stencil', '10 LogitICARGibbs stencil, config 5 (100 x 100 '
                          'lattice, 32 chains)')
    plan_times = threefry_plan_times(dev, samplers['stencil'],
                                     LARGE_CHAINS['stencil'])
    solve_times = stencil_pcg_times(dev, samplers['stencil'],
                                    LARGE_CHAINS['stencil'])
    done(t0)
    t0 = logit('graph', '11 LogitICARGibbs graph, config 5g (the same '
                        'problem as a sparse Q, 64 chains)')
    worst = mean_parity(posts['stencil'], posts['graph'])
    print(f'    worst mean z-ratio, stencil vs graph {worst:.3f}')
    gr = samplers['graph']
    reruns = [gr.sample(RERUN_SIZE, chains=LARGE_CHAINS['graph'],
                        progressbar=False) for _ in range(2)]
    for name in dims:
        check(np.array_equal(reruns[0][name], reruns[1][name]),
              f'graph rerun {name} differs')
    print(f'    {RERUN_SIZE}-step rerun, same seed: bit-identical')
    # chain-count invariance of the two solves (cuBLAS picks its kernels
    # by batch size): measured and printed, not required
    gen = torch.Generator(device=dev).manual_seed(3)
    for regime, s in samplers.items():
        ch, n = LARGE_CHAINS[regime], s.n
        rhs = torch.randn((ch, s.n_beta + 3, n), device=dev, generator=gen)
        omega = 0.05 + 0.25 * torch.rand((ch, n), device=dev, generator=gen)
        tau = 1.0 + 30.0 * torch.rand(ch, device=dev, generator=gen)

        def solve(*a, s=s):
            return s._ops.cg_solve(s._spec, s.fixed, *a, s.cg_iters)

        diff = chain_count_diff(solve, rhs, 0.1 * rhs, omega, tau,
                                slice(1, 4))
        print(f'    {regime} solve, chains 1-3 alone vs among {ch}: max '
              f'|diff| {diff:.3e}'
              + (' (bit-identical)' if diff == 0.0 else ''))
    done(t0)

    t0 = phase('12 ProbitICARGibbs stencil and graph, the same problem '
               '(32 chains)')
    probit = {}
    paths = {f'logit {r}': (samplers[r], LARGE_CHAINS[r])
             for r in ('stencil', 'graph')}
    for regime, (q_in, kw) in inputs.items():
        s = ProbitICARGibbs(q_in, W5, X5, y5, random_state=LARGE['seed'],
                            device=dev, **kw)
        check(s.solver == regime and not s.collapsed
              and s.spatial_sweeps == 1
              and s.cg_iters == (15 if regime == 'stencil' else 7),
              f'unexpected probit {regime} defaults')
        post, sec, n_launch = run_timed(
            s, PROBIT_LARGE_SIZE, PROBIT_LARGE_BURNIN, PROBIT_LARGE_CHAINS,
            counters)
        steps = PROBIT_LARGE_SIZE + warmup_steps()
        # the lattice solve: one stencil PCG launch a step and the
        # cold-start check's
        want = [0, 0, steps + init_plans(s),
                steps + 1 if regime == 'stencil' else 0]
        check(n_launch == want,
              f'probit {regime} launches {n_launch} != {want}')
        check_posterior(post, PROBIT_LARGE_CHAINS,
                        PROBIT_LARGE_SIZE - PROBIT_LARGE_BURNIN, dims)
        check_state(s.final_carry)
        check(s.last_solver_resid < 0.2,
              f'probit {regime} residual {s.last_solver_resid}')
        drift = plane_drift(s.final_carry.states['eta'])
        check(drift < 1e-4, f'probit {regime} eta off the hyperplane')
        print(f'    {regime}: last_solver_resid {s.last_solver_resid:.3e}, '
              f'|sum eta| / sum |eta| {drift:.2e}')
        report(f'{kind} ({card})', post, PROBIT_LARGE_SIZE, sec)
        probit[regime] = post
        paths[f'probit {regime}'] = (s, PROBIT_LARGE_CHAINS)
    worst = mean_parity(probit['stencil'], probit['graph'])
    print(f'    worst mean z-ratio, stencil vs graph {worst:.3f}')
    done(t0)
    return launches, paths, plan_times, solve_times


def span_marks_phase(dev):
    """Phase 2b: the phase-span marker kernel (``csrc/span_mark.cu``)
    against its plain arithmetic (``tracing._apply``). One fixed mark
    sequence runs through the card's accumulator and, on a counting
    clock, through a host one: three eager steps with nested phases and a
    mark that closes one phase and opens the next (a run's first step, a
    second step of the run, a new run's first step), then a captured
    step, its marks read back from ``tracing.captured_marks``, replayed
    in two runs of 3 and 2 replays from a slot counter set to 0 (so the
    kernel reads the slot at 0 and above 0). Every phase count and the
    launch-gap and block-boundary counts must match the host's exactly
    and the hand count (4 gaps, 3 boundaries); every sum, self time and
    counter sum must be >= 0."""
    import torch

    from occuspytial_tpu_torch import tracing

    t0 = phase('2b phase-span marker kernel against its plain arithmetic')
    tb = time.perf_counter()
    tracing.enable()
    print(f'    enable (marker kernel built and loaded): '
          f'{time.perf_counter() - tb:.2f} s')
    try:
        tracing.report(reset=True)
        acc = tracing._TRACER.accumulator(dev)
        host = [0] * tracing._SIZE
        tick = [0]

        def host_mark(close, open_, first):
            tick[0] += 1
            tracing._apply(host, tick[0], close, open_, first)

        def both(close, open_, first=False):
            acc.mark(close, open_, first)
            host_mark(close, open_, first)

        draws, pg, beta_eta, eta_solve = (
            tracing.PHASES.index(n)
            for n in ('draws', 'pg', 'beta_eta', 'eta_solve'))
        for first in (True, False, True):
            both(-1, 0, first)
            both(-1, draws)
            both(draws, pg)
            both(pg, -1)
            for _ in range(2):
                both(-1, beta_eta)
                both(-1, eta_solve)
                both(eta_solve, -1)
                both(beta_eta, -1)
            both(0, -1)

        slot = torch.zeros(1, dtype=torch.int64, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        known = len(tracing.captured_marks(dev))
        with torch.cuda.graph(graph, stream=side):
            acc.mark(-1, 0, slot)
            acc.mark(-1, draws)
            acc.mark(draws, -1)
            slot += 1
            acc.mark(0, -1)
        seq = tracing.captured_marks(dev)[known:]
        check(seq == [(-1, 0), (-1, draws), (draws, -1), (0, -1)],
              f'captured marks {seq}')
        for replays in (3, 2):
            slot.zero_()
            for k in range(replays):
                graph.replay()
                for close, open_ in seq:
                    host_mark(close, open_, k == 0)
        torch.cuda.synchronize(dev)
        check(int(slot.item()) == 2, f'slot counter {int(slot.item())}')

        card = acc.read()
        P, C = tracing._P, tracing._COUNT
        counts = {n: card[C + i] for i, n in enumerate(tracing.PHASES)
                  if card[C + i]}
        print(f'    counts {counts}, gaps {card[tracing._GAP_N]}, '
              f'boundaries {card[tracing._BOUNDARY_N]}')
        check(card[C:C + P] == host[C:C + P],
              f'phase counts {card[C:C + P]} != host {host[C:C + P]}')
        check(counts == {'step': 8, 'draws': 8, 'pg': 3, 'beta_eta': 6,
                         'eta_solve': 6}, f'phase counts {counts}')
        for at, want in ((tracing._GAP_N, 4), (tracing._BOUNDARY_N, 3)):
            check(card[at] == host[at] == want,
                  f'counter {at}: card {card[at]}, host {host[at]}, '
                  f'expected {want}')
        rep = tracing.report(reset=True)
        for name, v in rep['spans'].items():
            check(v['sum_s'] >= 0 and v['self_s'] >= 0,
                  f'{name}: sum {v["sum_s"]} self {v["self_s"]}')
        for name in ('launch_gap', 'block_boundary'):
            check(rep[name]['sum_s'] >= 0, f'{name} {rep[name]}')
        check(rep['last_stamp_s'] >= rep['first_stamp_s'], 'stamps')
        print('    ' + json.dumps({
            'us': {n: round(1e6 * v['sum_s'], 3)
                   for n, v in rep['spans'].items()},
            'self_us': {n: round(1e6 * v['self_s'], 3)
                        for n, v in rep['spans'].items()},
            'gap_us': round(1e6 * rep['launch_gap']['sum_s'], 3),
            'boundary_us': round(1e6 * rep['block_boundary']['sum_s'], 3)}))
    finally:
        tracing.disable()
    done(t0)


def threefry_plan_times(dev, sampler, chains):
    """The Threefry draw-plan kernel at ``sampler``'s step plan over
    ``chains`` chains: one launch, bit for bit the plain int64 torch ops
    on the card, both timed eager and replayed from a CUDA graph, with
    the kernel's bound. Returns its numbers for the report's entry."""
    import torch

    from occuspytial_tpu_torch import rng
    from occuspytial_tpu_torch.ops.cuda_rng import threefry_plan

    plan = sampler._plan
    keys = rng.chain_keys(LARGE['seed'], chains, rng.RUN, dev)
    step = torch.full((), 2 ** 32 + 5, dtype=torch.int64, device=dev)
    before = threefry_plan.counter.launches
    got = threefry_plan(keys, plan.x1, step)
    check(threefry_plan.counter.launches == before + 1,
          'the draw plan is not one launch')
    check(torch.equal(got, rng.plan_words(keys, plan.x1, step)),
          'the draw-plan kernel\'s words differ from the torch ops\'')
    ms = time_ms(lambda: threefry_plan(keys, plan.x1, step), 200)
    ms_graph = graph_ms(lambda: threefry_plan(keys, plan.x1, step))
    plain_ms = time_ms(lambda: rng.plan_words(keys, plan.x1, step), 20)
    plain_graph = graph_ms(lambda: rng.plan_words(keys, plan.x1, step))
    counters = plan.x1.numel()
    evals = chains * counters
    written = 16 * evals
    ops = THREEFRY_OPS * evals
    bound = max(written / PEAK_BYTES, ops / PEAK_INT32) * 1e3
    by = 'bytes' if written / PEAK_BYTES >= ops / PEAK_INT32 \
        else 'integer operations'
    print(f'    draw plan: {counters} counters x {chains} chains, '
          f'{written / 1e6:.2f} MB written, {ops / 1e6:.1f} M integer '
          f'operations; kernel {ms:.5f} ms ({ms_graph:.5f} in a graph), '
          f'torch ops {plain_ms:.5f} ms ({plain_graph:.5f} in a graph), '
          f'bound {bound:.5f} ms ({by}); bit-identical')
    return dict(counters=counters, chains=chains, ms=ms,
                ms_captured=ms_graph, plain_ms=plain_ms,
                plain_ms_captured=plain_graph, bound_ms=bound, bound_by=by)


def stencil_pcg_times(dev, sampler, chains):
    """The stencil PCG kernel at ``sampler``'s eta solve over ``chains``
    chains (its ``n_beta + 3`` rows, ``cg_iters`` iterations, the
    residual): one launch against ``ops/stencil.py:cg_solve_plain`` on
    the card (1e-4 of the largest entry), both timed eager and replayed
    from a CUDA graph, with the kernel's bound. Returns its numbers for
    the report's entry."""
    import torch

    from occuspytial_tpu_torch.ops import stencil
    from occuspytial_tpu_torch.ops.cuda_stencil import stencil_pcg_cuda

    spec, fixed, n = sampler.lattice, sampler.fixed, sampler.n
    rows, iters = sampler.n_beta + 3, sampler.cg_iters
    gen = torch.Generator(device=dev).manual_seed(10)
    rhs = torch.randn((chains, rows, n), device=dev, generator=gen)
    args = (rhs, 0.1 * rhs,
            0.05 + 0.25 * torch.rand((chains, n), device=dev, generator=gen),
            1.0 + 29.0 * torch.rand(chains, device=dev, generator=gen),
            iters)

    def kernel():
        return stencil_pcg_cuda(spec, fixed, *args, return_resid=True)

    def plain():
        return stencil.cg_solve_plain(spec, fixed, *args, return_resid=True)

    before = stencil_pcg_cuda.counter.launches
    got, want = kernel(), plain()
    check(stencil_pcg_cuda.counter.launches == before + 1,
          'the stencil solve is not one launch')
    err = float((got[0] - want[0]).abs().max()) / max(
        1.0, float(want[0].abs().max()))
    check(err <= 1e-4, f'the stencil PCG kernel differs from torch: {err}')
    ms = time_ms(kernel, 20)
    ms_graph = graph_ms(kernel)
    plain_ms = time_ms(plain, 5)
    plain_graph = graph_ms(plain)
    # four side^3 products an apply, iters + 1 applies a field
    ops = 2.0 * 2 * (spec.rows ** 2 * spec.cols + spec.rows * spec.cols ** 2
                     ) * (iters + 1) * chains * rows
    nbytes = 4.0 * n * (3 * chains * rows + chains + 4)
    bound = max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3
    by = 'bytes' if nbytes / PEAK_BYTES >= ops / PEAK_F32 else 'operations'
    print(f'    stencil PCG: {chains} chains x {rows} rows, {iters} '
          f'iterations, {ops / 1e9:.2f} GFLOP; kernel {ms:.4f} ms '
          f'({ms_graph:.4f} in a graph), torch ops {plain_ms:.4f} ms '
          f'({plain_graph:.4f} in a graph), bound {bound:.4f} ms ({by}); '
          f'max |diff| / max(1, |x|) {err:.2e}')
    return dict(chains=chains, rows=rows, iters=iters, ms=ms,
                ms_captured=ms_graph, plain_ms=plain_ms,
                plain_ms_captured=plain_graph, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def collapsed_rsr_times(dev):
    """The collapsed RSR kernel at the benchmark cell's shapes (1,000
    sites, p = 3, q = 128, 256 chains) against the torch path it replaces
    (the sampler's ``_collapsed_factor``, ``_update_beta_collapsed`` and
    ``_update_eta_collapsed``; 1e-4 of the largest entry), each replayed
    from a CUDA graph, with the bound of ``rsr_factor.roofline`` and the
    library calls of the same factor and solves (cuSOLVER's potrf,
    cuBLAS's trsm) as ``library_ms``. Returns its numbers for the
    report's entry."""
    import torch

    from occuspytial_tpu_torch import ProbitRSRGibbs
    from occuspytial_tpu_torch.ops import cuda_rsr
    from occuspytial_tpu_torch.ops.mvnorm import cholesky_solve

    Q, W, X, y, *_ = make_lattice_dataset(40, 25, ns=500, seed=7)
    s = ProbitRSRGibbs(Q, W, X, y, random_state=4, q=128, device=dev)
    f, chains, q, p = s.fixed, 256, s.q_dim, s.n_beta
    gen = torch.Generator(device=dev).manual_seed(12)
    tau = 0.2 + 40.0 * torch.rand(chains, device=dev, generator=gen)
    u = 1.5 * torch.randn((chains, s.n), device=dev, generator=gen)
    eb = torch.randn((chains, p), device=dev, generator=gen)
    ee = torch.randn((chains, q), device=dev, generator=gen)
    ku, xu = u @ f['K'], u @ f['X']
    rhs = torch.cat([f['KTX'].expand(chains, q, p), ku[..., None]], -1)

    def kernel():
        return cuda_rsr.collapsed_rsr_cuda(tau, ku, xu, eb, ee, f)

    def plain():
        chol = s._collapsed_factor(tau, f)
        beta = s._update_beta_collapsed({}, u, tau, f, eb, chol)
        return beta, s._update_eta_collapsed({'beta': beta}, u, tau, f, ee,
                                              chol)[0]

    def library():
        chol = s._collapsed_factor(tau, f)
        return (cholesky_solve(rhs, chol), cholesky_solve(ku[..., None], chol),
                torch.linalg.solve_triangular(chol.mT, ee[..., None],
                                              upper=True))

    before = cuda_rsr.collapsed_rsr_cuda.counter.launches
    got, want = kernel(), plain()
    check(cuda_rsr.collapsed_rsr_cuda.counter.launches == before + 1,
          'the collapsed RSR sweep is not one launch')
    err = max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
              for g, w in zip(got, want))
    check(err <= 1e-4, f'the collapsed RSR kernel differs from torch: {err}')
    blocks = cuda_rsr.load().collapsed_rsr_blocks_per_sm()
    ms, plain_ms, lib_ms = (graph_ms(fn) for fn in (kernel, plain, library))
    ops = 2.0 * chains * (q ** 3 / 3 + (p + 2) * q * q + q * q / 2)
    nbytes = 4.0 * chains * (2 * q * q + 2 * (p + 3) * q)
    bound = max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3
    by = 'bytes' if nbytes / PEAK_BYTES >= ops / PEAK_F32 else 'operations'
    print(f'    collapsed RSR: {chains} chains, q = {q}, p = {p}, {blocks} '
          f'blocks an SM; in a graph kernel {ms:.4f} ms, torch path '
          f'{plain_ms:.4f} ms, potrf + trsm {lib_ms:.4f} ms, bound '
          f'{bound:.4f} ms ({by}); max |diff| / max(1, |x|) {err:.2e}')
    return dict(chains=chains, q=q, p=p, blocks_per_sm=blocks,
                ms_captured=ms, plain_ms_captured=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--stop-after', type=int, default=19)
    args = ap.parse_args()

    import torch

    t0 = phase('1 device')
    check(torch.cuda.is_available(), 'CUDA is not available')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    from occuspytial_tpu_torch._device import resolve_device

    dev = resolve_device('cuda')
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn={torch.backends.cudnn.allow_tf32}')
    done(t0)

    t0 = phase('2 build')
    from occuspytial_tpu_torch import _build

    tb = time.perf_counter()
    logs = _build.build()
    print(f'    build seconds (all sources in parallel): '
          f'{time.perf_counter() - tb:.2f}')
    for name, (sec, log) in logs.items():
        print(f'    {name}: {sec:.2f} s')
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'error' in line:
                print('      ' + line.strip())
    done(t0)
    span_marks_phase(dev)
    if args.stop_after < 3:
        return

    from occuspytial_tpu_torch import (
        LogitICARGibbs,
        LogitRSRGibbs,
        ProbitICARGibbs,
        ProbitRSRGibbs,
        rng,
    )
    from occuspytial_tpu_torch.ops import polyagamma as pgm
    from occuspytial_tpu_torch.ops.cg import icar_cg_solve_spectral
    from occuspytial_tpu_torch.ops.cuda_cg import (
        icar_cg_solve_cuda,
        k3_operands,
    )
    from occuspytial_tpu_torch.ops.cuda_pg import pg_devroye_cuda
    from occuspytial_tpu_torch.ops.cuda_rng import threefry_plan
    from occuspytial_tpu_torch.ops.cuda_rsr import collapsed_rsr_cuda
    from occuspytial_tpu_torch.ops.cuda_stencil import stencil_pcg_cuda
    from occuspytial_tpu_torch.utils import make_data

    Q, W, X, y, *_ = make_data(**HEAD)
    kernels = []

    t0 = phase('3 K1/K2 Pólya-Gamma kernel against the plain sampler')
    s = LogitICARGibbs(Q, W, X, y, random_state=HEAD['random_state'],
                       device=dev)
    carry = s.init_carry(CHAINS)
    st = carry.states
    z = torch.cat([st['beta'] @ s.fixed['X'].T + st['spatial'],
                   st['alpha'] @ s.fixed['W_flat'].T], dim=-1).contiguous()
    check(z.shape == (CHAINS, s.n + s.total_visits), f'z shape {z.shape}')
    sub = rng.words(carry.keys, 0, 0, 2)
    out_k = pg_devroye_cuda(sub, z)
    out_p = pgm.pg_devroye(sub, z)
    torch.cuda.synchronize()
    rel = ((out_k - out_p).abs() / out_p.abs()).cpu().numpy()
    mismatch = float((rel > 1e-5).mean())
    pg_err = float((out_k - out_p).abs().max())
    print(f'    lanes {z.numel()}, mismatch share {mismatch:.3e}, '
          f'max abs err {pg_err:.3e}')
    check(mismatch <= 1e-3, f'PG kernel mismatch share {mismatch}')
    check(bool(torch.isfinite(out_k).all()), 'PG kernel non-finite')
    for zv in (0.0, 1.0, 4.0, 16.0):
        zz = torch.full((CHAINS, 4096), zv, device=dev)
        d = pg_devroye_cuda(rng.words(carry.keys, 1, 0, 2), zz).double()
        m = float(pgm.pg_mean(torch.tensor(zv, dtype=torch.float64)))
        v = float(pgm.pg_var(torch.tensor(zv, dtype=torch.float64)))
        dm, dv = float(d.mean()), float(d.var())
        print(f'    z={zv}: mean {dm:.6f} (exact {m:.6f}), '
              f'var {dv:.6f} (exact {v:.6f})')
        check(abs(dm - m) < 5 * math.sqrt(v / zz.numel()), f'mean z={zv}')
        check(abs(dv - v) < 0.05 * v + 5e-5, f'var z={zv}')
    sub2 = sub.clone()
    sub2[5] = torch.tensor([12345, 678], device=dev)
    out_2 = pg_devroye_cuda(sub2, z)
    same = (out_2 == out_k).all(dim=1).cpu().numpy()
    check(not same[5] and same[np.arange(CHAINS) != 5].all(),
          'changing chain 5 key changed other chains')
    for method in ('pallas', 'pallas_packed'):
        s.pg_method = method
        before = pg_devroye_cuda.counter.launches
        check(torch.equal(s._pg(sub, z), out_k), f'{method} differs')
        check(pg_devroye_cuda.counter.launches == before + 1, f'{method} no launch')
    s.pg_method = 'pallas_packed'
    # a lane table (the 2-D sampler's): column j draws as global lane
    # lanes[j], so a band's lanes drawn alone are the full-width draw at
    # those lanes, in the kernel and in the plain sampler
    gen3 = torch.Generator(device=dev).manual_seed(3)
    lanes = torch.randperm(z.shape[1], device=dev, generator=gen3)[
        :z.shape[1] // TWO_D_SITES]
    z_band = z[:, lanes].contiguous()
    out_t = pg_devroye_cuda(sub, z_band, lanes)
    out_tp = pgm.pg_devroye(sub, z_band, lanes)
    torch.cuda.synchronize()
    check(torch.equal(out_t, out_k[:, lanes]),
          'lane table: the kernel differs from the full-width draw')
    rel_t = ((out_t - out_tp).abs() / out_tp.abs()).cpu().numpy()
    mismatch_t = float((rel_t > 1e-5).mean())
    check(mismatch_t <= 1e-3, f'lane table: kernel against the plain '
                              f'sampler mismatch share {mismatch_t}')
    print(f'    lane table ({lanes.numel()} random lanes of {z.shape[1]}): '
          f'bit-identical to the full-width draw at those lanes; against '
          f'the plain sampler with the same table mismatch share '
          f'{mismatch_t:.3e}')
    # the kernel computes its inputs itself, so the draw is one launch and
    # the kernel's time without them is no longer separable: `ms` is the
    # whole draw
    pg_ms = time_ms(lambda: pg_devroye_cuda(sub, z), 50)
    pg_plain_ms = time_ms(lambda: pgm.pg_devroye(sub, z), 5)
    lane_rounds = [0]

    def counting(k, idx):
        lane_rounds[0] += idx.numel()
        return rng.pg_uniforms(sub, k, z.shape[-1], lanes=idx)

    pgm._rejection(*pgm.pg_inputs(z), counting)
    pg_bytes = z.numel() * 2 * 4 + sub.numel() * 8
    pg_ops = lane_rounds[0] * PG_OPS_PER_ROUND + z.numel() * PG_OPS_INPUTS
    pg_bound = max(pg_bytes / PEAK_BYTES, pg_ops / PEAK_F32) * 1e3
    print(f'    draw (one launch, inputs in the kernel) {pg_ms:.4f} ms, plain '
          f'{pg_plain_ms:.4f} ms, lane-rounds {lane_rounds[0]}, bound '
          f'{pg_bound:.5f} ms')
    done(t0)
    t0 = phase('3b Threefry draw-plan kernel against the torch-op plan, '
               'the headline problem\'s step plan')
    plan_head = threefry_plan_times(dev, s, CHAINS)
    done(t0)

    t0 = phase('4 K3 eigenbasis CG kernel against the plain spectral CG')
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = s.n_beta + 3
    u_eig, s_eig = s.fixed['q_eigvecs'], s.fixed['q_eigvals']
    omega_b = out_k[:, :s.n].contiguous()
    rhs = torch.randn((CHAINS, rows, s.n), device=dev, generator=gen)
    warm = 0.1 * torch.randn((CHAINS, rows, s.n), device=dev, generator=gen)
    cg_err = 0.0
    for tau_v in (1.0, 1e4):
        tau = torch.full((CHAINS,), tau_v, device=dev)
        ks_, kp_, kr = icar_cg_solve_cuda(rhs, warm, omega_b, tau, u_eig,
                                          s_eig, 8, return_resid=True)
        ps_, pp_, pr = icar_cg_solve_spectral(rhs, warm, omega_b, tau, u_eig,
                                              s_eig, 8, return_resid=True)
        torch.cuda.synchronize()
        e_site = float((ks_ - ps_).abs().max() / ps_.abs().max())
        e_spec = float((kp_ - pp_).abs().max() / pp_.abs().max())
        # converged: a relative residual below 1e-6 is float32 rounding of
        # the recursively updated residual (at tau=1e4 both read ~1e-15),
        # so this compares with an absolute floor; the starved solves
        # below compare residuals with none
        e_rel = float(((kr - pr).abs() / (pr.abs() + 1e-3)).max())
        cg_err = max(cg_err, float((ks_ - ps_).abs().max()),
                     float((kp_ - pp_).abs().max()))
        print(f'    tau={tau_v:g}: x_site {e_site:.2e}, x_spec {e_spec:.2e} '
              f'(of max |x|), rel {e_rel:.2e} (relative), '
              f'rel max {float(pr.max()):.3e}')
        check(e_site <= 1e-4 and e_spec <= 1e-4, f'CG x differs tau={tau_v}')
        check(e_rel <= 1e-3, f'CG residual differs tau={tau_v}')
    zero = torch.zeros_like(warm)
    for tau_v, iters in ((1.0, 1), (1.0, 2), (1e4, 1)):
        # cut short from a zero start: residuals of 1e-3 to 1e-1, which
        # must agree to 1e-3 of themselves
        tau = torch.full((CHAINS,), tau_v, device=dev)
        ks_, kp_, kr = icar_cg_solve_cuda(rhs, zero, omega_b, tau, u_eig,
                                          s_eig, iters, return_resid=True)
        ps_, pp_, pr = icar_cg_solve_spectral(rhs, zero, omega_b, tau, u_eig,
                                              s_eig, iters, return_resid=True)
        torch.cuda.synchronize()
        e_site = float((ks_ - ps_).abs().max() / ps_.abs().max())
        e_spec = float((kp_ - pp_).abs().max() / pp_.abs().max())
        e_rel = float(((kr - pr).abs() / pr).max())
        cg_err = max(cg_err, float((ks_ - ps_).abs().max()),
                     float((kp_ - pp_).abs().max()))
        print(f'    starved tau={tau_v:g} iters={iters}: x_site {e_site:.2e}, '
              f'x_spec {e_spec:.2e}, rel {e_rel:.2e} (relative), rel in '
              f'[{float(pr.min()):.3e}, {float(pr.max()):.3e}]')
        check(float(pr.min()) >= 1e-3,
              f'starved solve converged tau={tau_v} iters={iters}')
        check(e_site <= 1e-4 and e_spec <= 1e-4,
              f'starved CG x differs tau={tau_v} iters={iters}')
        check(e_rel <= 1e-3, f'starved CG residual differs tau={tau_v} '
                             f'iters={iters}')
    # shapes off the tile grid: chain and row counts, n not a multiple of
    # 48 (500) or of 4 (333, through operands and vectors padded to a row
    # stride of 336), any orthogonal U;
    # each converged (8 iterations, warm) and cut short from a zero start
    # (1 and 2 iterations), where the residual is far from rounding (above
    # 1e-4; a converged one reads 1e-7) and is held to 1e-3 of itself with
    # no floor
    shape_err, starved_err, starved_min = 0.0, 0.0, math.inf
    for n_t in (s.n, 500, 333):
        if n_t == s.n:
            u_t, s_t = u_eig, s_eig
        else:
            u_t = torch.linalg.qr(torch.randn((n_t, n_t), device=dev,
                                              generator=gen))[0].contiguous()
            s_t = 8.0 * torch.rand(n_t, device=dev, generator=gen)
            s_t[0] = 0.0
        for ch in (1, 3, 64, 200):
            for rw in (2, 6, 8):
                a = (
                    torch.randn((ch, rw, n_t), device=dev, generator=gen),
                    0.1 * torch.randn((ch, rw, n_t), device=dev,
                                      generator=gen),
                    0.05 + 0.25 * torch.rand((ch, n_t), device=dev,
                                             generator=gen),
                    0.5 + torch.rand(ch, device=dev, generator=gen),
                    u_t, s_t, 8,
                )
                got = icar_cg_solve_cuda(*a, return_resid=True)
                want = icar_cg_solve_spectral(*a, return_resid=True)
                torch.cuda.synchronize()
                for g, w in zip(got[:2], want[:2]):
                    e = float((g - w).abs().max() / w.abs().max())
                    shape_err = max(shape_err, e)
                    check(e <= 1e-4, f'CG x differs at chains={ch} '
                                     f'rows={rw} n={n_t}: {e:.2e}')
                e = float(((got[2] - want[2]).abs()
                           / (want[2].abs() + 1e-3)).max())
                check(e <= 1e-3, f'CG residual differs at chains={ch} '
                                 f'rows={rw} n={n_t}: {e:.2e}')
                for iters in (1, 2):
                    b = (a[0], torch.zeros_like(a[1]), *a[2:6], iters)
                    got = icar_cg_solve_cuda(*b, return_resid=True)
                    want = icar_cg_solve_spectral(*b, return_resid=True)
                    torch.cuda.synchronize()
                    at = f'chains={ch} rows={rw} n={n_t} iters={iters}'
                    for g, w in zip(got[:2], want[:2]):
                        e = float((g - w).abs().max() / w.abs().max())
                        shape_err = max(shape_err, e)
                        check(e <= 1e-4, f'starved CG x differs at {at}: '
                                         f'{e:.2e}')
                    starved_min = min(starved_min, float(want[2].min()))
                    check(float(want[2].min()) >= 1e-4,
                          f'starved solve converged at {at}')
                    e = float(((got[2] - want[2]).abs() / want[2]).max())
                    starved_err = max(starved_err, e)
                    check(e <= 1e-3, f'starved CG residual differs at {at}: '
                                     f'{e:.2e}')
    print(f'    36 shapes (chains 1/3/64/200 x rows 2/6/8 x n '
          f'{s.n}/500/333), each converged and starved (1, 2 iterations): '
          f'worst x error {shape_err:.2e} of max |x|, worst starved '
          f'residual error {starved_err:.2e} of itself (least starved '
          f'residual {starved_min:.3e})')
    # one launch is one result: twice the same bits; and a chain's outputs
    # depend on that chain alone, whatever the others hold and however
    # many there are
    tau = 0.5 + torch.rand(CHAINS, device=dev, generator=gen)
    full = icar_cg_solve_cuda(rhs, warm, omega_b, tau, u_eig, s_eig, 8,
                              return_resid=True)
    again = icar_cg_solve_cuda(rhs, warm, omega_b, tau, u_eig, s_eig, 8,
                               return_resid=True)
    check(all(torch.equal(a, b) for a, b in zip(full, again)),
          'two CG launches differ')
    keep = slice(5, 8)
    few = icar_cg_solve_cuda(rhs[keep], warm[keep], omega_b[keep], tau[keep],
                             u_eig, s_eig, 8, return_resid=True)
    check(all(torch.equal(a[keep], b) for a, b in zip(full, few)),
          'a chain depends on the chain count')
    other = [t.clone() for t in (rhs, warm, omega_b, tau)]
    for t in other:
        fresh = torch.rand(t.shape, device=dev, generator=gen) + 0.05
        fresh[keep] = t[keep]
        t.copy_(fresh)
    mixed = icar_cg_solve_cuda(*other, u_eig, s_eig, 8, return_resid=True)
    check(all(torch.equal(a[keep], b[keep]) for a, b in zip(full, mixed)),
          'a chain depends on the other chains')
    check(not torch.equal(full[0][:5], mixed[0][:5]),
          'the other chains did not change')
    # the operands prepared once, as a 'pallas' sampler keeps them, give
    # the bits of the call that prepares its own
    ops = k3_operands(u_eig)
    given = icar_cg_solve_cuda(rhs, warm, omega_b, tau, u_eig, s_eig, 8,
                               return_resid=True, operands=ops)
    check(all(torch.equal(a, b) for a, b in zip(full, given)),
          'prepared operands change the CG bits')
    print('    two launches bit-identical; chains 5-7 bit-identical alone '
          '(3 chains) and among 61 other chains; prepared operands give '
          'the same bits')
    tau = torch.full((CHAINS,), 1.0, device=dev)

    def k3(iters, *a):
        a = a or (rhs, warm, omega_b, tau, u_eig, s_eig)
        o = ops if a[4] is u_eig else k3_operands(a[4])
        return lambda: icar_cg_solve_cuda(*a, iters, return_resid=True,
                                          operands=o)

    # the sampler's call (operands prepared once), timed from the host as
    # the kernel table's earlier times were, and replayed from a captured
    # graph as the captured step runs it, with no iteration and with 8:
    # their difference is 8 iterations of 2 products each (an iters=0
    # call costs the host about as long as the card, so only the graph
    # times it)
    cg_ms = time_ms(k3(8), 20)
    cg_graph_ms = graph_ms(k3(8))
    cg_ms0 = graph_ms(k3(0))
    cg_plain_ms = time_ms(lambda: icar_cg_solve_spectral(
        rhs, warm, omega_b, tau, u_eig, s_eig, 8, return_resid=True), 20)
    iter_ms = (cg_graph_ms - cg_ms0) / 8
    product_ms = iter_ms / 2
    # yardstick, never called by the port: one float32 torch.matmul of the
    # same (384, 1000) x (1000, 1000) product, TF32 off as resolve_device
    # sets it (cuBLAS SGEMM)
    check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 matmul is on')
    batch = rhs.reshape(-1, s.n)
    matmul_ms = time_ms(lambda: torch.matmul(batch, u_eig), 50)
    print(f'    iters=8 {cg_ms:.4f} ms from the host, {cg_graph_ms:.4f} ms '
          f'captured; iters=0 {cg_ms0:.4f} ms captured: {iter_ms:.5f} ms '
          f'an iteration, {product_ms:.5f} ms a product phase; float32 '
          f'torch.matmul (384, 1000) x (1000, 1000) {matmul_ms:.5f} ms '
          f'(yardstick, TF32 off)')
    n = s.n
    products = 2 * (8 + 1) + 2  # operator per iteration + start, rhs, out
    cg_ops = products * CHAINS * rows * n * n * 2
    cg_bytes = 4 * (n * n + n + 4 * CHAINS * rows * n + CHAINS * n
                    + 2 * CHAINS)
    # the kernel runs every float32 multiply-add as three TF32 tensor-core
    # operations, so bound_ms counts 3 x the operations at the TF32 tensor
    # rate, the unit the kernel uses; the same operations once at the
    # float32 non-tensor rate (a CUDA-core design's bound) are beside it
    cg_bound = max(cg_bytes / PEAK_BYTES, 3 * cg_ops / PEAK_TF32) * 1e3
    cg_bound_f32 = max(cg_bytes / PEAK_BYTES, cg_ops / PEAK_F32) * 1e3
    print(f'    kernel {cg_ms:.4f} ms, plain (torch-op CG) '
          f'{cg_plain_ms:.4f} ms, bound {cg_bound:.5f} ms (3 TF32 '
          f'operations per multiply-add at the tensor rate; '
          f'{cg_bound_f32:.5f} ms at the float32 non-tensor rate)')
    done(t0)
    if args.stop_after < 5:
        return

    t0 = phase(f'5 main path: LogitICARGibbs defaults, headline problem, '
               f'{MAIN_SIZE}/{MAIN_BURNIN} draws through the captured step')
    main = LogitICARGibbs(Q, W, X, y, random_state=HEAD['random_state'],
                          device=dev)
    check(main.solver == 'cg' and main.pg_method == 'pallas_packed'
          and main.cg_impl == 'xla' and not main._runs_eagerly(),
          'unexpected defaults')
    warm = warmup_steps()
    pg_devroye_cuda.counter.launches = 0
    icar_cg_solve_cuda.counter.launches = 0
    threefry_plan.counter.launches = 0
    torch.cuda.synchronize()
    ts = time.perf_counter()
    post = main.sample(MAIN_SIZE, burnin=MAIN_BURNIN, chains=CHAINS,
                       progressbar=False)
    torch.cuda.synchronize()
    main_sec = time.perf_counter() - ts
    pg_launches = pg_devroye_cuda.counter.launches
    plan_launches = threefry_plan.counter.launches
    runner = main._graph_runners[(CHAINS, ())]
    # K1 and the draw plan once a step: the warm-up step, then one a
    # replay; plus the cold-start solver check's K1 and the init's plan
    check(runner.per_replay == [1, 0, 1, 0, 0] and runner.length == MAIN_SIZE
          and runner.replays == MAIN_SIZE,
          f'main path graph: {runner.per_replay} recorded, length '
          f'{runner.length}, {runner.replays} replays')
    check(pg_launches == MAIN_SIZE + warm + 1,
          f'PG launches {pg_launches} != {MAIN_SIZE + warm + 1}')
    check(plan_launches == MAIN_SIZE + warm + init_plans(main),
          f'draw-plan launches {plan_launches} != '
          f'{MAIN_SIZE + warm + init_plans(main)}')
    for name in ('alpha', 'beta', 'tau'):
        arr = np.asarray(post[name])
        check(np.isfinite(arr).all(), f'non-finite {name} draws')
        check(arr.shape[:2] == (CHAINS, MAIN_SIZE - MAIN_BURNIN),
              f'{name} shape {arr.shape}')
    check(main.last_solver_resid <= main.solver_check_tol,
          f'solver residual {main.last_solver_resid}')
    ess = min_pooled_ess(post)
    print(f'    {kind} ({card}): {MAIN_SIZE / main_sec:.2f} it/s, '
          f'min pooled bulk-ESS {ess:.1f}, ESS/s {ess / main_sec:.2f}, '
          f'last_solver_resid {main.last_solver_resid:.3e}, '
          f'wall {main_sec:.2f} s (init, cold-start check, {warm} warm-up '
          f'step and the capture ({runner.capture_seconds:.3f} s) '
          f'included); K1 {pg_launches} launches by its counter on the '
          f'card, {runner.per_replay[0]} recorded in the graph, '
          f'{runner.replays} replays; draw plan {plan_launches} launches '
          f'by its counter, {runner.per_replay[2]} recorded')
    for name in ('alpha', 'beta', 'tau'):
        print(f'    {name} mean {np.asarray(post[name]).mean(axis=(0, 1))}')
    done(t0)

    t0 = phase("6 same problem with cg_impl='pallas' (CUDA CG kernel)")
    alt = LogitICARGibbs(Q, W, X, y, random_state=HEAD['random_state'] + 1,
                         device=dev, cg_impl='pallas')
    pg_devroye_cuda.counter.launches = 0
    icar_cg_solve_cuda.counter.launches = 0
    threefry_plan.counter.launches = 0
    torch.cuda.synchronize()
    ts = time.perf_counter()
    post_alt = alt.sample(ALT_SIZE, burnin=ALT_BURNIN, chains=CHAINS,
                          progressbar=False)
    torch.cuda.synchronize()
    alt_sec = time.perf_counter() - ts
    cg_launches = icar_cg_solve_cuda.counter.launches
    pg_launches_alt = pg_devroye_cuda.counter.launches
    plan_launches_alt = threefry_plan.counter.launches
    alt_runner = alt._graph_runners[(CHAINS, ())]
    check(alt_runner.per_replay == [1, 3, 1, 0, 0]
          and alt_runner.replays == ALT_SIZE,
          f'cg_impl=pallas graph: {alt_runner.per_replay} recorded, '
          f'{alt_runner.replays} replays')
    # three a step (one a sweep) in the warm-up and in every replay, and
    # the cold-start check's
    want = 3 * (ALT_SIZE + warm) + 1
    check(cg_launches == want, f'CG launches {cg_launches} != {want}')
    check(pg_launches_alt == ALT_SIZE + warm + 1, 'PG launches in phase 6')
    check(plan_launches_alt == ALT_SIZE + warm + init_plans(alt),
          f'draw-plan launches in phase 6: {plan_launches_alt}')
    for name in ('alpha', 'beta', 'tau'):
        check(np.isfinite(np.asarray(post_alt[name])).all(),
              f'non-finite {name} draws (pallas CG)')
    check(alt.last_solver_resid <= alt.solver_check_tol,
          f'solver residual {alt.last_solver_resid}')
    worst = mean_parity(post, post_alt)
    ess_alt = min_pooled_ess(post_alt)
    print(f'    {ALT_SIZE / alt_sec:.2f} it/s, min pooled bulk-ESS '
          f'{ess_alt:.1f}, ESS/s {ess_alt / alt_sec:.2f}, '
          f'last_solver_resid {alt.last_solver_resid:.3e}, worst mean '
          f'z-ratio vs phase 5 {worst:.3f}; K3 {cg_launches} launches by '
          f'its counter, {alt_runner.per_replay[1]} recorded in the graph, '
          f'{alt_runner.replays} replays; draw plan {plan_launches_alt} '
          f'launches')
    done(t0)

    if args.stop_after < 7:
        return
    counters = (pg_devroye_cuda.counter, icar_cg_solve_cuda.counter,
                threefry_plan.counter)
    # with the stencil PCG's: the phases that run a lattice solve
    counters4 = counters + (stencil_pcg_cuda.counter,)
    # with the collapsed RSR sweep's: every kernel (KERNEL_COUNTERS)
    counters5 = counters4 + (collapsed_rsr_cuda.counter,)
    kept = NEW_SIZE - NEW_BURNIN

    t0 = phase('7 LogitRSRGibbs, config 3 width (n = 1000, q = 100, '
               '64 chains)')
    rsr = LogitRSRGibbs(Q, W, X, y, random_state=HEAD['random_state'],
                        q=RSR_Q, device=dev)
    check(rsr.q_dim == RSR_Q and rsr.spatial_sweeps == 2
          and rsr.pg_method == 'pallas_packed' and not rsr._solves_lambda,
          'unexpected RSR defaults')
    post_rsr, rsr_sec, (rsr_pg_launches, rsr_cg_launches,
                        rsr_plan_launches) = run_timed(
        rsr, NEW_SIZE, NEW_BURNIN, CHAINS, counters)
    # one PG launch a step (warm-up and replays) and no other: no
    # cold-start solver check (the RSR eta draw never solves against
    # tau*Q + diag(omega))
    check(rsr_pg_launches == NEW_SIZE + warm,
          f'RSR PG launches {rsr_pg_launches} != {NEW_SIZE + warm}')
    check(rsr_cg_launches == 0 and not rsr._solver_checked,
          'RSR ran the ICAR solver')
    want = NEW_SIZE + warm + init_plans(rsr)
    check(rsr_plan_launches == want,
          f'RSR draw-plan launches {rsr_plan_launches} != {want}')
    check_posterior(post_rsr, CHAINS, kept, {'alpha': s.n_alpha,
                                             'beta': s.n_beta, 'tau': 0})
    check_state(rsr.final_carry)
    check(tuple(rsr.final_carry.states['eta'].shape) == (CHAINS, RSR_Q),
          'RSR eta shape')
    print(f'    PG launches {rsr_pg_launches} (one a step)')
    report(f'{kind} ({card})', post_rsr, NEW_SIZE, rsr_sec)
    done(t0)

    Q2, W2, X2, y2, *_ = make_lattice_dataset(
        LATTICE['rows'], LATTICE['cols'], ns=LATTICE['ns'],
        seed=LATTICE['seed'])

    t0 = phase('8 ProbitICARGibbs, config 2 width (10 x 10 lattice, '
               '1024 chains)')
    picar = ProbitICARGibbs(Q2, W2, X2, y2, random_state=LATTICE['seed'],
                            device=dev)
    check(picar.solver == 'spectral' and picar.spatial_sweeps == 6
          and picar.collapsed, 'unexpected probit ICAR defaults')
    post_picar, picar_sec, picar_launches = run_timed(
        picar, NEW_SIZE, NEW_BURNIN, PROBIT_ICAR_CHAINS, counters)
    want = [0, 0, NEW_SIZE + warm + init_plans(picar)]
    check(picar_launches == want,
          f'probit ICAR launches {picar_launches} != {want}')
    check_posterior(post_picar, PROBIT_ICAR_CHAINS, kept,
                    {'alpha': picar.n_alpha, 'beta': picar.n_beta, 'tau': 0})
    check_state(picar.final_carry)
    eta = picar.final_carry.states['eta']
    drift = float((eta.sum(dim=-1).abs() / (1.0 + eta.abs().amax(-1))).max())
    check(drift < 1e-4, f'eta off the sum-to-zero hyperplane: {drift:.2e}')
    print(f'    max |sum eta| / (1 + max |eta|) {drift:.2e}')
    report(f'{kind} ({card})', post_picar, NEW_SIZE, picar_sec)
    done(t0)

    t0 = phase('9 ProbitRSRGibbs, config 2b width (10 x 10 lattice, '
               '512 chains), both ladders')
    prsr, prsr_s = {}, {}
    for collapsed in (True, False):
        sampler = ProbitRSRGibbs(Q2, W2, X2, y2, random_state=LATTICE['seed'],
                                 collapsed=collapsed, device=dev)
        post_p, sec_p, launches_p = run_timed(
            sampler, NEW_SIZE, NEW_BURNIN, PROBIT_RSR_CHAINS,
            counters + (collapsed_rsr_cuda.counter,))
        # the collapsed ladder: the RSR kernel once a sweep a step
        want = [0, 0, NEW_SIZE + warm + init_plans(sampler),
                collapsed * sampler.spatial_sweeps * (NEW_SIZE + warm)]
        check(launches_p == want,
              f'probit RSR launches {launches_p} != {want}')
        check_posterior(post_p, PROBIT_RSR_CHAINS, kept,
                        {'alpha': sampler.n_alpha, 'beta': sampler.n_beta,
                         'tau': 0})
        check_state(sampler.final_carry)
        print(f'    collapsed={collapsed} (q = {sampler.q_dim}):')
        report(f'{kind} ({card})', post_p, NEW_SIZE, sec_p)
        prsr[collapsed], prsr_s[collapsed] = post_p, sampler
        if collapsed:
            rsr_launches = launches_p[3]
    worst_probit = mean_parity(prsr[True], prsr[False])
    print(f'    worst mean z-ratio, collapsed vs reference-ordered '
          f'{worst_probit:.3f}')
    rsr_times = collapsed_rsr_times(dev)
    done(t0)

    paths = {
        "logit 'cg' cg_impl='xla'": (main, CHAINS),
        "logit 'cg' cg_impl='pallas'": (alt, CHAINS),
        'logit RSR': (rsr, CHAINS),
        "probit 'spectral'": (picar, PROBIT_ICAR_CHAINS),
        'probit RSR collapsed': (prsr_s[True], PROBIT_RSR_CHAINS),
        'probit RSR reference-ordered': (prsr_s[False], PROBIT_RSR_CHAINS),
    }
    if args.stop_after < 10:
        return
    large_launches, large_paths, plan_large, solve_large = large_n_phases(
        dev, kind, card, counters4)
    paths.update(large_paths)
    if args.stop_after < 13:
        return
    par_pg, par_cg, par_plan = parallel_phase(dev, kind, card, counters,
                                              (Q, W, X, y), post_alt,
                                              alt_sec)
    if args.stop_after < 14:
        return
    graph_5g = sharded_phase(dev, card)
    if args.stop_after < 15:
        return
    # phases 15-19 run over four meshes whose ranks stay up from one run to
    # the next (a rank takes ~10 s to start on the card machine)
    meshes = two_d_meshes()
    with contextlib.ExitStack() as held:
        for mesh in {id(m): m for m in meshes.values()}.values():
            held.enter_context(mesh)
        two_d_pg, two_d_plan, lattice_2d = two_d_phase(
            dev, card, counters, meshes, 'stencil')
        if args.stop_after < 16:
            return
        two_d_graph_pg, two_d_graph_plan, graph_2d = two_d_phase(
            dev, card, counters, meshes, 'graph', graph_5g)
        if args.stop_after < 17:
            return
        dense_pg, dense_cg, dense_plan, dense_2d = dense_2d_phase(
            dev, card, counters, meshes, (Q, W, X, y), (Q2, W2, X2, y2))
        if args.stop_after < 18:
            return
        graph_phase(dev, card, paths, (Q2, W2, X2, y2))
        if args.stop_after < 19:
            return
        # label: (sampler, chains, K1, K3, the draw plan and the stencil
        # PCG a step (a band solves its lattice in torch), the cold-start
        # check's K1 and K3, and its stencil PCG (the parent solves the
        # whole field) after the init's plans)
        regimes = {
            'logit stencil': (lattice_2d[LogitICARGibbs],
                              LARGE_CHAINS['stencil'], (1, 0, 1, 0, 0),
                              (1, 0), 1),
            'logit graph': (graph_2d[LogitICARGibbs], LARGE_CHAINS['graph'],
                            (1, 0, 1, 0, 0), (1, 0), 0),
            "logit 'cg' cg_impl='pallas'": (dense_2d['a'], CHAINS,
                                            (1, 3, 1, 0, 0), (1, 1), 0),
            'logit RSR': (dense_2d['d'], CHAINS, (1, 0, 1, 0, 0), (0, 0), 0),
            'probit stencil': (lattice_2d[ProbitICARGibbs],
                               LARGE_CHAINS['stencil'], (0, 0, 1, 0, 0),
                               (0, 0), 1),
        }
        regimes = {k: (s, c, step, cold + (init_plans(s), solve, 0))
                   for k, (s, c, step, cold, solve) in regimes.items()}
        nccl_pg, nccl_cg, nccl_plan, *_ = nccl_graph_phase(
            dev, card, counters5, meshes['nccl'], regimes)

    t0 = phase('20 report')
    # no single PyTorch call computes either function (a fixed-round
    # rejection sampler; a fixed-iteration PCG), so library_ms is null
    common = {'route': 'cuda', 'library_ms': None}
    kernels.append(dict(
        common, name='pg_devroye (K1 _pg_kernel_grouped / K2 _pg_kernel)',
        source='occuspytial_tpu_torch/csrc/pg_devroye.cu',
        replaces='occuspytial_tpu/ops/pallas_pg.py:205 (K1), '
                 'occuspytial_tpu/ops/pallas_pg.py:191 (K2)',
        launches=pg_launches, replays=runner.replays,
        launches_per_replay=runner.per_replay[0],
        launches_logit_rsr=rsr_pg_launches,
        launches_logit_stencil=large_launches['stencil'][0],
        launches_logit_graph=large_launches['graph'][0],
        launches_parallel=par_pg, launches_2d=two_d_pg,
        launches_2d_graph=two_d_graph_pg, launches_2d_dense=dense_pg,
        launches_2d_captured=nccl_pg,
        max_abs_err=pg_err, mismatch_share=mismatch,
        ms=pg_ms, plain_ms=pg_plain_ms, bound_ms=pg_bound,
        bound_by='operations' if pg_ops / PEAK_F32 > pg_bytes / PEAK_BYTES
        else 'bytes',
    ))
    kernels.append(dict(
        common, name='icar_cg (K3 _cg_kernel)',
        source='occuspytial_tpu_torch/csrc/icar_cg.cu',
        replaces='occuspytial_tpu/ops/pallas_cg.py:56',
        launches=cg_launches, replays=alt_runner.replays,
        launches_per_replay=alt_runner.per_replay[1],
        launches_parallel=par_cg,
        launches_2d_dense=dense_cg, launches_2d_captured=nccl_cg,
        max_abs_err=cg_err,
        ms=cg_ms, ms_captured=cg_graph_ms, ms_iters0_captured=cg_ms0,
        iteration_ms=iter_ms,
        product_ms=product_ms, matmul_f32_product_ms=matmul_ms,
        plain_ms=cg_plain_ms, bound_ms=cg_bound,
        bound_ms_is='3 TF32 operations per multiply-add at the tensor rate',
        bound_float32_ms=cg_bound_f32,
        bound_by='operations'
        if 3 * cg_ops / PEAK_TF32 > cg_bytes / PEAK_BYTES else 'bytes',
    ))
    kernels.append(dict(
        common, name='threefry_plan (no TPU counterpart)',
        source='occuspytial_tpu_torch/csrc/pg_devroye.cu', replaces=None,
        launches=plan_launches, replays=runner.replays,
        launches_per_replay=runner.per_replay[2],
        launches_logit_rsr=rsr_plan_launches,
        launches_logit_stencil=large_launches['stencil'][1],
        launches_logit_graph=large_launches['graph'][1],
        launches_parallel=par_plan, launches_2d=two_d_plan[0],
        launches_2d_nccl=two_d_plan[1], launches_2d_graph=two_d_graph_plan[0],
        launches_2d_dense=dense_plan, launches_2d_captured=nccl_plan,
        headline=plan_head, lattice10k_stencil=plan_large,
    ))
    kernels.append(dict(
        common, name='collapsed_rsr (no TPU counterpart)',
        source='occuspytial_tpu_torch/csrc/collapsed_rsr.cu', replaces=None,
        launches_probit_rsr=rsr_launches, probit_rsr1k=rsr_times,
    ))
    kernels.append(dict(
        common, name='stencil_pcg (no TPU counterpart)',
        source='occuspytial_tpu_torch/csrc/stencil_pcg.cu', replaces=None,
        launches_logit_stencil=large_launches['stencil'][2],
        launches_logit_graph=large_launches['graph'][2],
        lattice10k_stencil=solve_large,
    ))
    done(t0)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count(),
    }}))


if __name__ == '__main__':
    main()
