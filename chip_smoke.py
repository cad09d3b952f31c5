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
processes) and the site-sharded lattice and graph solves over
``torch.distributed`` worlds (gloo ranks on one card, NCCL one rank per
card), and prints one JSON line of per-kernel numbers and, last,
``{"ok": true, "device": {...}}``. Any failed check raises, so the script exits non-zero
without that line; it also fails without CUDA. ``--stop-after N`` ends
after phase N (a quick build-and-check run).
"""

import argparse
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
MAIN_SIZE, MAIN_BURNIN = 1024, 256
CG_SIZE, CG_BURNIN = 512, 128
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
    ``cg_impl='pallas'`` and phase 6's seed. Returns the K1 and K3
    launches of the full-width two-worker run."""
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
    pg_n, cg_n = (c.launches for c in counters)
    # the parent's cold-start check launches each kernel once; each
    # worker then launches K1 once a step and K3 three times a step
    check(pg_n == 1 + 2 * CG_SIZE,
          f'parallel K1 launches {pg_n} != {1 + 2 * CG_SIZE}')
    check(cg_n == 1 + 2 * 3 * CG_SIZE,
          f'parallel K3 launches {cg_n} != {1 + 2 * 3 * CG_SIZE}')
    check_posterior(post, CHAINS, CG_SIZE - CG_BURNIN,
                    {'alpha': s.n_alpha, 'beta': s.n_beta, 'tau': 0})
    check_state(s.final_carry)
    check(s.last_solver_resid <= s.solver_check_tol,
          f'parallel solver residual {s.last_solver_resid}')
    worst = mean_parity(post_6, post)
    ess = min_pooled_ess(post)
    busy = max(s.worker_seconds)
    print(f'    (c) 2 workers on cuda:0, {CHAINS} chains ({CHAINS // 2} '
          f'each), {CG_SIZE}/{CG_BURNIN} draws: K1 {pg_n}, K3 {cg_n} '
          f'launches, last_solver_resid {s.last_solver_resid:.3e}, worst '
          f'mean z-ratio vs phase 6 {worst:.3f}')
    print(f'    {kind} ({card}): {CG_SIZE / wall:.2f} it/s over the whole '
          f'call ({wall:.2f} s, worker start-up included), '
          f'{CG_SIZE / busy:.2f} it/s over the workers\' sampling '
          f'({", ".join(f"{x:.2f}" for x in s.worker_seconds)} s), min '
          f'pooled bulk-ESS {ess:.1f}, ESS/s {ess / wall:.2f}')
    print(f'    phase 6 in one process ({card}): {CG_SIZE / sec_6:.2f} it/s')
    done(t0)
    return pg_n, cg_n


def sharded_phase(dev, card):
    """Phase 14: the site-sharded stencil and graph solves at config 5's
    width over gloo ranks on one card and an NCCL world of one rank per
    card, against the single-device operators and a float64 host solve."""
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
        tb = time.perf_counter()
        gspec, arrs = graph.build(q5, deflate=GRAPH_RANK, block=GRAPH_BLOCK)
        print(f'    graph build (block {GRAPH_BLOCK}, rank {GRAPH_RANK}) '
              f'{time.perf_counter() - tb:.2f} s: {gspec}')
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


def large_n_phases(dev, kind, card, counters):
    """Phases 10-12: both ICAR samplers' matrix-free eta regimes on the
    10,000-site lattice of bench.py configs 5 and 5g. Returns K1's
    launches on the stencil and graph logit paths."""
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
        post, sec, (pg_n, cg_n) = run_timed(s, LARGE_SIZE, LARGE_BURNIN,
                                            chains, counters)
        # one PG launch a step plus the cold-start check's; no K3
        check(pg_n == LARGE_SIZE + 1,
              f'{regime} PG launches {pg_n} != {LARGE_SIZE + 1}')
        check(cg_n == 0, f'{regime} launched the K3 CG')
        check_posterior(post, chains, LARGE_SIZE - LARGE_BURNIN, dims)
        check_state(s.final_carry)
        check(s.last_solver_resid < 0.2,
              f'{regime} residual {s.last_solver_resid}')
        drift = plane_drift(s.final_carry.states['eta'])
        check(drift < 1e-4, f'{regime} eta off the hyperplane: {drift:.2e}')
        print(f'    PG launches {pg_n}, last_solver_resid '
              f'{s.last_solver_resid:.3e}, |sum eta| / sum |eta| '
              f'{drift:.2e}')
        report(f'{kind} ({card})', post, LARGE_SIZE, sec)
        posts[regime], launches[regime], samplers[regime] = post, pg_n, s
        return t0

    done(logit('stencil', '10 LogitICARGibbs stencil, config 5 (100 x 100 '
                          'lattice, 32 chains)'))
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
        check(n_launch == [0, 0], 'the probit path launched a kernel')
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
    worst = mean_parity(probit['stencil'], probit['graph'])
    print(f'    worst mean z-ratio, stencil vs graph {worst:.3f}')
    done(t0)
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--stop-after', type=int, default=15)
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
    from occuspytial_tpu_torch.ops.cuda_cg import icar_cg_solve_cuda
    from occuspytial_tpu_torch.ops.cuda_pg import pg_devroye_cuda
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
        before = pg_devroye_cuda.launches
        check(torch.equal(s._pg(sub, z), out_k), f'{method} differs')
        check(pg_devroye_cuda.launches == before + 1, f'{method} no launch')
    s.pg_method = 'pallas_packed'
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
    # 64 (500) or of 4 (333, staged by 4-byte copies), any orthogonal U;
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
    print('    two launches bit-identical; chains 5-7 bit-identical alone '
          '(3 chains) and among 61 other chains')
    tau = torch.full((CHAINS,), 1.0, device=dev)
    cg_ms = time_ms(lambda: icar_cg_solve_cuda(
        rhs, warm, omega_b, tau, u_eig, s_eig, 8, return_resid=True), 20)
    cg_plain_ms = time_ms(lambda: icar_cg_solve_spectral(
        rhs, warm, omega_b, tau, u_eig, s_eig, 8, return_resid=True), 20)
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

    t0 = phase('5 main path: LogitICARGibbs defaults, headline problem')
    main = LogitICARGibbs(Q, W, X, y, random_state=HEAD['random_state'],
                          device=dev)
    check(main.solver == 'cg' and main.pg_method == 'pallas_packed'
          and main.cg_impl == 'xla', 'unexpected defaults')
    pg_devroye_cuda.launches = 0
    icar_cg_solve_cuda.launches = 0
    torch.cuda.synchronize()
    ts = time.perf_counter()
    post = main.sample(MAIN_SIZE, burnin=MAIN_BURNIN, chains=CHAINS,
                       progressbar=False)
    torch.cuda.synchronize()
    main_sec = time.perf_counter() - ts
    pg_launches = pg_devroye_cuda.launches
    check(pg_launches == MAIN_SIZE + 1,
          f'PG launches {pg_launches} != {MAIN_SIZE + 1}')
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
          f'wall {main_sec:.2f} s')
    for name in ('alpha', 'beta', 'tau'):
        print(f'    {name} mean {np.asarray(post[name]).mean(axis=(0, 1))}')
    done(t0)

    t0 = phase("6 same problem with cg_impl='pallas' (CUDA CG kernel)")
    alt = LogitICARGibbs(Q, W, X, y, random_state=HEAD['random_state'] + 1,
                         device=dev, cg_impl='pallas')
    pg_devroye_cuda.launches = 0
    icar_cg_solve_cuda.launches = 0
    torch.cuda.synchronize()
    ts = time.perf_counter()
    post_alt = alt.sample(CG_SIZE, burnin=CG_BURNIN, chains=CHAINS,
                          progressbar=False)
    torch.cuda.synchronize()
    alt_sec = time.perf_counter() - ts
    cg_launches = icar_cg_solve_cuda.launches
    pg_launches_alt = pg_devroye_cuda.launches
    check(cg_launches == 3 * CG_SIZE + 1,
          f'CG launches {cg_launches} != {3 * CG_SIZE + 1}')
    check(pg_launches_alt == CG_SIZE + 1, 'PG launches in phase 6')
    for name in ('alpha', 'beta', 'tau'):
        check(np.isfinite(np.asarray(post_alt[name])).all(),
              f'non-finite {name} draws (pallas CG)')
    check(alt.last_solver_resid <= alt.solver_check_tol,
          f'solver residual {alt.last_solver_resid}')
    worst = mean_parity(post, post_alt)
    ess_alt = min_pooled_ess(post_alt)
    print(f'    {CG_SIZE / alt_sec:.2f} it/s, min pooled bulk-ESS '
          f'{ess_alt:.1f}, ESS/s {ess_alt / alt_sec:.2f}, '
          f'last_solver_resid {alt.last_solver_resid:.3e}, worst mean '
          f'z-ratio vs phase 5 {worst:.3f}')
    done(t0)

    if args.stop_after < 7:
        return
    counters = (pg_devroye_cuda, icar_cg_solve_cuda)
    kept = NEW_SIZE - NEW_BURNIN

    t0 = phase('7 LogitRSRGibbs, config 3 width (n = 1000, q = 100, '
               '64 chains)')
    rsr = LogitRSRGibbs(Q, W, X, y, random_state=HEAD['random_state'],
                        q=RSR_Q, device=dev)
    check(rsr.q_dim == RSR_Q and rsr.spatial_sweeps == 2
          and rsr.pg_method == 'pallas_packed' and not rsr._solves_lambda,
          'unexpected RSR defaults')
    post_rsr, rsr_sec, (rsr_pg_launches, rsr_cg_launches) = run_timed(
        rsr, NEW_SIZE, NEW_BURNIN, CHAINS, counters)
    # one PG launch a step and no other: no cold-start solver check (the
    # RSR eta draw never solves against tau*Q + diag(omega))
    check(rsr_pg_launches == NEW_SIZE,
          f'RSR PG launches {rsr_pg_launches} != {NEW_SIZE}')
    check(rsr_cg_launches == 0 and not rsr._solver_checked,
          'RSR ran the ICAR solver')
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
    check(picar_launches == [0, 0], 'the probit path launched a kernel')
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
    prsr = {}
    for collapsed in (True, False):
        sampler = ProbitRSRGibbs(Q2, W2, X2, y2, random_state=LATTICE['seed'],
                                 collapsed=collapsed, device=dev)
        post_p, sec_p, launches_p = run_timed(
            sampler, NEW_SIZE, NEW_BURNIN, PROBIT_RSR_CHAINS, counters)
        check(launches_p == [0, 0], 'the probit path launched a kernel')
        check_posterior(post_p, PROBIT_RSR_CHAINS, kept,
                        {'alpha': sampler.n_alpha, 'beta': sampler.n_beta,
                         'tau': 0})
        check_state(sampler.final_carry)
        print(f'    collapsed={collapsed} (q = {sampler.q_dim}):')
        report(f'{kind} ({card})', post_p, NEW_SIZE, sec_p)
        prsr[collapsed] = post_p
    worst_probit = mean_parity(prsr[True], prsr[False])
    print(f'    worst mean z-ratio, collapsed vs reference-ordered '
          f'{worst_probit:.3f}')
    done(t0)

    if args.stop_after < 10:
        return
    large_launches = large_n_phases(dev, kind, card, counters)
    if args.stop_after < 13:
        return
    par_pg, par_cg = parallel_phase(dev, kind, card, counters, (Q, W, X, y),
                                    post_alt, alt_sec)
    if args.stop_after < 14:
        return
    sharded_phase(dev, card)

    t0 = phase('15 report')
    # no single PyTorch call computes either function (a fixed-round
    # rejection sampler; a fixed-iteration PCG), so library_ms is null
    common = {'route': 'cuda', 'library_ms': None}
    kernels.append(dict(
        common, name='pg_devroye (K1 _pg_kernel_grouped / K2 _pg_kernel)',
        source='occuspytial_tpu_torch/csrc/pg_devroye.cu',
        replaces='occuspytial_tpu/ops/pallas_pg.py:205 (K1), '
                 'occuspytial_tpu/ops/pallas_pg.py:191 (K2)',
        launches=pg_launches, launches_logit_rsr=rsr_pg_launches,
        launches_logit_stencil=large_launches['stencil'],
        launches_logit_graph=large_launches['graph'],
        launches_parallel=par_pg,
        max_abs_err=pg_err, mismatch_share=mismatch,
        ms=pg_ms, plain_ms=pg_plain_ms, bound_ms=pg_bound,
        bound_by='operations' if pg_ops / PEAK_F32 > pg_bytes / PEAK_BYTES
        else 'bytes',
    ))
    kernels.append(dict(
        common, name='icar_cg (K3 _cg_kernel)',
        source='occuspytial_tpu_torch/csrc/icar_cg.cu',
        replaces='occuspytial_tpu/ops/pallas_cg.py:56',
        launches=cg_launches, launches_parallel=par_cg, max_abs_err=cg_err,
        ms=cg_ms,
        plain_ms=cg_plain_ms, bound_ms=cg_bound,
        bound_ms_is='3 TF32 operations per multiply-add at the tensor rate',
        bound_float32_ms=cg_bound_f32,
        bound_by='operations'
        if 3 * cg_ops / PEAK_TF32 > cg_bytes / PEAK_BYTES else 'bytes',
    ))
    done(t0)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count(),
    }}))


if __name__ == '__main__':
    main()
