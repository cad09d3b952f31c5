#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``occuspytial_tpu_torch/csrc`` (nvcc,
sm_90a), holds each against its plain PyTorch version at the shapes of
the main path, runs ``LogitICARGibbs`` on the benchmark's headline
problem (n = 1000 sites, 64 chains) through both eta-solve
implementations, then ``LogitRSRGibbs`` (n = 1000, q = 100, 64 chains)
and the two probit samplers on the 10 x 10 lattice (1024 and 512
chains), and prints one JSON line of per-kernel numbers and, last,
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero without that line; it also fails without CUDA.
``--stop-after N`` ends after phase N (a quick build-and-check run).
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--stop-after', type=int, default=10)
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

    t0 = phase('10 report')
    # no single PyTorch call computes either function (a fixed-round
    # rejection sampler; a fixed-iteration PCG), so library_ms is null
    common = {'route': 'cuda', 'library_ms': None}
    kernels.append(dict(
        common, name='pg_devroye (K1 _pg_kernel_grouped / K2 _pg_kernel)',
        source='occuspytial_tpu_torch/csrc/pg_devroye.cu',
        replaces='occuspytial_tpu/ops/pallas_pg.py:205 (K1), '
                 'occuspytial_tpu/ops/pallas_pg.py:191 (K2)',
        launches=pg_launches, launches_logit_rsr=rsr_pg_launches,
        max_abs_err=pg_err, mismatch_share=mismatch,
        ms=pg_ms, plain_ms=pg_plain_ms, bound_ms=pg_bound,
        bound_by='operations' if pg_ops / PEAK_F32 > pg_bytes / PEAK_BYTES
        else 'bytes',
    ))
    kernels.append(dict(
        common, name='icar_cg (K3 _cg_kernel)',
        source='occuspytial_tpu_torch/csrc/icar_cg.cu',
        replaces='occuspytial_tpu/ops/pallas_cg.py:56',
        launches=cg_launches, max_abs_err=cg_err, ms=cg_ms,
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
