#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``occuspytial_tpu_torch/csrc`` (nvcc,
sm_90a), holds each against its plain PyTorch version at the shapes of
the main path, runs ``LogitICARGibbs`` on the benchmark's headline
problem (n = 1000 sites, 64 chains) through both eta-solve
implementations, and prints one JSON line of per-kernel numbers and, last,
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

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor op/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

#: operations one Pólya-Gamma rejection round costs a lane: 5 Threefry
#: blocks (20 rounds x add/rotate/xor + 5 key injections, ~70 integer ops
#: each) plus ~100 float operations (about 12 transcendental calls and
#: the proposal arithmetic); counted at the float32 rate
PG_OPS_PER_ROUND = 5 * 70 + 100


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
    ap.add_argument('--stop-after', type=int, default=7)
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

    from occuspytial_tpu_torch import LogitICARGibbs, rng
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
    from occuspytial_tpu_torch.ops import cuda_pg

    keys32 = torch.where(sub >= 2 ** 31, sub - 2 ** 32, sub).to(torch.int32)
    prepared = [t.contiguous() for t in pgm.pg_inputs(z)]
    pg_ms = time_ms(lambda: cuda_pg.launch(keys32, *prepared), 50)
    pg_wrapper_ms = time_ms(lambda: pg_devroye_cuda(sub, z), 50)
    pg_plain_ms = time_ms(lambda: pgm.pg_devroye(sub, z), 5)
    lane_rounds = [0]

    def counting(k, idx):
        lane_rounds[0] += idx.numel()
        return rng.pg_uniforms(sub, k, z.shape[-1], lanes=idx)

    pgm._rejection(*pgm.pg_inputs(z), counting)
    pg_bytes = z.numel() * 4 * 4 + sub.numel() * 4
    pg_ops = lane_rounds[0] * PG_OPS_PER_ROUND
    pg_bound = max(pg_bytes / PEAK_BYTES, pg_ops / PEAK_F32) * 1e3
    print(f'    kernel {pg_ms:.4f} ms (with its torch-op inputs '
          f'{pg_wrapper_ms:.4f} ms), plain {pg_plain_ms:.4f} ms, '
          f'lane-rounds {lane_rounds[0]}, bound {pg_bound:.5f} ms')
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
    cg_bound = max(cg_bytes / PEAK_BYTES, cg_ops / PEAK_F32) * 1e3
    print(f'    kernel {cg_ms:.4f} ms, plain (torch-op CG) '
          f'{cg_plain_ms:.4f} ms, bound {cg_bound:.5f} ms')
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

    t0 = phase('7 report')
    # no single PyTorch call computes either function (a fixed-round
    # rejection sampler; a fixed-iteration PCG), so library_ms is null
    common = {'route': 'cuda', 'library_ms': None}
    kernels.append(dict(
        common, name='pg_devroye (K1 _pg_kernel_grouped / K2 _pg_kernel)',
        source='occuspytial_tpu_torch/csrc/pg_devroye.cu',
        replaces='occuspytial_tpu/ops/pallas_pg.py:205 (K1), '
                 'occuspytial_tpu/ops/pallas_pg.py:191 (K2)',
        launches=pg_launches, max_abs_err=pg_err, mismatch_share=mismatch,
        ms=pg_ms, wrapper_ms=pg_wrapper_ms, plain_ms=pg_plain_ms,
        bound_ms=pg_bound,
        bound_by='operations' if pg_ops / PEAK_F32 > pg_bytes / PEAK_BYTES
        else 'bytes',
    ))
    kernels.append(dict(
        common, name='icar_cg (K3 _cg_kernel)',
        source='occuspytial_tpu_torch/csrc/icar_cg.cu',
        replaces='occuspytial_tpu/ops/pallas_cg.py:56',
        launches=cg_launches, max_abs_err=cg_err, ms=cg_ms,
        plain_ms=cg_plain_ms, bound_ms=cg_bound,
        bound_by='operations' if cg_ops / PEAK_F32 > cg_bytes / PEAK_BYTES
        else 'bytes',
    ))
    done(t0)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count(),
    }}))


if __name__ == '__main__':
    main()
