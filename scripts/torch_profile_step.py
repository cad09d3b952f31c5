#!/usr/bin/env python3
"""Where the port's Gibbs step spends its time on the CUDA card.

Runs one sampler at its defaults on the card, warms up, then traces
``--steps`` steps with ``torch.profiler`` and prints, per step: wall
time, device busy time (union of kernel intervals), the device's idle
share, launch calls from the host (kernel launches and CUDA graph
launches), kernels run on the device, host-device synchronisations, and
the kernels that take most device time. The steps run as the sampler
runs them on the card, as replays of its captured step (``_run``: one
graph launch a step); ``--eager`` runs the host loop (``_run_eager``:
every kernel of a step launched from Python) instead. ``--trace PATH``
also writes the Chrome trace. ``--model`` picks the problem, each at the
width of a JAX bench configuration (bench.py):

- ``logit_icar`` (default): ``LogitICARGibbs``, headline problem (config
  4: n = 1000, 64 chains), with ``--cg-impl``;
- ``logit_rsr``: ``LogitRSRGibbs``, the same data, q = 100, 64 chains
  (config 3);
- ``probit_icar``: ``ProbitICARGibbs``, 10 x 10 lattice, 1024 chains
  (config 2);
- ``probit_rsr``: ``ProbitRSRGibbs``, the same lattice, 512 chains
  (config 2b);
- ``logit_stencil`` / ``logit_graph``: ``LogitICARGibbs`` with
  ``lattice=(100, 100, 8)`` (32 chains, config 5) or ``solver='graph'``
  on the same Q as a sparse matrix (64 chains, config 5g), 10,000 sites;
- ``probit_stencil`` / ``probit_graph``: ``ProbitICARGibbs`` on the same
  problem, 32 chains.

    python3 scripts/torch_profile_step.py [--model logit_icar] [--steps 20]
        [--eager]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--warmup', type=int, default=10)
    ap.add_argument('--model', default='logit_icar', choices=(
        'logit_icar', 'logit_rsr', 'probit_icar', 'probit_rsr',
        'logit_stencil', 'logit_graph', 'probit_stencil', 'probit_graph'))
    ap.add_argument('--chains', type=int, default=None,
                    help='default: the configuration\'s chain count')
    ap.add_argument('--cg-impl', default='xla', choices=('xla', 'pallas'))
    ap.add_argument('--trace', default=None, help='Chrome trace output')
    ap.add_argument('--eager', action='store_true',
                    help='the host loop instead of the captured step')
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (
        LARGE,
        LARGE_CHAINS,
        PROBIT_LARGE_CHAINS,
        make_lattice_dataset,
    )
    from occuspytial_tpu_torch import (
        LogitICARGibbs,
        LogitRSRGibbs,
        ProbitICARGibbs,
        ProbitRSRGibbs,
    )
    from occuspytial_tpu_torch.utils import make_data

    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip())
    regime = args.model.split('_')[1]
    if regime in ('stencil', 'graph'):
        import scipy.sparse as sps

        Q, W, X, y, *_ = make_lattice_dataset(
            LARGE['rows'], LARGE['cols'], ns=LARGE['ns'], seed=LARGE['seed'],
            min_v=LARGE['min_v'], max_v=LARGE['max_v'])
        kw = (dict(lattice=(LARGE['rows'], LARGE['cols'], 8))
              if regime == 'stencil' else dict(solver='graph'))
        q_in = sps.csr_matrix(Q) if regime == 'graph' else Q
        cls = LogitICARGibbs if args.model.startswith('logit') \
            else ProbitICARGibbs
        s = cls(q_in, W, X, y, random_state=LARGE['seed'], **kw)
        chains = (LARGE_CHAINS[regime] if cls is LogitICARGibbs
                  else PROBIT_LARGE_CHAINS)
    elif args.model.startswith('logit'):
        Q, W, X, y, *_ = make_data(n=1000, ns=500, p=3, q=3, min_v=2,
                                   max_v=10, random_state=7)
        if args.model == 'logit_icar':
            s = LogitICARGibbs(Q, W, X, y, random_state=7,
                               cg_impl=args.cg_impl)
        else:
            s = LogitRSRGibbs(Q, W, X, y, random_state=7, q=100)
        chains = 64
    else:
        Q, W, X, y, *_ = make_lattice_dataset(10, 10, ns=50, seed=3)
        if args.model == 'probit_icar':
            s, chains = ProbitICARGibbs(Q, W, X, y, random_state=3), 1024
        else:
            s, chains = ProbitRSRGibbs(Q, W, X, y, random_state=3), 512
    chains = args.chains or chains
    # one capture (at the warm-up) serves every run below
    s.scan_chunk = max(args.warmup, args.steps)
    run = s._run_eager if args.eager else s._run
    carry = s.init_carry(chains)
    carry, _ = run(carry, args.warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = run(carry, args.steps)
    torch.cuda.synchronize()
    print(f'wall per step without the profiler '
          f'{(time.perf_counter() - t0) * 1e3 / args.steps:.3f} ms')
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, _ = run(carry, args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    # the device's mirrors of host ranges (the runner's occuspytial.*
    # spans) are annotations, not device work
    kernels = [e for e in events if e.device_type.name == 'CUDA'
               and not e.is_user_annotation]
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels])
    launches = sum(1 for e in events if e.name in (
        'cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
        'cuLaunchKernelEx', 'cudaLaunchCooperativeKernel', 'cudaGraphLaunch',
        'cuGraphLaunch'))
    ran = sum(1 for e in kernels
              if not e.name.startswith(('Memcpy', 'Memset')))
    syncs = sum(1 for e in events if e.name in (
        'cudaStreamSynchronize', 'cudaDeviceSynchronize',
        'cudaEventSynchronize'))
    memcpy = sum(1 for e in events if e.name.startswith('cudaMemcpy'))
    per = 1.0 / args.steps  # event times are in microseconds
    print(f'model={args.model} cg_impl={args.cg_impl} chains={chains} '
          f'steps={args.steps} runner='
          f'{"eager" if args.eager or s._runs_eagerly() else "graph"}')
    print(f'wall per step {wall * 1e3 * per:.3f} ms, device busy per step '
          f'{busy / 1e3 * per:.3f} ms, idle share '
          f'{1.0 - busy / 1e6 / wall:.3f}')
    print(f'per step: {launches / args.steps:.1f} launches from the host, '
          f'{ran / args.steps:.1f} kernels on the device, '
          f'{syncs / args.steps:.2f} synchronisations, '
          f'{memcpy / args.steps:.2f} memcpy calls')
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print('top kernels by device time per step (ms, launches):')
    for name, (us, count) in top:
        print(f'  {us / 1e3 * per:8.4f} {count / args.steps:7.1f}  '
              f'{name[:100]}')
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == '__main__':
    main()
