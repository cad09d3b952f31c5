#!/usr/bin/env python3
"""Chain throughput of ``sample_parallel`` on one card against one process.

Runs ``LogitICARGibbs`` (``cg_impl='pallas'``) on the benchmark's headline
problem (n = 1000 sites) in one process and over 1, 2 and 4 worker
processes on ``cuda:0``, at a fixed total chain count and at a fixed
chain count per worker. Each configuration runs twice, ``--short`` and
``--long`` steps; the difference gives the steady ms a step (a fresh
worker's first steps load kernels and libraries), and the rest the cold
cost. Printed per configuration: the wall of the long call (worker
start-up included), the steady ms a step, it/s and chain-steps per
second, and the cold seconds. Run from the repository root on a CUDA
machine:

    python3 scripts/torch_parallel_scaling.py [--short 32] [--long 160]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HEAD = dict(n=1000, ns=500, p=3, q=3, min_v=2, max_v=10, random_state=7)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--short', type=int, default=32)
    ap.add_argument('--long', type=int, default=160)
    args = ap.parse_args()

    import torch

    from occuspytial_tpu_torch import LogitICARGibbs
    from occuspytial_tpu_torch.parallel import sample_parallel
    from occuspytial_tpu_torch.utils import make_data

    if not torch.cuda.is_available():
        raise SystemExit('CUDA is not available')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f'{card}; {os.cpu_count()} host cores; {args.short} and '
          f'{args.long} steps a configuration')
    Q, W, X, y, *_ = make_data(**HEAD)

    def make():
        return LogitICARGibbs(Q, W, X, y, random_state=8, cg_impl='pallas')

    def in_process(chains, steps):
        s = make()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        s.sample(steps, chains=chains, progressbar=False)
        torch.cuda.synchronize()
        sec = time.perf_counter() - ts
        return sec, sec

    def workers(n, chains, steps):
        s = make()
        ts = time.perf_counter()
        sample_parallel(s, steps, chains=chains, mesh=['cuda:0'] * n)
        return time.perf_counter() - ts, max(s.worker_seconds)

    in_process(64, 4)  # the parent's own first steps
    runs = [('one process', 1, c, in_process) for c in (64, 128, 256)]
    runs += [(f'{n} worker(s) on cuda:0', n, c, workers)
             for n, c in ((1, 64), (2, 64), (4, 64), (2, 128), (4, 256))]
    for label, n, chains, run in runs:
        args_ = (chains,) if run is in_process else (n, chains)
        _, short = run(*args_, args.short)
        wall, long = run(*args_, args.long)
        step = (long - short) / (args.long - args.short)
        print(f'{label:>24}: {chains:4d} chains, wall {wall:7.2f} s, '
              f'steady {1e3 * step:7.2f} ms a step, {1 / step:7.2f} it/s, '
              f'{chains / step:9.1f} chain-steps/s, cold '
              f'{short - args.short * step:6.2f} s', flush=True)


if __name__ == '__main__':
    main()
