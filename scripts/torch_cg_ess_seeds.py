#!/usr/bin/env python3
"""Spread of the min pooled bulk-ESS over seeds, for both eta solves.

Runs ``LogitICARGibbs`` on the benchmark's headline problem (n = 1000, 64
chains) on the CUDA card once per seed and per ``cg_impl`` ('xla': the
torch-op CG, 'pallas': the CUDA CG kernel) and prints each run's min
pooled bulk-ESS over alpha, beta and tau, the parameter that sets it, the
last solver residual and it/s, then the range per ``cg_impl``. One reading
of the ESS of a few hundred draws is noisy; this shows how noisy, and so
whether a difference between the two solves is more than that.

    python3 scripts/torch_cg_ess_seeds.py [--seeds 7 8 9 10 11] [--size 512]
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def min_pooled_ess(post):
    """(min bulk-ESS, name of the component that has it) over alpha, beta
    and tau."""
    from occuspytial_tpu_torch import diagnostics as dg

    best = (np.inf, None)
    for name in ('alpha', 'beta', 'tau'):
        arr = np.asarray(post[name])
        cols = arr[..., None] if arr.ndim == 2 else arr
        for j in range(cols.shape[2]):
            ess = float(dg.ess_bulk(cols[:, :, j]))
            if ess < best[0]:
                best = (ess, f'{name}[{j}]')
    return best


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seeds', type=int, nargs='+',
                    default=[7, 8, 9, 10, 11])
    ap.add_argument('--size', type=int, default=512)
    ap.add_argument('--burnin', type=int, default=128)
    ap.add_argument('--chains', type=int, default=64)
    args = ap.parse_args()

    import torch

    from occuspytial_tpu_torch import LogitICARGibbs
    from occuspytial_tpu_torch.utils import make_data

    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip())
    Q, W, X, y, *_ = make_data(n=1000, ns=500, p=3, q=3, min_v=2, max_v=10,
                               random_state=7)
    print(f'size {args.size}, burnin {args.burnin}, chains {args.chains}')
    seen = {'xla': [], 'pallas': []}
    for seed in args.seeds:
        for impl in ('xla', 'pallas'):
            s = LogitICARGibbs(Q, W, X, y, random_state=seed, cg_impl=impl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            post = s.sample(args.size, burnin=args.burnin,
                            chains=args.chains, progressbar=False)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            ess, where = min_pooled_ess(post)
            seen[impl].append(ess)
            print(f'seed {seed} cg_impl={impl}: min pooled bulk-ESS '
                  f'{ess:.1f} at {where}, last_solver_resid '
                  f'{s.last_solver_resid:.3e}, {args.size / sec:.2f} it/s',
                  flush=True)
    for impl, vals in seen.items():
        print(f'cg_impl={impl}: min {min(vals):.1f}, median '
              f'{float(np.median(vals)):.1f}, max {max(vals):.1f} over '
              f'{len(vals)} seeds')


if __name__ == '__main__':
    main()
