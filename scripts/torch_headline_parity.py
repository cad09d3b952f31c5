#!/usr/bin/env python3
"""Posterior means of the port against the JAX package at headline size.

Runs ``LogitICARGibbs`` of both packages on the CPU on the benchmark's
headline dataset (n = 1000 sites, ``make_data(..., random_state=7)``)
with default options and prints, per scalar parameter, both posterior
means and their difference in units of the two-sample z-test tolerance
of tests/test_parity.py (Z = 6, floor 0.05; a ratio below 1 passes).
The two samplers use unrelated random streams.

    python3 scripts/torch_headline_parity.py [--draws 600] [--chains 4]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--draws', type=int, default=600)
    ap.add_argument('--burnin', type=int, default=200)
    ap.add_argument('--chains', type=int, default=4)
    ap.add_argument('--seed', type=int, default=7)
    args = ap.parse_args()

    import jax

    jax.config.update('jax_platforms', 'cpu')
    from occuspytial_tpu.models.logit import LogitICARGibbs as JaxLogit

    from occuspytial_tpu_torch import LogitICARGibbs
    from occuspytial_tpu_torch import diagnostics as dg
    from occuspytial_tpu_torch.utils import make_data

    Q, W, X, y, *_ = make_data(n=1000, ns=500, p=3, q=3, min_v=2,
                               max_v=10, random_state=7)
    run = dict(burnin=args.burnin, chains=args.chains, progressbar=False)
    ref = JaxLogit(Q, W, X, y, random_state=args.seed).sample(
        args.draws, **run)
    port = LogitICARGibbs(Q, W, X, y, random_state=args.seed,
                          device='cpu').sample(args.draws, **run)
    print(f'CPU, {args.chains} chains x {args.draws - args.burnin} kept '
          f'draws; columns: jax mean, port mean, |diff| / tolerance')
    for name in ('alpha', 'beta', 'tau'):
        a, b = np.asarray(ref[name]), np.asarray(port[name])
        if a.ndim == 2:
            a, b = a[..., None], b[..., None]
        for j in range(a.shape[2]):
            ratio = dg.mean_z_ratio(a[:, :, j], b[:, :, j])
            print(f'{name}[{j}] {a[:, :, j].mean():.4f} '
                  f'{b[:, :, j].mean():.4f} {ratio:.3f}')


if __name__ == '__main__':
    main()
