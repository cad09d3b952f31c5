#!/usr/bin/env python3
"""The parallel package across every card of one host.

``sample_parallel`` over ``chain_mesh()`` (one worker per card, 64
chains each) on the headline problem with ``cg_impl='pallas'``, against
one worker on one card, then ``chip_smoke.py``'s phase 14 (the sharded
stencil and graph solves; its NCCL world has one rank per card). Run
from the repository root on a machine with one or more CUDA cards:

    python3 scripts/torch_multicard.py [--steps 160]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--steps', type=int, default=160)
    args = ap.parse_args()

    import subprocess

    import torch

    import chip_smoke as cs
    from occuspytial_tpu_torch import LogitICARGibbs
    from occuspytial_tpu_torch.parallel import chain_mesh, sample_parallel
    from occuspytial_tpu_torch.utils import make_data

    cs.check(torch.cuda.is_available(), 'CUDA is not available')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card)
    Q, W, X, y, *_ = make_data(**cs.HEAD)
    mesh = chain_mesh()
    for m in ([mesh[0]], mesh):
        s = LogitICARGibbs(Q, W, X, y, random_state=8, cg_impl='pallas')
        chains = cs.CHAINS * len(m)
        ts = time.perf_counter()
        post = sample_parallel(s, args.steps, chains=chains, mesh=m)
        wall = time.perf_counter() - ts
        cs.check_posterior(post, chains, args.steps,
                           {'alpha': s.n_alpha, 'beta': s.n_beta, 'tau': 0})
        busy = max(s.worker_seconds)
        print(f'    {len(m)} worker(s), one a card, {chains} chains: wall '
              f'{wall:.2f} s, sampling {busy:.2f} s (first steps '
              f'included), {args.steps / busy:.2f} it/s, '
              f'{chains * args.steps / busy:.1f} chain-steps/s')
    cs.sharded_phase(torch.device('cuda'), card.splitlines()[0])


if __name__ == '__main__':
    main()
