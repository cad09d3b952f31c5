#!/usr/bin/env python3
"""The parallel package across every card of one host.

``sample_parallel`` over ``chain_mesh()`` (one worker per card, 64
chains each) on the headline problem with ``cg_impl='pallas'``, against
one worker on one card, then ``chip_smoke.py``'s phase 14 (the sharded
stencil and graph solves; its NCCL world has one rank per card), then,
on a machine with four cards or more, ``sample_parallel_2d`` of config 5
(the 100 x 100 lattice, ``LogitICARGibbs`` stencil, 32 chains) over a 1
x 4 NCCL mesh, one rank a card: each rank's band step captured as one
CUDA graph against the host loop, the draws compared and ms a step of
each. NCCL takes one rank a card, so a machine with fewer cards skips
that run and says so. Run from the repository root on a machine with
one or more CUDA cards:

    python3 scripts/torch_multicard.py [--steps 160] [--steps-2d 32]
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
    ap.add_argument('--steps-2d', type=int, default=32)
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
    cards = torch.cuda.device_count()
    if cards < 4:
        print(f'--- 2-D, 1 x 4 NCCL: skipped: NCCL takes one rank a card, '
              f'and this machine has {cards} card(s)')
        return
    two_d_nccl(args.steps_2d, card.splitlines()[0])


def two_d_nccl(steps, card):
    """Config 5 over a 1 x 4 NCCL mesh (25-row bands): the captured band
    step against the host loop (``_force_eager``) from the same carry,
    and ms a step of each (steps 3 on, the slowest rank)."""
    import copy

    import numpy as np
    import torch

    import chip_smoke as cs
    from occuspytial_tpu_torch import LogitICARGibbs
    from occuspytial_tpu_torch.parallel import mesh_2d, sample_parallel_2d

    chains = cs.LARGE_CHAINS['stencil']
    mesh = mesh_2d(1, 4)
    cs.check(mesh.backend == 'nccl', f'mesh over the cards: {mesh}')
    ts = cs.phase(f'2-D, {mesh.shape} NCCL, config 5 stencil, {chains} '
                  f'chains: captured against the host loop, {steps} steps '
                  f'each way ({card})')
    s0, _ = cs.two_d_samplers(torch.device('cuda'), 'stencil')[
        LogitICARGibbs]
    runs = {}
    with mesh:
        for eager in (False, True):
            s = copy.copy(s0)
            s._force_eager = eager
            post = sample_parallel_2d(s, steps, mesh, chains=chains)
            cs.check(all(r['captured'] != eager for r in s.rank_runs),
                     f'captured {[r["captured"] for r in s.rank_runs]}')
            cs.check_state(s.final_carry)
            ms = 1e3 * max(float(np.mean(t[2:]))
                           for t in s.rank_step_seconds)
            runs[eager] = (s, post, ms)
    (s_g, post_g, ms_g), (s_e, post_e, ms_e) = runs[False], runs[True]
    pairs = [(post_g[k], post_e[k]) for k in ('alpha', 'beta', 'tau')]
    pairs += [(s_g.final_carry.states[k].cpu().numpy(), v.cpu().numpy())
              for k, v in s_e.final_carry.states.items()]
    same = all(np.array_equal(a, b) for a, b in pairs)
    diff = max(float(np.abs(a.astype(np.float64) - b).max())
               for a, b in pairs if a.dtype.kind == 'f')
    for name in ('alpha', 'beta', 'tau'):
        np.testing.assert_allclose(post_g[name], post_e[name], rtol=2e-3,
                                   atol=0.0 if name == 'tau' else 2e-4)
    capture = max(r['capture_seconds'] for r in s_g.rank_runs)
    print(f'    draws and final carry '
          f'{"bit-identical" if same else "differ"} (max |diff| '
          f'{diff:.3e}); ms a step eager {ms_e:.3f}, captured {ms_g:.3f} '
          f'({ms_e / ms_g:.2f}x); capture {capture:.3f} s')
    cs.done(ts)


if __name__ == '__main__':
    main()
