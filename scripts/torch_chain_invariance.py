#!/usr/bin/env python3
"""Find the ops whose per-chain results depend on the chain count.

A chain's draws are meant to be a function of its own key alone. On the
card a batched op may pick its kernel, and with it its order of sums, by
the batch size, and then chain 0 run among 2 chains and among 3 differs
in the last bits. This script, on one CUDA card:

1. runs each sampler and eta regime of ``chip_smoke.py`` phases 5-12 for
   ``--steps`` steps at a small and a large chain count and prints the
   largest difference of the shared chains' alpha, beta and tau;
2. runs one step from the same state at both counts under a
   ``TorchFunctionMode`` that records every torch op, and names each op
   whose inputs agree on the shared chains while its output does not:
   the ops that break the invariance, with their call site in the
   package and the largest difference they make. The list is a lead:
   an input written outside the mode (a kernel's output, filled through
   ctypes) counts as agreeing, so an op downstream of it may be listed.

Usage (repository root, one card): ``python3 scripts/torch_chain_invariance.py
[--pairs 2,3 32,64] [--only logit_cg ...]``. Writes its findings as JSON
to ``chiprun_out/chain_invariance.json`` as well.
"""

import argparse
import json
import os
import sys
import traceback

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import HEAD, LARGE, LATTICE, make_lattice_dataset  # noqa: E402

_SKIP = {'empty', 'empty_like', 'new_empty', 'empty_strided'}
_INPLACE_DUNDERS = {'__setitem__', '__iadd__', '__isub__', '__imul__',
                    '__itruediv__'}
_PKG = os.sep + 'occuspytial_tpu_torch' + os.sep


def _name(func):
    return getattr(func, '__qualname__', None) or getattr(
        func, '__name__', repr(func))


def _site():
    for fr in reversed(traceback.extract_stack()[:-2]):
        if _PKG in fr.filename:
            rel = fr.filename.split(_PKG, 1)[1]
            return f'{rel}:{fr.lineno}'
    return '?'


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def _aligned(big, small, k, kk):
    """``big`` narrowed to the shared chains, to compare with ``small``;
    None where the shapes do not line up."""
    if big.shape == small.shape:
        return big
    if big.dim() != small.dim():
        return None
    diff = [d for d in range(big.dim()) if big.shape[d] != small.shape[d]]
    if len(diff) != 1:
        return None
    d = diff[0]
    if big.shape[d] * k != small.shape[d] * kk:
        return None
    return big.narrow(d, 0, small.shape[d])


def _maxdiff(a, b):
    if a.dtype == torch.bool or not a.is_floating_point():
        return 0.0 if torch.equal(a, b) else float('inf')
    if torch.equal(a, b):
        return 0.0
    both_nan = torch.isnan(a) & torch.isnan(b)
    if bool(both_nan.any()) and torch.equal(a[~both_nan], b[~both_nan]):
        return 0.0
    return float((a.double() - b.double()).abs().max())


class _Recorder(TorchFunctionMode):
    """Records every op's outputs (small run) or compares them (large
    run) and flags the ops whose clean inputs give a dirty output."""

    def __init__(self, ref=None, k=0, kk=0):
        super().__init__()
        self.ref, self.k, self.kk = ref, k, kk
        self.outs, self.i, self.culprits, self.misaligned = [], 0, {}, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _name(func)
        if name.split('.')[-1] in _SKIP:
            return out
        outs = _tensors(out)
        short = name.split('.')[-1]
        inplace = (short.endswith('_') and not short.endswith('__')) \
            or short in _INPLACE_DUNDERS
        if inplace and args and isinstance(args[0], torch.Tensor):
            outs = [args[0]]
        if not outs:
            return out
        if self.ref is None:
            self.outs.append([t.detach().clone() for t in outs])
            return out
        if self.i >= len(self.ref):
            self.misaligned += 1
            return out
        ref = self.ref[self.i]
        self.i += 1
        ins = [t for a in list(args) + list(kwargs.values())
               for t in _tensors(a)]
        clean_in = not any(getattr(a, '_cc_dirty', False) for a in ins)
        dirty, worst = False, 0.0
        for t, r in zip(outs, ref):
            a = _aligned(t.detach(), r, self.k, self.kk)
            if a is None:
                self.misaligned += 1
                continue
            d = _maxdiff(a, r)
            if d != 0.0:
                dirty, worst = True, max(worst, d)
        for t in outs:
            try:
                t._cc_dirty = dirty or (
                    inplace and getattr(t, '_cc_dirty', False))
            except (AttributeError, RuntimeError):
                pass
        if dirty and clean_in:
            key = (_site(), name)
            n, w = self.culprits.get(key, (0, 0.0))
            self.culprits[key] = (n + 1, max(w, worst))
        return out


def _configs(dev):
    import scipy.sparse as sps

    from occuspytial_tpu_torch import (
        LogitICARGibbs,
        LogitRSRGibbs,
        ProbitICARGibbs,
        ProbitRSRGibbs,
    )
    from occuspytial_tpu_torch.utils import make_data

    head = make_data(**HEAD)[:4]
    lat = make_lattice_dataset(LATTICE['rows'], LATTICE['cols'],
                               ns=LATTICE['ns'], seed=LATTICE['seed'])[:4]
    big = make_lattice_dataset(
        LARGE['rows'], LARGE['cols'], ns=LARGE['ns'], seed=LARGE['seed'],
        min_v=LARGE['min_v'], max_v=LARGE['max_v'])[:4]
    grid = dict(lattice=(LARGE['rows'], LARGE['cols'], 8))
    q5 = sps.csr_matrix(big[0])
    seed = HEAD['random_state']
    return {
        'logit_cg': lambda: LogitICARGibbs(*head, random_state=seed,
                                           device=dev),
        'logit_cg_pallas': lambda: LogitICARGibbs(
            *head, random_state=seed + 1, device=dev, cg_impl='pallas'),
        'logit_rsr': lambda: LogitRSRGibbs(*head, random_state=seed, q=100,
                                           device=dev),
        'probit_spectral': lambda: ProbitICARGibbs(
            *lat, random_state=LATTICE['seed'], device=dev),
        'probit_rsr': lambda: ProbitRSRGibbs(
            *lat, random_state=LATTICE['seed'], device=dev),
        'probit_rsr_ordered': lambda: ProbitRSRGibbs(
            *lat, random_state=LATTICE['seed'], collapsed=False, device=dev),
        'logit_stencil': lambda: LogitICARGibbs(
            *big, random_state=LARGE['seed'], device=dev, **grid),
        'logit_graph': lambda: LogitICARGibbs(
            q5, *big[1:], random_state=LARGE['seed'], device=dev,
            solver='graph'),
        'probit_stencil': lambda: ProbitICARGibbs(
            *big, random_state=LARGE['seed'], device=dev, **grid),
        'probit_graph': lambda: ProbitICARGibbs(
            q5, *big[1:], random_state=LARGE['seed'], device=dev,
            solver='graph'),
    }


def _run_diff(s, k, kk, steps):
    a = s.sample(steps, chains=k, progressbar=False)
    b = s.sample(steps, chains=kk, progressbar=False)
    return max(float(np.abs(np.asarray(a[n], np.float64)
                            - np.asarray(b[n], np.float64)[:k]).max())
               for n in ('alpha', 'beta', 'tau'))


def _step_culprits(s, k, kk):
    from occuspytial_tpu_torch.models.base import Carry

    carry = s.init_carry(kk)
    small = Carry(carry.keys[:k],
                  {n: v[:k].clone() for n, v in carry.states.items()}, 0)
    rec = _Recorder()
    with rec:
        s._step(small.keys, 0, dict(small.states), s.fixed)
    cmp = _Recorder(rec.outs, k, kk)
    with cmp:
        s._step(carry.keys, 0, dict(carry.states), s.fixed)
    return cmp


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--pairs', nargs='+', default=['2,3', '32,64'])
    ap.add_argument('--only', nargs='*', default=None)
    ap.add_argument('--steps', type=int, default=6)
    ap.add_argument('--device', default='cuda',
                    help="'cpu' rehearses the script on the CPU")
    args = ap.parse_args()
    from occuspytial_tpu_torch._device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == 'cuda':
        import subprocess

        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, check=True).stdout.strip()
    else:
        card = 'cpu'
    print(card, flush=True)
    pairs = [tuple(int(x) for x in p.split(',')) for p in args.pairs]
    report = {'card': card, 'configs': {}}
    for name, make in _configs(dev).items():
        if args.only and name not in args.only:
            continue
        s = make()
        for k, kk in pairs:
            run = _run_diff(s, k, kk, args.steps)
            cmp = _step_culprits(s, k, kk)
            culprits = sorted(cmp.culprits.items(), key=lambda x: x[0])
            print(f'{name} chains {k} vs {kk}: {args.steps}-step run max '
                  f'|diff| {run:.3e}; one step: {len(culprits)} culprit '
                  f'sites, {cmp.misaligned} unaligned outputs, '
                  f'{cmp.i}/{len(cmp.ref)} ops compared', flush=True)
            for (site, op), (n, w) in culprits:
                print(f'    {site} {op}: {n}x, max |diff| {w:.3e}')
            report['configs'][f'{name} {k},{kk}'] = {
                'run_max_diff': run,
                'culprits': [[site, op, n, w]
                             for (site, op), (n, w) in culprits],
                'unaligned': cmp.misaligned,
            }
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'chain_invariance.json'),
              'w') as f:
        json.dump(report, f, indent=1)


if __name__ == '__main__':
    main()
