#!/usr/bin/env python3
"""The RSR Moran basis of a benchmark configuration, built on the CUDA
card by the samplers' ``basis='device'`` route, and what it rests on.

    python3 scripts/torch_moran_basis.py --config logit_rsr10k [--r 0.5]
    timeout 1200 python3 scripts/torch_moran_basis.py --config \\
        logit_rsr10k --host

In one process on the card, for the configuration's dataset:

1. the basis by ``ops/icar.py: moran_basis_device`` (host-clock seconds,
   synchronised), and ``torch.linalg.eigh`` of the operator alone;
2. q, what ``--r`` keeps; the eigenvalues either side of the cut; the
   smallest gap inside the kept block and the gap at the cut;
3. the sign convention (``ops/icar.py: signed_columns``): its margin for
   K's columns and for the eigenvectors that make E, against the
   float64 eigenvector error read two ways: bounded, each kept
   eigenvector's residual over its distance to the nearest other
   eigenvalue; and measured, the difference of g'v / |g| between the
   port's build and the benchmark reference's own
   (``h100bench/reference/logit_rsr.py``), with the count of columns
   whose signs differ; the smallest ratio of margin to error is read
   column by column (``*_margin_over_error``) and as the smallest margin
   over the largest error (``*_margin_over_largest_error``).

``--host`` instead times the host route at the same q (from 2,048 sites
of a sparse Q, scipy's Lanczos): run it under ``timeout``; it prints a
line when it starts, so a run cut short shows.

Writes JSON to ``--out`` (default ``build/moran_basis_<config>.json``,
``..._host.json`` with ``--host``) and prints it.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..'))


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _residual_error(m, vecs, vals, spectrum):
    """Each kept eigenvector's error bound: its residual |M v - w v| over
    the distance from w to the nearest other eigenvalue of
    ``spectrum``."""
    import torch

    res = torch.linalg.norm(m @ vecs - vecs * vals, dim=0)
    spec = torch.as_tensor(spectrum, dtype=vals.dtype, device=vals.device)
    dist = torch.abs(vals[:, None] - spec[None, :])
    dist[dist == 0] = float('inf')
    return res / torch.min(dist, dim=1).values


def _functional(a, b):
    """Per column |g'a_j| / |g| (the convention's margin) and |g'(a_j -
    b_j)| / |g|, and the count of columns whose g'a_j and g'b_j differ in
    sign."""
    import torch

    from occuspytial_tpu_torch.ops import icar

    g = torch.as_tensor(icar.sign_vector(a.shape[0]), dtype=a.dtype,
                        device=a.device)
    ga, gb = g @ a, g @ b
    norm = torch.norm(g)
    return (torch.abs(ga) / norm, torch.abs(ga - gb) / norm,
            int(torch.sum(torch.sign(ga) != torch.sign(gb))))


def _convention(out, name, bound, a, b):
    """The sign convention's readings for the columns ``a`` (the port's)
    against ``b`` (the reference's): the smallest margin, the largest
    error bound and measured gap, and the smallest ratio, column by
    column, of the margin to the larger of the two errors."""
    import torch

    margin, gap, out[f'{name}_signs_differ'] = _functional(a, b)
    out[f'{name}_error_bound'] = float(torch.max(bound))
    out[f'{name}_gap_to_reference'] = float(torch.max(gap))
    out[f'{name}_margin_over_error'] = float(torch.min(
        margin / torch.maximum(bound, gap)))
    out[f'{name}_margin_over_largest_error'] = float(torch.min(margin)) / max(
        out[f'{name}_error_bound'], out[f'{name}_gap_to_reference'])


def device_route(cfg, r, dev):
    import numpy as np
    import torch

    from h100bench.reference import logit_rsr as ref
    from occuspytial_tpu_torch.ops import icar

    data = _data(cfg)
    x, q = data['X'], data['Q']
    out = {'n': int(np.asarray(x).shape[0])}
    _sync()
    t = time.perf_counter()
    k, q_rsr, info = icar.moran_basis_device(x, q, r=r, device=dev)
    _sync()
    out['basis_s'] = time.perf_counter() - t
    w = info['eigvals']
    qd = k.shape[1]
    out.update(q=qd, kept_smallest=float(w[-qd]),
               dropped_largest=float(w[-qd - 1]),
               gap_at_cut=float(w[-qd] - w[-qd - 1]),
               smallest_kept_gap=float(np.min(np.diff(w[-qd:]))),
               largest=float(w[-1]), k_margin=info['margin'])
    t = time.perf_counter()
    e, out['e_margin'] = icar.psd_sqrt_factor_device(q_rsr)
    _sync()
    out['e_s'] = time.perf_counter() - t
    m = icar.moran_operator(x, q, dev)
    _sync()
    t = time.perf_counter()
    torch.linalg.eigh(m)
    _sync()
    out['eigh_alone_s'] = time.perf_counter() - t
    k_bound = _residual_error(m, k, torch.as_tensor(w[-qd:], device=dev),
                              w)
    del m
    s_e, u_e = torch.linalg.eigh(q_rsr)
    e_bound = _residual_error(q_rsr, u_e, s_e, s_e.cpu().numpy())
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t = time.perf_counter()
    k_ref, q_ref, _ = ref.moran_basis(x, q, r=r, device=dev)
    _sync()
    out['reference_basis_s'] = time.perf_counter() - t
    _convention(out, 'k', k_bound, k, k_ref)
    out['k_max_entry_diff'] = float(torch.max(torch.abs(k - k_ref)))
    out['q_rsr_max_diff'] = float(torch.max(torch.abs(q_rsr - q_ref)))
    s_r, u_r = torch.linalg.eigh(q_ref)
    e_ref = ref._signed(u_r) * torch.sqrt(torch.clamp(s_r, min=0.0))
    _convention(out, 'e', e_bound, e / torch.sqrt(s_e),
                e_ref / torch.sqrt(s_r))
    out['e_max_entry_diff'] = float(torch.max(torch.abs(e - e_ref)))
    if torch.cuda.is_available():
        out['peak_bytes'] = int(torch.cuda.max_memory_allocated())
    return out


def host_route(cfg, q_dim):
    import numpy as np

    from occuspytial_tpu_torch.ops import icar

    data = _data(cfg)
    print(json.dumps({'host_route_start': time.strftime('%H:%M:%S'),
                      'q': q_dim}), flush=True)
    t = time.perf_counter()
    k, _ = icar.moran_basis(np.asarray(data['X'], np.float64), data['Q'],
                            num_eigs=q_dim)
    return {'q': int(k.shape[1]), 'host_basis_s': time.perf_counter() - t}


def _data(cfg):
    from h100bench import spec

    return spec.generator(cfg['generator']).generate(cfg['data'],
                                                     cfg['data_seed'])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--config', required=True)
    ap.add_argument('--r', type=float, default=0.5)
    ap.add_argument('--host', action='store_true',
                    help='time the host route at the configuration\'s q')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()

    from h100bench import spec

    cfg = spec.config(args.config)
    if args.host:
        out = host_route(cfg, int(cfg['sampler_args']['q']))
    else:
        import torch

        from occuspytial_tpu_torch._device import resolve_device

        out = device_route(cfg, args.r, resolve_device('cuda'))
        out['device'] = torch.cuda.get_device_name(0)
    out['config'] = args.config
    out['card'] = os.popen('nvidia-smi --query-gpu=name,power.limit '
                           '--format=csv,noheader').read().strip()
    path = args.out or os.path.join(
        'build', f'moran_basis_{args.config}'
        f'{"_host" if args.host else ""}.json')
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w') as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
