"""RSR q-space precision: the share of its roofline, in percent, that the
kernels of :mod:`rsr_precision.us_per_step` reach in a Gibbs step.

The least time of a step is the larger of, summed over the spatial
sweeps:

- the work time: the work as its shapes define it, whatever computes
  it, at the card's float32 rate. Per chain and sweep, n q (q + 1) / 2
  multiply-adds for the symmetric product K' diag(omega) K (n sites, q
  columns), q^3 / 3 for the factor of Lambda and q^2 for the two
  triangular solves of the mean, Lambda^-1 y;
- the byte time: K read once (n q), and per chain omega read (n) and
  Lambda written, read by the factor and its factor written (3 q^2),
  float32, at the HBM rate.

None where the configuration fixes no ``q`` or the cell no
``spatial_sweeps``, or where no such kernel ran."""

import importlib.util
from pathlib import Path


def _timed():
    path = Path(__file__).with_name('rsr_precision.us_per_step.py')
    spec = importlib.util.spec_from_file_location('_rsr_precision_us', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def product_macs(n, q):
    return n * q * (q + 1) / 2.0


def factor_macs(q):
    return q ** 3 / 3.0


def solve_macs(q):
    return float(q * q)


def sweep_flops(chains, n, q):
    """Float operations (two a multiply-add) of one sweep."""
    return 2.0 * chains * (product_macs(n, q) + factor_macs(q)
                           + solve_macs(q))


def sweep_bytes(chains, n, q):
    """K once, and per chain omega and three q x q matrices, float32."""
    return 4.0 * n * q + 4.0 * chains * (n + 3 * q * q)


def least_seconds(chains, n, q, sweeps, peaks):
    work = sweep_flops(chains, n, q) / peaks['fp32_flops_per_s']
    moved = sweep_bytes(chains, n, q) / peaks['hbm_bytes_per_s']
    return sweeps * max(work, moved)


def read(ctx):
    args = ctx['args']
    q, sweeps = args.get('q'), args.get('spatial_sweeps')
    if not q or not sweeps:
        return None
    sec, count = ctx['trace'].time_of(_timed().PATTERN.search)
    if count == 0:
        return None
    least = least_seconds(ctx['chains'], ctx['n'], int(q), int(sweeps),
                          ctx['peaks'])
    return 100.0 * least / (sec / ctx['steps'])
