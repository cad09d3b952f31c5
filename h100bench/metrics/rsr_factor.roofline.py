"""Collapsed RSR factor: the share of its roofline, in percent, that the
batched Cholesky factor and its triangular solves reach in a Gibbs step.

The least time of a step is the larger of, summed over the spatial
sweeps:

- the work time: the work as its shapes define it, whatever computes
  it, at the card's float32 rate. Per chain and sweep, q^3 / 3
  multiply-adds for the factor of A = tau Q_rsr + K'K / 2 (q x q), and
  q^2 for each right-hand side taken through the pair of triangular
  solves L L' x = b: the p + 1 right-hand sides of the collapsed beta
  draw (K'X and K'u) and the mean of the eta draw; the eta draw's noise
  L'^-1 eps takes one solve, q^2 / 2;
- the byte time: A read and L written once, each right-hand side read
  and each solution written once, float32, at the HBM rate.

The device time is that of :mod:`rsr_factor.us_per_step`'s kernels."""

import importlib.util
from pathlib import Path


def _timed():
    path = Path(__file__).with_name('rsr_factor.us_per_step.py')
    spec = importlib.util.spec_from_file_location('_rsr_factor_us', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def factor_macs(q):
    return q ** 3 / 3.0


def solve_macs(q, p):
    return (p + 2) * q * q + q * q / 2.0


def sweep_flops(chains, q, p):
    """Float operations (two a multiply-add) of one sweep's factor and
    solves."""
    return 2.0 * chains * (factor_macs(q) + solve_macs(q, p))


def sweep_bytes(chains, q, p):
    """A and L, and (p + 3) right-hand sides and as many solutions of q
    each, float32."""
    return 4.0 * chains * (2 * q * q + 2 * (p + 3) * q)


def least_seconds(chains, q, p, sweeps, peaks):
    work = sweep_flops(chains, q, p) / peaks['fp32_flops_per_s']
    moved = sweep_bytes(chains, q, p) / peaks['hbm_bytes_per_s']
    return sweeps * max(work, moved)


def read(ctx):
    args = ctx['args']
    q = args.get('q')
    if not q:
        return None
    sec, count = ctx['trace'].time_of(_timed().PATTERN.search)
    if count == 0:
        return None
    sweeps = int(args.get('spatial_sweeps') or 1)
    least = least_seconds(ctx['chains'], int(q), ctx['p'], sweeps,
                          ctx['peaks'])
    return 100.0 * least / (sec / ctx['steps'])
