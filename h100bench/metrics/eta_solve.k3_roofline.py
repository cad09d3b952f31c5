"""Dense eta solve (``ops/cuda_cg.py``, ``csrc/icar_cg.cu``): K3's share
of its roofline, in percent, per launch.

The least time of one solve is the larger of

- the work time: the solve's work as its shapes define it, whatever
  computes it. The fixed-iteration eigenbasis PCG takes 2 iters + 4
  products of (chains * rows) x n by n x n (rhs into the eigenbasis, the
  start's residual, two per iteration, the solution back), each at three
  TF32 passes per multiply-add (the card's fastest product at the
  float32 accuracy the comparison holds it to), plus its elementwise
  work (15 operations per row element an iteration) at the float32 rate;
- the byte time: each input (rhs, warm start, omega, tau, U, S) read
  once and each output (the site and eigenbasis solutions, the residual)
  written once, float32, at the HBM rate.

The device time of a launch is the kernels' time over their count in
the trace.
"""

import re

#: the kernel's name in the device trace
PATTERN = re.compile(r'icar_cg_kernel')


def products(iters):
    return 2 * int(iters) + 4


def solve_flops(chains, rows, n, iters):
    """(product flops, elementwise flops) of one solve."""
    m = chains * rows
    return 2.0 * m * n * n * products(iters), 15.0 * m * n * int(iters)


def solve_bytes(chains, rows, n):
    m = chains * rows
    return 4.0 * (4 * m * n + n * n + n + chains * n + 2 * chains)


def least_seconds(chains, rows, n, iters, peaks):
    prod, elem = solve_flops(chains, rows, n, iters)
    work = (prod * peaks['tf32_passes_per_fp32_product']
            / peaks['tf32_flops_per_s'] + elem / peaks['fp32_flops_per_s'])
    return max(work, solve_bytes(chains, rows, n) / peaks['hbm_bytes_per_s'])


def read(ctx):
    sec, count = ctx['trace'].time_of(PATTERN.search)
    if count == 0:
        return None
    rows = ctx['p'] + 3  # the blocked update's rows [Omega X, k, 1, pert]
    least = least_seconds(ctx['chains'], rows, ctx['n'],
                          ctx['args'].get('cg_iters', 8), ctx['peaks'])
    return 100.0 * least / (sec / count)
