"""The whole Gibbs step's share of the card's peak, in percent, for the
dense eigenbasis regime: the step's matrix-product work as its shapes
define it, over the trace run's own (untraced) window time per step, at
the rate of a float32-accurate product (TF32 peak / 3 passes). Per
spatial sweep the work is one eigenbasis PCG solve (the count of
``eta_solve.k3_roofline``), the noise product B eps (chains x (n - 1)
by (n - 1) x n) and tau's quadratic form eta Q (chains x n by n x n).
K3's roofline share is bounded by this: a kernel taken off the path
leaves its own metric silent, but not this one."""

from pathlib import Path


def _k3():
    import importlib.util

    path = Path(__file__).with_name('eta_solve.k3_roofline.py')
    spec = importlib.util.spec_from_file_location('_k3_counts', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_flops(chains, rows, n, iters, sweeps):
    prod, _ = _k3().solve_flops(chains, rows, n, iters)
    noise = 2.0 * chains * (n - 1) * n
    quad = 2.0 * chains * n * n
    return sweeps * (prod + noise + quad)


def read(ctx):
    args = ctx['args']
    if args.get('solver') != 'cg' or ctx.get('window_step_s', 0) <= 0:
        return None
    peaks = ctx['peaks']
    rate = peaks['tf32_flops_per_s'] / peaks['tf32_passes_per_fp32_product']
    flops = step_flops(ctx['chains'], ctx['p'] + 3, ctx['n'],
                       args.get('cg_iters', 8), args.get('spatial_sweeps', 3))
    return 100.0 * flops / ctx['window_step_s'] / rate
