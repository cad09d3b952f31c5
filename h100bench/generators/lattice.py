"""Occupancy data on an explicit rows x cols lattice: the JAX bench's
``make_lattice_dataset`` (bench.py, configurations 1, 2, 5 and 5g), draw
for draw on a SFC64 generator: X, beta, alpha, z from sigmoid(X beta),
the surveyed sites, then per site its visit count, detection design and
outcomes. X and W are rounded to float32 values, as the samplers store
them."""

import numpy as np

from .make_data import _f32, lattice_q


def generate(params, seed):
    """{'Q', 'W', 'X', 'y'} from the data seed ``seed`` for ``params``:
    rows, cols, ns, p, q, min_v, max_v, neighbors."""
    rows, cols = params['rows'], params['cols']
    p, qa = params['p'], params['q']
    n = rows * cols
    gen = np.random.default_rng(np.random.SFC64(int(seed) % 2 ** 64))
    Q = lattice_q(rows, cols, params['neighbors'])
    X = gen.uniform(-2, 2, (n, p))
    X[:, 0] = 1
    beta = gen.standard_normal(p)
    alpha = gen.standard_normal(qa)
    z = gen.binomial(1, 1 / (1 + np.exp(-(X @ beta))))
    W, y = {}, {}
    for site in gen.choice(n, params['ns'], replace=False):
        v = gen.integers(params['min_v'], params['max_v'], endpoint=True)
        w = gen.uniform(-2, 2, (v, qa))
        w[:, 0] = 1
        W[int(site)] = _f32(w)
        y[int(site)] = gen.binomial(1, z[site] / (1 + np.exp(-(w @ alpha))))
    return {'Q': Q, 'W': W, 'X': _f32(X), 'y': y}
