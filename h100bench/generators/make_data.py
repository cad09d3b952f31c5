"""Single-season occupancy data by the upstream OccuSpytial
``utils.make_data`` contract, with the lattice shape fixed.

The draws follow upstream's order on a SFC64 generator: surveyed sites,
visits per site, alpha, beta, tau, the lattice factorization, the ICAR
field from the pseudo-inverse of Q / tau, X, z, then per surveyed site
its detection design and outcomes. The factorization is drawn (so every
later draw stays where upstream has it) and then replaced by
``params['lattice']``: every seed gives the same sizes. X and W are
rounded to float32 values, the precision the samplers store them in, so
the program and the reference read the same numbers.
"""

import numpy as np
import scipy.sparse as sps
from scipy.linalg import pinvh


def lattice_q(rows, cols, neighbors=8):
    """The ICAR precision diag(deg) - A of a rook (4) or queen (8)
    lattice, sites row-major, as scipy CSR."""
    grid = np.arange(rows * cols).reshape(rows, cols)
    offs = [(0, 1), (1, 0)] + ([(1, 1), (1, -1)] if neighbors == 8 else [])
    i, j = [], []
    for dr, dc in offs:
        a = grid[:rows - dr, max(0, -dc):cols - max(0, dc)]
        b = grid[dr:, max(0, dc):cols + min(0, dc)]
        i.append(a.ravel())
        j.append(b.ravel())
    i, j = np.concatenate(i), np.concatenate(j)
    n = rows * cols
    adj = sps.coo_matrix((np.ones(2 * i.size), (np.r_[i, j], np.r_[j, i])),
                         shape=(n, n)).tocsr()
    deg = np.asarray(adj.sum(axis=1)).ravel()
    return (sps.diags(deg) - adj).tocsr()


def _sigmoid(x):
    return np.exp(-np.logaddexp(0.0, -x))


def _f32(a):
    return np.asarray(a, np.float32).astype(np.float64)


def generate(params, seed):
    """{'Q', 'W', 'X', 'y'} from the data seed ``seed`` for ``params``:
    n, ns, p, q, min_v, max_v, tau_range, neighbors, lattice (rows,
    cols)."""
    n, ns, p, q = params['n'], params['ns'], params['p'], params['q']
    rows, cols = params['lattice']
    if rows * cols != n:
        raise ValueError('lattice does not hold n sites')
    gen = np.random.default_rng(np.random.SFC64(int(seed) % 2 ** 64))
    surveyed = gen.choice(range(n), size=ns, replace=False)
    visits = gen.integers(params['min_v'], params['max_v'], size=ns,
                          endpoint=True)
    alpha = gen.standard_normal(q)
    beta = gen.standard_normal(p)
    tau = gen.uniform(*params['tau_range'])
    gen.choice([f for f in range(3, n) if n % f == 0])
    Q = lattice_q(rows, cols, params['neighbors'])
    eta = gen.multivariate_normal(
        np.zeros(n), pinvh(Q.toarray(), rtol=1e-5) / tau, method='eigh')
    X = gen.uniform(-2, 2, n * p).reshape(n, -1)
    X[:, 0] = 1
    z = gen.binomial(1, p=_sigmoid(X @ beta - eta), size=n)
    W, y = {}, {}
    for site, v in zip(surveyed, visits):
        w = gen.uniform(-2, 2, size=v * q).reshape(v, -1)
        w[:, 0] = 1
        W[int(site)] = _f32(w)
        y[int(site)] = gen.binomial(1, z[site] * _sigmoid(w @ alpha))
    return {'Q': Q, 'W': W, 'X': _f32(X), 'y': y}
