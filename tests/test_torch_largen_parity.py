"""Posterior parity of the large-n eta regimes: port against JAX samplers.

``LogitICARGibbs`` (``ProbitICARGibbs``: tests/test_torch_largen_probit_
parity.py, the same test, split for time) with ``solver='stencil'`` and
``solver='graph'`` on the n = 150 dataset of tests/test_parity.py (the
queen lattice of ``make_data``, its shape recovered as there; the graph
regime gets the sparse Q). Port and JAX sampler run the same model with
unrelated random streams, so posterior means of alpha and beta may differ
by Monte-Carlo error only: a two-sample z-test per scalar (Z = 6, floor
0.05, the pattern of tests/test_torch_parity.py).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from occuspytial_tpu.models.logit import LogitICARGibbs as JaxLogit
from occuspytial_tpu.models.probit import ProbitICARGibbs as JaxProbit
from occuspytial_tpu_torch import LogitICARGibbs, ProbitICARGibbs
from occuspytial_tpu_torch import diagnostics as dg
from occuspytial_tpu_torch.ops.icar import lattice_precision
from occuspytial_tpu_torch.utils import make_data

torch.set_num_threads(1)

SIZE, BURNIN, CHAINS = 600, 150, 4
Z_TOL, FLOOR = 6.0, 0.05
FAMILIES = {'logit': (JaxLogit, LogitICARGibbs),
            'probit': (JaxProbit, ProbitICARGibbs)}


def _dataset():
    Q, W, X, y, *_ = make_data(n=150, ns=100, p=3, q=2, min_v=2, max_v=10,
                               random_state=10)
    qs = sps.csr_matrix(Q)
    n = X.shape[0]
    lat = next(
        (r, n // r, 8) for r in range(3, n + 1)
        if n % r == 0
        and (sps.csr_matrix(lattice_precision(r, n // r, 8)) != qs).nnz == 0
    )
    return Q, W, X, y, lat


def check_posterior_parity(family, regime):
    """Port and JAX sampler of ``family`` with the ``regime`` eta solver:
    posterior means of alpha and beta equal by the z-test."""
    Q, W, X, y, lat = _dataset()
    kw = dict(lattice=lat) if regime == 'stencil' else dict(solver='graph')
    q_in = sps.csr_matrix(Q) if regime == 'graph' else Q
    jcls, tcls = FAMILIES[family]
    jax_post = jcls(q_in, W, X, y, random_state=4, **kw).sample(
        SIZE, burnin=BURNIN, chains=CHAINS, progressbar=False
    )
    port = tcls(q_in, W, X, y, random_state=4, device='cpu', **kw)
    assert port.solver == regime
    post = port.sample(SIZE, burnin=BURNIN, chains=CHAINS, progressbar=False)
    assert port.last_solver_resid <= port.solver_check_tol
    for name, dim in (('alpha', 2), ('beta', 3)):
        for j in range(dim):
            a = np.asarray(post[name])[:, :, j]
            b = np.asarray(jax_post[name])[:, :, j]
            ratio = dg.mean_z_ratio(a, b, Z_TOL, FLOOR)
            assert ratio < 1.0, (
                f'{name}[{j}]: port {a.mean():.4f} vs jax {b.mean():.4f} '
                f'({ratio:.3f} of the tolerance)'
            )


@pytest.mark.parametrize('regime', ['stencil', 'graph'])
def test_port_posterior_means_match_jax_sampler(regime):
    check_posterior_parity('logit', regime)
