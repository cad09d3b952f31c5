"""Posterior parity: the port's LogitICARGibbs against the JAX package's.

Both samplers run the same model on the same dataset with unrelated
random streams, so their posterior means of alpha and beta may differ by
Monte-Carlo error only: a two-sample z-test per scalar (the pattern of
tests/test_parity.py, Z = 6 with an absolute floor of 0.05).
"""

import numpy as np
import torch

from occuspytial_tpu.models.logit import LogitICARGibbs as JaxLogit
from occuspytial_tpu_torch import LogitICARGibbs
from occuspytial_tpu_torch import diagnostics as dg
from occuspytial_tpu_torch.utils import make_data

# the tensors here are small: one intra-op thread is faster than many,
# and the suite already runs in parallel worker processes
torch.set_num_threads(1)

SIZE, BURNIN, CHAINS = 1000, 250, 4
Z_TOL, FLOOR = 6.0, 0.05
# the 8-iteration default budget is tuned for n = 1000; at n = 150 a tau
# excursion starves it past the JAX sampler's own in-run guardrail
# (residual 0.39 > 0.2 with this seed), so both samplers get 15
CG_ITERS = 15


def test_port_posterior_means_match_jax_sampler():
    Q, W, X, y, *_ = make_data(
        n=150, ns=100, p=3, q=2, min_v=2, max_v=10, random_state=10
    )
    jax_post = JaxLogit(Q, W, X, y, random_state=4, solver='cg',
                        cg_iters=CG_ITERS).sample(
        SIZE, burnin=BURNIN, chains=CHAINS, progressbar=False
    )
    port = LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                          cg_iters=CG_ITERS, device='cpu')
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
