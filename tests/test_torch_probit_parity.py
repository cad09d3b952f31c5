"""Posterior parity: the port's probit samplers against the JAX package's.

Both samplers run the same model on the JAX bench's 10 x 10 lattice
dataset (configs 2 and 2b) with unrelated random streams, so posterior
means of alpha and beta may differ by Monte-Carlo error only: a
two-sample z-test per scalar (Z = 6, floor 0.05, the pattern of
tests/test_parity.py and tests/test_torch_parity.py).
"""

import numpy as np
import pytest
import torch

from chip_smoke import make_lattice_dataset
from occuspytial_tpu.models.probit import ProbitICARGibbs as JaxICAR
from occuspytial_tpu.models.probit import ProbitRSRGibbs as JaxRSR
from occuspytial_tpu_torch import ProbitICARGibbs, ProbitRSRGibbs
from occuspytial_tpu_torch import diagnostics as dg

# the tensors here are small: one intra-op thread is faster than many,
# and the suite already runs in parallel worker processes
torch.set_num_threads(1)

SIZE, BURNIN, CHAINS = 600, 150, 4
Z_TOL, FLOOR = 6.0, 0.05


@pytest.mark.parametrize('jcls, tcls', [(JaxICAR, ProbitICARGibbs),
                                        (JaxRSR, ProbitRSRGibbs)])
def test_port_posterior_means_match_jax_sampler(jcls, tcls):
    Q, W, X, y, *_ = make_lattice_dataset(10, 10, ns=50, seed=3)
    jax_post = jcls(Q, W, X, y, random_state=4).sample(
        SIZE, burnin=BURNIN, chains=CHAINS, progressbar=False
    )
    post = tcls(Q, W, X, y, random_state=4, device='cpu').sample(
        SIZE, burnin=BURNIN, chains=CHAINS, progressbar=False
    )
    for name, dim in (('alpha', 3), ('beta', 3)):
        for j in range(dim):
            a = np.asarray(post[name])[:, :, j]
            b = np.asarray(jax_post[name])[:, :, j]
            ratio = dg.mean_z_ratio(a, b, Z_TOL, FLOOR)
            assert ratio < 1.0, (
                f'{name}[{j}]: port {a.mean():.4f} vs jax {b.mean():.4f} '
                f'({ratio:.3f} of the tolerance)'
            )
