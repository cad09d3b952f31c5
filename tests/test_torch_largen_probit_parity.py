"""Posterior parity of ``ProbitICARGibbs``'s large-n eta regimes against
the JAX sampler: the test of tests/test_torch_largen_parity.py for the
probit family (a file of its own to keep each under ~90 s on one core).
"""

import pytest

from test_torch_largen_parity import check_posterior_parity


@pytest.mark.parametrize('regime', ['stencil', 'graph'])
def test_port_posterior_means_match_jax_sampler(regime):
    check_posterior_parity('probit', regime)
