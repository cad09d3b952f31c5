"""The benchmark's plain reference of the probit RSR sampler
(``h100bench/reference/probit_rsr.py``) against the port's
``ProbitRSRGibbs`` on the CPU, on the headline generator at 150 sites
(10 x 15 queen lattice), q from upstream's threshold r = 0.5, 4 chains:
the same reduced basis, column signs included; in float64 the same two
steps up to rounding, from the seed's start and from a carry taken in
the middle of a run; in float32 the benchmark cell's comparison within
its limit."""

import numpy as np
import pytest
import torch

from h100bench import judge, spec
from h100bench.generators import make_data as generator
from h100bench.reference import probit_rsr
from h100bench.reference.operators import Arith
from occuspytial_tpu_torch import ProbitRSRGibbs
from occuspytial_tpu_torch.ops import icar

CELL = 'probit_rsr1k.collapsed.c256'
CHAINS, SEED = 4, 2 ** 31 + 20
SIZES = {'n': 150, 'ns': 75, 'p': 3, 'q': 3, 'min_v': 2, 'max_v': 10,
         'tau_range': [0.25, 1.5], 'neighbors': 8, 'lattice': [10, 15]}


@pytest.fixture(scope='module')
def data():
    return generator.generate(SIZES, 7)


def _sampler(data, dtype):
    return ProbitRSRGibbs(data['Q'], data['W'], data['X'], data['y'],
                          random_state=SEED, dtype=dtype, device='cpu')


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _gaps(data, dtype, clamp):
    """(chain gaps from the start, from a carry after 24 steps) of the
    port in ``dtype`` against the float64 reference."""
    s = _sampler(data, dtype)
    ref = probit_rsr.ProbitRSR(data, {}, Arith('cpu'), clamp=clamp)
    carry = s.init_carry(CHAINS)
    keys = ref.run_keys(SEED, CHAINS)
    assert torch.equal(keys, carry.keys)
    post = s.sample(2, chains=CHAINS, resume_from=carry, progressbar=False)
    want = ref.follow(ref.init_state(SEED, CHAINS), keys, 0, 2)
    start = judge.chain_gaps(judge.first_steps(post, 2), _np(want))
    s.sample(22, chains=CHAINS, resume_from=s.final_carry,
             progressbar=False)
    mid = s.final_carry
    post = s.sample(2, chains=CHAINS, resume_from=mid, progressbar=False)
    want = ref.follow(ref.state_from(mid.states), keys, mid.step, 2)
    return start, judge.chain_gaps(judge.first_steps(post, 2), _np(want))


def test_reference_basis_is_the_ports_column_by_column(data):
    k_ref, q_ref, eig = probit_rsr.moran_basis(data['X'], data['Q'], r=0.5)
    k, q_rsr = icar.moran_basis(np.asarray(data['X'], np.float64),
                                data['Q'], r=0.5)
    assert k.shape == k_ref.shape and k.shape[1] == int((eig >= 0.5).sum())
    # the same sign in every column: the draws in the basis depend on it
    np.testing.assert_allclose(k_ref, k, rtol=0, atol=1e-8)
    np.testing.assert_allclose(q_ref, q_rsr, rtol=0, atol=1e-8)
    assert _sampler(data, torch.float32).q_dim == k.shape[1]


@pytest.mark.parametrize('where', ['start', 'mid_run'])
def test_float64_port_follows_the_reference(data, where):
    """Only rounding parts the two in float64 (the quantile clamped at
    float64's epsilon in both), so any departure in the mathematics of a
    step shows far above 1e-8."""
    gaps = _gaps(data, torch.float64, torch.finfo(torch.float64).eps)
    g = gaps[0] if where == 'start' else gaps[1]
    assert np.max(g) < 1e-8, g


def test_float32_port_is_within_the_cells_limit(data):
    limit = spec.cell(spec.load_benchmark(), CELL)['traffic_spec'][
        'limits'][judge.STAT]
    start, mid = _gaps(data, torch.float32, probit_rsr.CLAMP_FLOAT32)
    assert judge.quantile([start, mid]) < limit, (start, mid)
