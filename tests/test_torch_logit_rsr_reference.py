"""The benchmark's plain reference of the logit RSR sampler
(``h100bench/reference/logit_rsr.py``) against the port's
``LogitRSRGibbs`` on its ``basis='device'`` route, on the CPU: the
lattice generator at 144 sites (12 x 12 queen lattice, q from upstream's
threshold r = 0.5), 4 chains. The same reduced basis, signs included; in
float64 the same two steps up to rounding, from the seed's start and
from a carry taken in the middle of a run; in float32 the benchmark
cell's comparison within its limit; and two faults planted in the port,
the PG weights left out of K' Omega K and one basis column's sign
flipped, outside it."""

import numpy as np
import pytest
import torch

from h100bench import judge, spec
from h100bench.generators import lattice
from h100bench.reference import logit_rsr
from occuspytial_tpu_torch import LogitRSRGibbs
from occuspytial_tpu_torch.models import logit as logit_model
from occuspytial_tpu_torch.ops import icar
from occuspytial_tpu_torch.ops.mvnorm import cholesky_solve
from occuspytial_tpu_torch.ops.sites import LOCAL

CELL = 'logit_rsr10k.qspace.c32'
CHAINS, SEED = 4, 2 ** 31 + 24
SIZES = {'rows': 12, 'cols': 12, 'ns': 70, 'p': 3, 'q': 3, 'min_v': 2,
         'max_v': 5, 'neighbors': 8}


@pytest.fixture(scope='module')
def data():
    return lattice.generate(SIZES, 5)


def _sampler(data, dtype):
    return LogitRSRGibbs(data['Q'], data['W'], data['X'], data['y'],
                         random_state=SEED, basis='device', dtype=dtype,
                         device='cpu')


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _gaps(s, data):
    """(chain gaps from the start, from a carry after 24 steps) of the
    port sampler ``s`` against the float64 reference."""
    ref = logit_rsr.build(data, {}, 'cpu')
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


def _limit():
    return spec.cell(spec.load_benchmark(), CELL)['traffic_spec'][
        'limits'][judge.STAT]


def test_reference_basis_is_the_ports_column_by_column(data):
    """Two float64 builds of the operator (the port's rank-p corrections,
    the reference's Cholesky projector): rounding apart, same signs."""
    k_ref, q_ref, eig = logit_rsr.moran_basis(data['X'], data['Q'], r=0.5)
    k, q_rsr, info = icar.moran_basis_device(data['X'], data['Q'], r=0.5)
    assert k.shape == k_ref.shape and k.shape[1] == int((eig >= 0.5).sum())
    np.testing.assert_allclose(k_ref.numpy(), k.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(q_ref.numpy(), q_rsr.numpy(), rtol=0,
                               atol=1e-10)
    s = _sampler(data, torch.float64)
    ref = logit_rsr.build(data, {}, 'cpu')
    assert s.q_dim == ref.q == k.shape[1]
    np.testing.assert_allclose(ref.E.numpy(), s.fixed['sqrt_factor'].numpy(),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize('where', ['start', 'mid_run'])
def test_float64_port_follows_the_reference(data, where):
    """Only rounding parts the two in float64, so any departure in the
    mathematics of a step shows far above 1e-8."""
    gaps = _gaps(_sampler(data, torch.float64), data)
    g = gaps[0] if where == 'start' else gaps[1]
    assert np.max(g) < 1e-8, g


def test_float32_port_is_within_the_cells_limit(data):
    """The port's float32 products and factor against the float64
    reference: the cell's own limit, set from the card's readings."""
    start, mid = _gaps(_sampler(data, torch.float32), data)
    assert judge.quantile([start, mid]) < _limit(), (start, mid)


def _no_omega(b, omega, tau, q_rsr, k_basis, sqrt_factor, eps1=None,
              eps2=None, generator=None, sites=LOCAL):
    """``rsr_mvnorm`` with the PG weights left out of K' Omega K."""
    t = torch.as_tensor(tau, dtype=b.dtype)
    y = (b + sites.contract(torch.sqrt(omega) * eps1, k_basis)
         + torch.sqrt(t)[..., None] * (eps2 @ sqrt_factor.T))
    lam = t[..., None, None] * q_rsr + k_basis.T @ k_basis
    chol = torch.linalg.cholesky_ex(lam).L
    return cholesky_solve(y[..., None], chol)[..., 0]


@pytest.mark.parametrize('fault', ['omega_left_out', 'column_sign'])
def test_planted_fault_fails_the_comparison(data, fault, monkeypatch):
    s = _sampler(data, torch.float32)
    if fault == 'omega_left_out':
        monkeypatch.setattr(logit_model, 'rsr_mvnorm', _no_omega)
    else:
        s.fixed['K'][:, 0] *= -1
    start, mid = _gaps(s, data)
    assert judge.quantile([start, mid]) > 10 * _limit(), (start, mid)
