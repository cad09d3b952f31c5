"""The port's chain parallelism on the CPU: ``sample_parallel`` over
spawned worker processes, the counterpart of ``tests/test_parallel.py``.

The mesh is ``['cpu'] * 4`` (four workers, the port's counterpart of the
virtual CPU devices the JAX tests shard over); the data is that file's
``make_data(n=150, ns=100, p=3, q=2, random_state=10)`` with 8 chains.
Chains run in other processes from the same keys, so the draws match the
single-process run to the JAX file's tolerance (rtol 2e-4, atol 1e-5:
batched products may round otherwise at 2 chains than at 8). The slice
as a whole is held against the JAX ``sample_parallel`` on its 8 virtual
devices by posterior means.

The samplers below that fail on purpose are defined here, so the workers
import this module: it imports no JAX at the top.
"""

import io
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from occuspytial_tpu_torch import (
    LogitICARGibbs,
    LogitRSRGibbs,
    ProbitICARGibbs,
    ProbitRSRGibbs,
)
from occuspytial_tpu_torch import diagnostics as dg
from occuspytial_tpu_torch.parallel import (
    chain_mesh,
    sample_parallel,
    shard_chains,
)
from occuspytial_tpu_torch.utils import make_data

torch.set_num_threads(1)

Q, W, X, y, *_ = make_data(n=150, ns=100, p=3, q=2, random_state=10)
MESH = ['cpu'] * 4
RTOL, ATOL = 2e-4, 1e-5


class _RaisingSampler(LogitRSRGibbs):
    def _run(self, carry, size, bars=()):
        raise ValueError('this worker fails on purpose')


class _DyingSampler(LogitRSRGibbs):
    def _run(self, carry, size, bars=()):
        os._exit(3)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope='module')
def rsr_runs():
    s = LogitRSRGibbs(Q, W, X, y, random_state=10, device='cpu')
    post = sample_parallel(s, size=6, burnin=2, chains=8,
                           mesh=chain_mesh(devices=MESH))
    carry = s.final_carry
    local = s.sample(6, burnin=2, chains=8, progressbar=False)
    return s, post, carry, local


def test_sharded_chains_shapes(rsr_runs):
    s, post, carry, _ = rsr_runs
    assert post['alpha'].shape == (8, 4, 2)
    assert post['tau'].shape == (8, 4)
    assert not np.allclose(post['alpha'][0], post['alpha'][1])
    assert carry.step == 6 and carry.keys.shape == (8, 2)
    assert len(s.worker_seconds) == len(MESH)


def test_sharded_matches_single_device(rsr_runs):
    s, post, carry, local = rsr_runs
    for name in ('alpha', 'beta', 'tau'):
        _close(post[name], local[name])
    assert torch.equal(carry.keys, s.final_carry.keys)
    for name, val in carry.states.items():
        _close(val.numpy(), s.final_carry.states[name].numpy())


def test_chain_count_must_divide():
    s = LogitRSRGibbs(Q, W, X, y, random_state=10, device='cpu')
    with pytest.raises(ValueError, match='multiple of the mesh size'):
        sample_parallel(s, size=4, chains=3, mesh=MESH)
    with pytest.raises(ValueError, match='multiple of the mesh size'):
        shard_chains(s.init_carry(3), MESH)
    with pytest.raises(ValueError, match='burnin'):
        sample_parallel(s, size=4, burnin=4, chains=4, mesh=MESH)


def test_chains_must_be_positive():
    """The JAX package's error, letter for letter, before any carry is
    made (``init_carry`` at 0 chains fails inside a reshape)."""
    s = LogitRSRGibbs(Q, W, X, y, random_state=10, device='cpu')
    s.init_carry = None  # never reached
    with pytest.raises(ValueError) as err:
        sample_parallel(s, size=4, chains=0, mesh=MESH)
    assert str(err.value) == 'chains must a positive integer.'


def test_submesh():
    s = LogitRSRGibbs(Q, W, X, y, random_state=10, device='cpu')
    mesh = chain_mesh(n_devices=2, devices=MESH)
    assert len(mesh) == 4
    mesh = chain_mesh(devices=MESH[:2])
    # one progress bar over both workers
    post = sample_parallel(s, size=4, chains=4, mesh=mesh, progressbar=True)
    assert post['alpha'].shape == (4, 4, 2)


def test_chain_mesh_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        chain_mesh()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        chain_mesh(devices=['cuda:0'])


@pytest.mark.parametrize('make', [
    lambda: ProbitICARGibbs(Q, W, X, y, random_state=4, device='cpu'),
    lambda: ProbitICARGibbs(sps.csr_matrix(Q), W, X, y, random_state=4,
                            solver='graph', device='cpu'),
    lambda: ProbitRSRGibbs(Q, W, X, y, random_state=4, device='cpu'),
], ids=['probit-icar-spectral', 'probit-icar-graph', 'probit-rsr'])
def test_probit_sharded_matches_single_device(make):
    s = make()
    post = sample_parallel(s, size=6, chains=8, mesh=MESH)
    local = s.sample(6, chains=8, progressbar=False)
    for name in ('beta', 'tau'):
        _close(post[name], local[name])


@pytest.fixture(scope='module')
def cg_runs():
    """LogitICARGibbs 'cg': 4 steps over the mesh, its carry, and one
    8-step run in one process."""
    s = LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                       device='cpu')
    post = sample_parallel(s, size=4, chains=8, mesh=MESH)
    carry = s.final_carry
    local = s.sample(4, chains=8, progressbar=False)
    return s, post, carry, local


def test_logit_cg_warm_carry_matches_single_device(cg_runs):
    s, post, carry, local = cg_runs
    for name in ('alpha', 'beta', 'tau'):
        _close(post[name], local[name])
    # the CG's warm start and the residual maximum travel in the carry
    assert carry.states['eta_warm'].shape == (8, 6, s.n)
    _close(carry.states['eta_warm'].numpy(),
           s.final_carry.states['eta_warm'].numpy())
    assert 0.0 < float(carry.states['solver_resid'].max()) < 0.2


def test_final_carry_resumes(cg_runs):
    s, post, carry, _ = cg_runs
    rest = s.sample(4, chains=8, progressbar=False, resume_from=carry)
    whole = s.sample(8, chains=8, progressbar=False)
    for name in ('alpha', 'beta', 'tau'):
        _close(np.concatenate([post[name], rest[name]], axis=1),
               whole[name])


def test_guardrail_raises_in_parent_with_carry_set():
    # the in-run residual passes 5e-3 within 30 steps on this data (the
    # cold-start check reads under it), so the run trips the guardrail
    s = LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                       solver_check_tol=5e-3, device='cpu')
    with pytest.raises(RuntimeError, match='resumable'):
        sample_parallel(s, size=30, chains=8, mesh=MESH)
    assert s.final_carry.step == 30
    assert s.final_carry.keys.shape == (8, 2)
    assert s.last_solver_resid > 5e-3


def test_failing_worker_raises():
    s = _RaisingSampler(Q, W, X, y, random_state=10, device='cpu')
    with pytest.raises(RuntimeError,
                       match='(?s)fails on purpose.*exit code 1'):
        sample_parallel(s, size=4, chains=2, mesh=MESH[:2])
    assert not hasattr(s, 'final_carry')


def test_dying_worker_raises():
    s = _DyingSampler(Q, W, X, y, random_state=10, device='cpu')
    with pytest.raises(RuntimeError, match='died.*\n.*exit code 3'):
        sample_parallel(s, size=4, chains=2, mesh=MESH[:2])


def _tensors(obj):
    """Every tensor reachable from ``obj``, found by pickling it."""
    found = []

    class Finder(pickle.Pickler):
        def persistent_id(self, o):
            if isinstance(o, torch.Tensor):
                found.append(o)
                return len(found)
            return None

    Finder(io.BytesIO()).dump(obj)
    return found


@pytest.mark.parametrize('make', [
    lambda: LogitICARGibbs(Q, W, X, y, random_state=4, solver='cg',
                           device='cpu'),
    lambda: ProbitICARGibbs(sps.csr_matrix(Q), W, X, y, random_state=4,
                            solver='graph', device='cpu'),
], ids=['logit-cg', 'probit-graph'])
def test_moved_reaches_every_tensor_and_round_trips(make):
    s = make()
    s.sample(2, chains=2, progressbar=False)  # a final_carry to move too
    assert len(_tensors(s)) > 10
    meta = s._moved('meta')
    assert meta.device == torch.device('meta')
    assert all(t.device.type == 'meta' for t in _tensors(meta))
    # the original is untouched
    assert all(t.device.type == 'cpu' for t in _tensors(s))
    # through pickle and back, as a worker gets it: one step, same bits
    back = pickle.loads(pickle.dumps(s._moved('cpu')))._moved('cpu')
    carry = s.init_carry(2)
    one = s._run(carry, 1)[1]
    two = back._run(carry, 1)[1]
    for name in one:
        assert torch.equal(one[name], two[name])


def test_port_parallel_means_match_jax_parallel():
    """The slice as a whole: the port's sample_parallel against the JAX
    sample_parallel on its 8 virtual devices, by posterior means."""
    from occuspytial_tpu import LogitRSRGibbs as JaxRSR
    from occuspytial_tpu.parallel import chain_mesh as jax_mesh
    from occuspytial_tpu.parallel import sample_parallel as jax_parallel

    size, burnin = 400, 100
    jpost = jax_parallel(JaxRSR(Q, W, X, y, random_state=3), size=size,
                         burnin=burnin, chains=8, mesh=jax_mesh())
    s = LogitRSRGibbs(Q, W, X, y, random_state=3, device='cpu')
    post = sample_parallel(s, size=size, burnin=burnin, chains=8,
                           mesh=MESH)
    for name, dim in (('alpha', 2), ('beta', 3)):
        for j in range(dim):
            ratio = dg.mean_z_ratio(post[name][:, :, j],
                                    jpost[name][:, :, j])
            assert ratio < 1.0, (name, j, ratio)
