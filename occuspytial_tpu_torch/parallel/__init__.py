"""Chains over worker processes, one per device of a mesh.

Port of the JAX package's ``parallel/__init__.py`` (chain parallelism;
the reference's joblib pool, reference gibbs/parallel.py:4-42). Chains
never talk to each other, so :func:`sample_parallel` splits them into
contiguous runs and runs each run in a worker process of its own on its
mesh device: the workers need no communication in the hot loop, and each
has its own host thread to enqueue its steps, which one host-bound
process cannot give a card. The chains' keys and initial states are made
once in the parent (:meth:`~..models.base.GibbsBase.init_carry`), so
chain c draws what it draws in one process, whatever the mesh.

The mesh is a list of torch devices. A device may appear more than once,
one worker each: that is how one card (or the CPU) runs a mesh of
several.

The site-sharded solves of the lattice and graph regimes are in
:mod:`.sharded_stencil` and :mod:`.sharded_graph`.
"""

import pickle
import time

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from ..models.base import Carry
from ..ops.cuda_cg import icar_cg_solve_cuda
from ..ops.cuda_pg import pg_devroye_cuda
from ..posterior import PosteriorParameter
from ._spmd import Workers

#: the kernel wrappers whose launches the workers report to the parent
_COUNTERS = (pg_devroye_cuda, icar_cg_solve_cuda)


def chain_mesh(n_devices=None, devices=None):
    """A 1-D chain mesh: a list of torch devices, one worker each.

    Default: every visible CUDA card (the first ``n_devices``); raises
    without CUDA. ``devices`` names the entries instead, repeats allowed
    (``['cuda:0'] * 2``, ``['cpu'] * 4``).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass devices=["cpu", ...] to run '
                'the chains on the CPU'
            )
        devices = [f'cuda:{i}' for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return [resolve_device(d) for d in devices]


def _chain_runs(carry, parts):
    """Split a carry by chain into ``parts`` contiguous runs (the chain
    count must divide by ``parts``)."""
    chains = carry.keys.shape[0]
    if chains % parts:
        raise ValueError(
            f'chains ({chains}) must be a multiple of the mesh size '
            f'({parts})'
        )
    per = chains // parts
    return [
        Carry(carry.keys[i * per:(i + 1) * per],
              {k: v[i * per:(i + 1) * per] for k, v in carry.states.items()},
              carry.step)
        for i in range(parts)
    ]


def _carry_to(carry, device):
    return Carry(
        carry.keys.to(device),
        {k: v.to(device) for k, v in carry.states.items()},
        carry.step,
    )


def shard_chains(carry, mesh):
    """Split a carry by chain into contiguous runs, run i on ``mesh[i]``
    (the chain count must divide by the mesh size)."""
    return [_carry_to(run, dev)
            for run, dev in zip(_chain_runs(carry, len(mesh)), mesh)]


class _Progress:
    """The worker's stand-in for a progress bar: one message a step."""

    def __init__(self, conn):
        self.conn = conn

    def update(self, k):
        self.conn.send(('progress', k))


def _sample_worker(conn, device, progress):
    """Worker body: receive the pickled CPU sampler and carry run, move
    both to ``device``, run them, send the draws, the final carry and the
    kernel launch counts back as numpy."""
    device = torch.device(device)
    if device.type == 'cpu':
        torch.set_num_threads(1)
    sampler, size = pickle.loads(conn.recv_bytes())
    sampler = sampler._moved(device)
    carry = _carry_to(conn.recv(), device)
    bars = [_Progress(conn)] if progress else []
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    carry, out = sampler._run(carry, size, bars)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    conn.send(('result', {
        'draws': {k: v.cpu().numpy() for k, v in out.items()},
        'keys': carry.keys.cpu().numpy(),
        'states': {k: v.cpu().numpy() for k, v in carry.states.items()},
        'step': carry.step,
        'launches': [c.launches for c in _COUNTERS],
        'seconds': seconds,
    }))


def sample_parallel(
    sampler, size, burnin=0, start=None, chains=None, mesh=None,
    progressbar=False,
):
    """Run ``sampler`` with its chains split over the mesh's workers.

    The calling convention of reference gibbs/parallel.py:4-42 and of the
    JAX ``sample_parallel``: ``chains`` defaults to one per mesh entry
    and must be a multiple of the mesh size; ``mesh`` defaults to
    :func:`chain_mesh`. Returns a
    :class:`~..posterior.PosteriorParameter` whose chains are in the
    order one process would give, sets ``sampler.final_carry`` (on the
    sampler's device) and ``sampler.worker_seconds`` (each worker's
    sampling seconds), and adds the workers' kernel launches to the
    wrappers' counts. A tripped solver guardrail raises after the carry
    is set, as :meth:`~..models.base.GibbsBase.sample` does. A worker that
    fails makes this raise with its message. ``progressbar``: one bar
    counting the steps every worker has enqueued.
    """
    if mesh is None:
        mesh = chain_mesh()
    mesh = [torch.device(d) for d in mesh]
    if chains is None:
        chains = len(mesh)
    if burnin >= size:
        raise ValueError('burnin value cannot be larger than sample size')

    cpu = torch.device('cpu')
    carry = sampler.init_carry(chains, start)
    runs = [_carry_to(run, cpu) for run in _chain_runs(carry, len(mesh))]
    shipped = sampler._moved(cpu)
    shipped.__dict__.pop('final_carry', None)
    if any(d.type == 'cuda' for d in mesh):
        # once here, not once in every worker
        _build.build()
    # the sampler (its eigenbasis or deflation basis included) is
    # pickled once and the same bytes go to every worker
    payload = pickle.dumps((shipped, size))

    bars = sampler._progress_bars(bool(progressbar), size, 1)
    done = [0] * len(mesh)

    def on_progress(i, k):
        low = min(done)
        done[i] += k
        for bar in bars:
            bar.update(min(done) - low)

    # the payload goes over the pipes once every worker has started: as
    # a process argument, it would hold up each next start until its
    # worker had imported the package
    workers = Workers(
        _sample_worker, [(str(d), bool(bars)) for d in mesh],
        [str(d) for d in mesh],
    )
    try:
        for i, run in enumerate(runs):
            workers.send_bytes(i, payload)
            workers.send(i, run)
        results = workers.gather(on_progress)
    finally:
        workers.close()
        for bar in bars:
            bar.close()

    dev = sampler.device
    sampler.final_carry = Carry(
        torch.as_tensor(np.concatenate([r['keys'] for r in results]),
                        device=dev),
        {name: torch.as_tensor(
            np.concatenate([r['states'][name] for r in results]),
            device=dev)
         for name in results[0]['states']},
        results[0]['step'],
    )
    sampler.worker_seconds = [r['seconds'] for r in results]
    for i, counter in enumerate(_COUNTERS):
        counter.launches += sum(r['launches'][i] for r in results)
    sampler._check_run_solver_health(sampler.final_carry)
    merged = {
        name: np.moveaxis(
            np.concatenate([r['draws'][name] for r in results], axis=1),
            0, 1,
        )[:, burnin:]
        for name in results[0]['draws']
    }
    return PosteriorParameter(merged)
