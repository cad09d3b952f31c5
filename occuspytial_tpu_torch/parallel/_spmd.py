"""Worker processes and per-rank worlds for the parallel package.

The JAX package runs chains and site shards as one SPMD program on a
device mesh (``jax.sharding``, ``jax.shard_map``). Here each mesh entry
is a process of its own, started with the ``spawn`` method (CUDA cannot
run in a forked child), with a pipe to the parent:

- :class:`Workers` starts one process per argument list and gathers one
  answer from each. A worker that raises sends its traceback and exits
  with code 1; a worker that dies closes its pipe. Either way the parent
  stops every worker and raises with the worker's message and exit code:
  it never waits on a dead worker and never returns part of the answers.
- :class:`World` keeps ``world`` ranks joined in one
  ``torch.distributed`` process group and runs per-rank functions on
  them, each rank given its contiguous slices of the global arrays on its
  device: the counterpart of ``jax.shard_map`` over a ``'sites'`` axis.
  The rendezvous is a file in a fresh temporary directory, so two worlds
  never race for a port.

Backends: ``gloo`` on the CPU, and on the card either ``gloo`` with CUDA
tensors (several ranks on one card: gloo stages ``all_reduce`` through
the host) or ``nccl`` (one rank per card; NCCL refuses two ranks on one
card). The sharded solves use ``all_reduce`` alone (see
:func:`exchange_halo`), the one collective both backends take on CUDA
tensors.

Functions sent to a worker or a rank are pickled by reference: they must
be importable by module path (no lambdas or closures).
"""

import multiprocessing
import os
import shutil
import sys
import tempfile
import traceback
from multiprocessing import connection

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

#: seconds the parent waits for a stopped worker to exit before killing it
_JOIN_SECONDS = 30


def _serve(conn, target, args):
    """Worker process body: ``target(conn, *args)`` sends its own
    answers; an exception is sent as its traceback and ends the process
    with exit code 1."""
    try:
        target(conn, *args)
    except BaseException:  # noqa: B036 - reported to the parent, then exit
        try:
            conn.send(('error', traceback.format_exc()))
        finally:
            conn.close()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
    conn.close()


class Workers:
    """One spawned process per entry of ``args_list``, each running
    ``target(conn, *args)`` with a duplex pipe ``conn`` to the parent.

    ``target`` answers with ``conn.send(('result', value))`` and may send
    ``('progress', k)`` before it. ``labels`` name the workers in errors.
    """

    def __init__(self, target, args_list, labels):
        ctx = multiprocessing.get_context('spawn')
        self.labels = list(labels)
        self.procs, self.conns = [], []
        try:
            for args in args_list:
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_serve, args=(child, target, args), daemon=True
                )
                proc.start()
                # the parent's copy of the child's end must close, or a
                # dead child's pipe would never read as closed
                child.close()
                self.procs.append(proc)
                self.conns.append(parent)
        except BaseException:
            self.close()
            raise

    def send(self, i, message):
        self.conns[i].send(message)

    def send_bytes(self, i, data):
        """Already pickled bytes, read with ``conn.recv_bytes()``."""
        self.conns[i].send_bytes(data)

    def gather(self, on_progress=None):
        """One answer from every worker, in worker order;
        ``on_progress(i, k)`` sees each progress message."""
        answers = {}
        pending = dict(enumerate(self.conns))
        while pending:
            for conn in connection.wait(list(pending.values())):
                i = self.conns.index(conn)
                try:
                    kind, value = conn.recv()
                except EOFError:
                    self._fail(i, 'died before it answered')
                if kind == 'progress':
                    if on_progress is not None:
                        on_progress(i, value)
                elif kind == 'error':
                    self._fail(i, f'raised:\n{value}')
                else:
                    answers[i] = value
                    del pending[i]
        return [answers[i] for i in range(len(self.conns))]

    def _fail(self, i, what):
        proc = self.procs[i]
        proc.join(_JOIN_SECONDS)
        code = proc.exitcode
        self.close()
        raise RuntimeError(
            f'worker {i} ({self.labels[i]}) {what}\n(exit code {code})'
        )

    def close(self):
        """Stop every worker that still runs and reap them all."""
        for proc in self.procs:
            if proc.is_alive():
                proc.terminate()
        for proc in self.procs:
            proc.join(_JOIN_SECONDS)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self.conns:
            conn.close()
        self.procs, self.conns = [], []


def _to_torch(tree, device):
    """numpy arrays of a nested tuple/list -> tensors on ``device``."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(t, device) for t in tree)
    return tree


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(t) for t in tree)
    return tree


def _rank_main(conn, rank, world, device, backend, init_method):
    """A rank: join the group, then run each task sent until ``None``."""
    device = torch.device(device)
    if device.type == 'cpu':
        torch.set_num_threads(1)
    else:
        resolve_device(device)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world
    )
    conn.send(('result', 'ready'))
    while True:
        task = conn.recv()
        if task is None:
            break
        fn, args = task
        out = fn(*_to_torch(args, device))
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        conn.send(('result', _to_numpy(out)))
    dist.destroy_process_group()


def split(tree, dims, rank, world):
    """Rank ``rank``'s contiguous slice of every array of ``tree`` along
    its entry of ``dims`` (a tree of the same shape; None passes the entry
    whole). Raises if a split dimension does not divide by ``world``."""
    if isinstance(tree, (list, tuple)) and isinstance(dims, (list, tuple)):
        return type(tree)(
            split(t, d, rank, world) for t, d in zip(tree, dims, strict=True)
        )
    if dims is None:
        return tree
    arr = np.asarray(tree)
    size = arr.shape[dims]
    if size % world:
        raise ValueError(
            f'the world size {world} must divide dimension {dims} of an '
            f'array of shape {arr.shape}'
        )
    step = size // world
    return np.take(arr, range(rank * step, (rank + 1) * step), axis=dims)


class World:
    """``world`` ranks in spawned processes, joined in one process group.

    ``devices``: one per rank (default ``'cuda:0'`` for each, raising
    without CUDA: pass ``['cpu'] * world`` to run on the CPU);
    ``backend``: ``'gloo'`` (CPU, or CUDA tensors with several ranks on a
    card) or ``'nccl'`` (one rank per card). Use as a context manager, or call
    :meth:`close`. The ranks start here and join their group while the
    caller goes on (several worlds start side by side); the first
    :meth:`run` waits for them.
    """

    def __init__(self, world, devices=None, backend='gloo'):
        if devices is None:
            devices = [resolve_device('cuda:0')] * world
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f'{len(devices)} devices for {world} ranks')
        self.world, self.devices, self.backend = world, devices, backend
        self._dir = tempfile.mkdtemp(prefix='occu-rdv-')
        init = 'file://' + os.path.join(self._dir, 'rdv')
        try:
            self._workers = Workers(
                _rank_main,
                [(r, world, str(d), backend, init)
                 for r, d in enumerate(devices)],
                [f'rank {r} on {d}, {backend}' for r, d in enumerate(devices)],
            )
        except BaseException:
            shutil.rmtree(self._dir, ignore_errors=True)
            raise
        self._joined = False

    def run(self, fn, args, dims, out_dim=-1):
        """``fn(*local_args)`` on every rank; returns its output (a tensor
        or a tuple of them) with each rank's part concatenated along
        ``out_dim``, as numpy.

        ``args`` is a tuple of arguments: numpy arrays (moved to each
        rank's device as tensors), nested tuples of them, or any other
        picklable value; ``dims`` the matching tree of split dimensions
        (None: the argument goes to every rank whole).
        """
        local = [split(args, dims, r, self.world) for r in range(self.world)]
        if not self._joined:
            self._workers.gather()
            self._joined = True
        for r in range(self.world):
            self._workers.send(r, (fn, local[r]))
        parts = self._workers.gather()
        if isinstance(parts[0], tuple):
            return tuple(
                np.concatenate(p, axis=out_dim) for p in zip(*parts)
            )
        return np.concatenate(parts, axis=out_dim)

    def close(self):
        try:
            if self._workers.procs:
                for r in range(self.world):
                    self._workers.send(r, None)
                for proc in self._workers.procs:
                    proc.join(_JOIN_SECONDS)
        finally:
            self._workers.close()
            shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def exchange_halo(local, group=None):
    """The neighbours' boundary rows of a band split over the group's
    ranks: returns ``(top, bottom)``, the previous rank's last row and the
    next rank's first row along dimension -2 of ``local`` (..., rows_local,
    width), zeros at the ends of the global band.

    One ``all_reduce``: each rank writes its first and last row into its
    own slot of a zero (world, 2, ..., width) buffer, and the sum over the
    ranks leaves every slot holding one rank's rows exactly (a sum with
    zeros), the values ``lax.ppermute`` would deliver.
    """
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    first, last = local[..., 0, :], local[..., -1, :]
    buf = local.new_zeros((world, 2) + tuple(first.shape))
    buf[rank, 0] = first
    buf[rank, 1] = last
    dist.all_reduce(buf, group=group)
    zero = torch.zeros_like(first)
    top = buf[rank - 1, 1] if rank > 0 else zero
    bottom = buf[rank + 1, 0] if rank < world - 1 else zero
    return top, bottom


def psum(x, group=None):
    """``lax.psum``: the sum of ``x`` over the group's ranks, written into
    ``x`` (callers pass a fresh tensor) and returned."""
    dist.all_reduce(x, group=group)
    return x
