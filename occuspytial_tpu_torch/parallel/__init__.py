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

:func:`sample_parallel_2d` adds the JAX package's second mesh axis,
``'sites'``, for every sampler and eta regime: every rank of a (chains x
sites) grid runs the sampler's own step on its chain run and its band of
sites (:func:`shard_sampler_2d`: lattice rows; a run of the graph's
sites in the original order with a run of its permuted blocks; else a
contiguous run of sites), drawing the words the whole field gives its
sites, and sums every reduction over the sites through its chain row's
process group. The JAX package partitions the unchanged compiled step
with GSPMD; no partitioner reaches into this port's kernels, so the band
step is written out (:class:`.sharded_stencil.BandOps`,
:class:`.sharded_graph.GraphBandOps`, :mod:`.sharded_dense`, the
samplers' ``_sites`` hook).
"""

import copy
import pickle
import time

import numpy as np
import torch

from .. import _build, rng
from .._device import resolve_device
from ..models.base import KERNEL_COUNTERS, Carry
from ..posterior import PosteriorParameter
from . import _spmd
from ._spmd import World, Workers
from .sharded_dense import SiteBand, check_extent, site_bands
from .sharded_dense import band_fixed as dense_band_fixed
from .sharded_graph import (
    GraphBand,
    GraphBandOps,
    band_fixed,
    check_bands,
    graph_bands,
)
from .sharded_stencil import BandOps, BandSites, bands


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
    """The worker's stand-in for a progress bar: one message a chunk
    (:meth:`..models.base.GibbsBase._run`)."""

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
    _spmd.send_result(conn, {
        'draws': {k: v.cpu().numpy() for k, v in out.items()},
        'keys': carry.keys.cpu().numpy(),
        'states': {k: v.cpu().numpy() for k, v in carry.states.items()},
        'step': carry.step,
        'launches': [c.launches for c in KERNEL_COUNTERS],
        'seconds': seconds,
    })


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
    if chains < 1:
        raise ValueError('chains must a positive integer.')
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

    sampler.worker_seconds = [r['seconds'] for r in results]
    return _merge(sampler, [[r] for r in results], set(), burnin)


def _merge(sampler, rows, cut, burnin):
    """The end of a run over processes, from their results chain row by
    chain row (a row's site ranks joined by :func:`_gather_row`, ``cut``
    its site-sized entries): sets ``sampler.final_carry`` on the
    sampler's device, adds the kernel launches to the wrappers' counts,
    runs the solver health check and returns the posterior."""
    results = [r for row in rows for r in row]

    def gather(name, key, axis):
        return np.concatenate(
            [_gather_row(row, name, cut, key) for row in rows], axis=axis)

    draws = {name: gather(name, 'draws', 1) for name in results[0]['draws']}
    dev = sampler.device
    sampler.final_carry = Carry(
        torch.as_tensor(np.concatenate([row[0]['keys'] for row in rows]),
                        device=dev),
        {name: torch.as_tensor(gather(name, 'states', 0), device=dev)
         for name in results[0]['states']},
        results[0]['step'],
    )
    for i, counter in enumerate(KERNEL_COUNTERS):
        counter.launches += sum(r['launches'][i] for r in results)
    sampler._check_run_solver_health(sampler.final_carry)
    return PosteriorParameter({name: np.moveaxis(v, 0, 1)[:, burnin:]
                               for name, v in draws.items()})


# ----------------------- the 2-D (chains x sites) run ------------------- #

#: fixed-model arrays whose leading axis is the site axis (the regimes'
#: arrays are cut by :func:`_lattice_fixed`,
#: :func:`.sharded_graph.band_fixed` and :func:`.sharded_dense.band_fixed`)
_SITE_FIXED = ('X', 'obs', 'surveyed')
#: state entries laid out (chains, ..., n_sites) (but not an eta off the
#: sites, see :func:`_site_states`)
_SITE_STATE = ('z', 'k', 'eta', 'spatial', 'eps', 'omega_b', 'eta_warm')


class Mesh2D:
    """A (chains x sites) grid of torch devices, one rank each, and the
    backend of their process group (see :func:`mesh_2d`).

    Each :func:`sample_parallel_2d` call on the mesh starts its ranks (a
    process each, ~10 s on the card machine) and stops them when it
    returns. Inside ``with mesh:`` the ranks, their process group and
    their communicators stay up from one call to the next, as a JAX mesh
    keeps its devices, and stop when the block ends; a call that fails
    stops them at once."""

    def __init__(self, devices, backend):
        self.devices = [list(row) for row in devices]
        self.backend = backend
        self._world, self._held = None, False

    def __enter__(self):
        self._held = True
        return self

    def __exit__(self, *exc):
        self._held = False
        self._stop()

    def _ranks(self):
        """The mesh's ranks in one :class:`._spmd.World`, with a ``sites``
        subgroup per chain row: the running ones, or new ones."""
        if self._world is None:
            n_sites = self.shape['sites']
            devices = [d for row in self.devices for d in row]
            self._world = World(
                len(devices), devices, self.backend,
                subgroups=[range(c * n_sites, (c + 1) * n_sites)
                           for c in range(self.shape['chains'])],
            )
        return self._world

    def _stop(self):
        world, self._world = self._world, None
        if world is not None:
            world.close()

    @property
    def shape(self):
        """``{'chains': C, 'sites': S}``, as a JAX mesh's ``shape``."""
        return {'chains': len(self.devices), 'sites': len(self.devices[0])}

    def __repr__(self):
        return (f'Mesh2D({self.shape}, {self.backend}, '
                f'{[[str(d) for d in row] for row in self.devices]})')


def mesh_2d(chains=1, sites=None, devices=None, backend=None):
    """A 2-D ('chains', 'sites') mesh of ``chains x sites`` ranks.

    ``devices``: the ranks' devices, row-major (chain row by chain row),
    repeats allowed as in :func:`chain_mesh` (``['cuda:0'] * 4`` puts four
    ranks on one card, ``['cpu'] * 4`` runs on the CPU). Default: every
    visible CUDA card, one rank each (raises without CUDA), ``sites``
    defaulting to the cards over ``chains``. ``backend``: ``'nccl'`` when
    every rank has a card of its own, else ``'gloo'`` (NCCL refuses two
    ranks on one card; gloo takes CUDA tensors in ``all_reduce``). Used
    as ``with mesh:``, the mesh keeps its ranks up between runs
    (:class:`Mesh2D`).
    """
    if devices is None:
        devices = chain_mesh()
        if sites is None:
            sites = len(devices) // chains
        devices = devices[:chains * sites]
    devices = [resolve_device(d) for d in devices]
    if sites is None:
        sites = len(devices) // chains
    if chains < 1 or sites < 1 or len(devices) != chains * sites:
        raise ValueError(
            f'{len(devices)} devices for a {chains} x {sites} mesh'
        )
    if backend is None:
        own = len(set(devices)) == len(devices)
        backend = (
            'nccl' if own and all(d.type == 'cuda' for d in devices)
            else 'gloo'
        )
    rows = [devices[c * sites:(c + 1) * sites] for c in range(chains)]
    return Mesh2D(rows, backend)


def _site_states(sampler):
    """Names of the carry entries laid out (chains, ..., n sites): the
    :data:`_SITE_STATE` entries (``eta_warm`` a band of
    eigen-coefficients for the CG, as in the JAX layout), eta only where
    the sampler's field puts it on the sites (an RSR eta is (chains, q),
    in the Moran basis)."""
    return {n for n in _SITE_STATE if n != 'eta' or sampler._eta_on_sites}


def _check_2d(sampler, n_site_shards):
    """Raise unless the mesh's ``'sites'`` extent splits the sampler's
    field: the site count and the lattice rows, on a graph the site
    count and (banded) the block count, else the site count."""
    layout = sampler._band_layout
    if layout == 'graph':
        check_bands(sampler.graph, n_site_shards)
        return
    if layout == 'dense':
        check_extent(sampler.n, n_site_shards)
        return
    n, rows = sampler.n, sampler.lattice.rows
    if n % n_site_shards or rows % n_site_shards:
        raise ValueError(
            f"the 'sites' mesh extent {n_site_shards} must divide the "
            f'site count {n} (and the lattice rows {rows})'
        )


def _check_chains(chains, n_chain_rows):
    if chains < 1:
        raise ValueError('chains must a positive integer.')
    if chains % n_chain_rows:
        raise ValueError(
            f"chains ({chains}) must be a multiple of the 'chains' mesh "
            f'extent ({n_chain_rows})'
        )


def _lattice_fixed(fixed, band):
    """The lattice arrays of ``fixed`` as ``band`` holds them: the degree
    grid's rows and the DCT columns of its rows."""
    dense = torch.contiguous_format
    out = dict(fixed)
    out['lat_deg'] = fixed['lat_deg'][band.row0:band.row1].clone(
        memory_format=dense)
    out['lat_dct_r'] = fixed['lat_dct_r'][:, band.row0:band.row1].clone(
        memory_format=dense)
    return out


def _band_view(sampler, band):
    """The sampler as band ``band`` runs it: the site-indexed fixed
    arrays (:data:`_SITE_FIXED`), its share of the regime's arrays (the
    DCT columns of its rows, :func:`.sharded_graph.band_fixed`, or the
    rows of the field's dense ``_site_rows``), its
    visits and their layouts in band-local site indices, its draw plan
    (the field's words at its sites and edges) and the global lane of
    each column of its Pólya-Gamma draw (its sites, then its visits). The
    operators and the site hook are attached in the rank, which holds the
    group. Tensors are copied, so pickling ships only the band."""
    out = copy.copy(sampler)
    sl, vs = slice(band.site0, band.site1), slice(band.visit0, band.visit1)
    dense = torch.contiguous_format
    if isinstance(band, GraphBand):
        f = band_fixed(sampler.graph, sampler.fixed, band)
    elif isinstance(band, SiteBand):
        f = dense_band_fixed(sampler.fixed, band, sampler._site_rows)
    else:
        f = _lattice_fixed(sampler.fixed, band)
    for name in _SITE_FIXED:
        f[name] = f[name][sl].clone(memory_format=dense)
    for name in ('W_flat', 'y_flat'):
        f[name] = f[name][vs].clone(memory_format=dense)
    f['visit_site'] = f['visit_site'][vs] - band.site0
    out.fixed = f
    out.n = band.site1 - band.site0
    out._visit_site = sampler._visit_site[vs] - band.site0
    keep = (sampler._site_idx >= band.site0) & (sampler._site_idx
                                                 < band.site1)
    out._site_idx = sampler._site_idx[keep] - band.site0
    out._pad_mask = sampler._pad_mask[keep]
    out._pad_idx = torch.where(
        out._pad_mask, sampler._pad_idx[keep] - band.visit0, 0)
    out._plan = rng.DrawPlan(sampler._plan.counts, sampler.device,
                             sampler._band_tables(band))
    out._pg_lanes = torch.cat([
        torch.arange(band.site0, band.site1),
        sampler._field_n + torch.arange(band.visit0, band.visit1),
    ]).to(sampler.device)
    out._band = band
    return out


def shard_sampler_2d(sampler, carry, mesh):
    """Lay a sampler and its carry out over a 2-D ('chains', 'sites')
    mesh (the JAX ``shard_sampler_2d``'s layout): returns one
    ``(band sampler, carry part)`` pair per rank, row-major. Chain row c
    takes the c-th contiguous run of chains; site rank s of a row takes
    the s-th band of sites: the band view of the sampler (on the CPU,
    without its group) and the run's carry with its site-sized states
    (:func:`_site_states`) cut to the band's sites. The carry part is
    ``(keys, states, step)``.

    Serves every sampler and eta regime. On a lattice
    (``solver='stencil'``) a band is a run of lattice rows, and the
    ``'sites'`` extent must divide the site count and the lattice rows.
    On a graph (the JAX layout), site rank s takes the s-th contiguous
    run of sites in the original order and the s-th run of the permuted,
    padded blocks of the banded layout, so the extent must divide the
    site count and, banded, the block count ``n_pad / block`` (the ELL
    layout, ``graph_block=0``, has no blocks). Otherwise (the dense
    regimes ``'chol'``, ``'cg'`` and ``'spectral'``, and the RSR
    samplers) site rank s takes the s-th contiguous run of sites and its
    rows of the dense operators that only carry a site field in or out
    (the field's ``_site_rows``: the Moran basis K, the spectral
    eigenbasis U, else the ICAR noise factor B); Q, the CG's eigenbasis
    and the q-space products stay whole, as the JAX layout keeps them
    replicated; the extent must divide the site count. The chain count
    must divide by the ``'chains'`` extent."""
    n_rows, n_sites = mesh.shape['chains'], mesh.shape['sites']
    _check_2d(sampler, n_sites)
    _check_chains(carry.keys.shape[0], n_rows)
    cpu = torch.device('cpu')
    shipped = sampler._moved(cpu)
    shipped.__dict__.pop('final_carry', None)
    visit_site = np.asarray(shipped.data.visit_site)
    layout = shipped._band_layout
    if layout == 'graph':
        band_list = graph_bands(shipped.graph, shipped.fixed, visit_site,
                                n_sites)
    elif layout == 'stencil':
        band_list = bands(shipped.lattice, visit_site, n_sites)
    else:
        band_list = site_bands(shipped.n, visit_site, n_sites)
    views = [_band_view(shipped, b) for b in band_list]
    cut = _site_states(shipped)
    out = []
    for run in _chain_runs(_carry_to(carry, cpu), n_rows):
        for band, view in zip(band_list, views):
            states = {
                name: (v[..., band.site0:band.site1]
                       if name in cut else v).clone()
                for name, v in run.states.items()
            }
            out.append((view, (run.keys.clone(), states, run.step)))
    return out


#: steps of a 2-D rank before its collectives' timers restart (the first
#: steps pay the rank's cold costs: library handles, communicators)
_WARM_STEPS = 2


class _StepClock:
    """Each step's seconds in a rank of a 2-D run (``seconds``), marked by
    the runner (:meth:`..models.base.GibbsBase._run`): ``start`` before a
    chunk's first step, ``mark`` after each step, ``stop`` after its
    last.

    In the host loop (``events=False``) each mark synchronises the card
    and reads the host clock, and after :data:`_WARM_STEPS` steps the
    collectives' timers restart. Replaying a captured step
    (``events=True``) each mark records a CUDA event, with no host sync,
    and the chunk's events are read when it stops: a step's seconds are
    the card's, from the end of one replay to the end of the next."""

    def __init__(self, device, sites, events):
        self.device, self.sites, self.events = device, sites, events
        self.seconds = []
        self._marks, self._last = [], None

    def _now(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self):
        if self.events:
            self._marks = [self._event()]
        else:
            self._last = self._now()

    def mark(self):
        if self.events:
            self._marks.append(self._event())
            return
        now = self._now()
        self.seconds.append(now - self._last)
        self._last = now
        if len(self.seconds) == _WARM_STEPS:
            self.sites.seconds.clear()
            self.sites.calls.clear()

    def stop(self):
        if self.events:
            self._marks[-1].synchronize()
            self.seconds += [a.elapsed_time(b) / 1e3 for a, b in
                             zip(self._marks, self._marks[1:])]
            self._marks = []

    @staticmethod
    def _event():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event


def _sample_band(sampler, carry, size, chunk, progress, timed):
    """Rank body of :func:`sample_parallel_2d`: attach the band's
    operators (a lattice or a graph) and its site hook (its chain row's
    group) to the band sampler, run ``size`` steps from its carry part
    through the sampler's runner in chunks of ``chunk`` steps, and return
    the draws, the final carry, the kernel launches, each step's
    seconds, the runner's record and (timed) the collectives' seconds
    after the warm steps, as numpy."""
    device = _spmd.rank_device()
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    sampler = sampler._moved(device)
    band, group = sampler._band, _spmd.subgroup()
    if isinstance(band, SiteBand):
        sites = BandSites(group, timed, slice(band.site0, band.site1),
                          sampler._field_n)
    else:
        if isinstance(band, GraphBand):
            ops = GraphBandOps(band, sampler.graph, group, timed)
        else:
            ops = BandOps(band, group, timed)
        sampler._band_ops, sites = ops, ops.sites
    sampler._sites = sites
    keys, states, step = carry
    carry = _carry_to(Carry(keys, states, step), device)
    captured = not sampler._runs_eagerly()
    before = [c.launches for c in KERNEL_COUNTERS]
    clock = _StepClock(device, sites, events=captured)
    bars = [_Progress(_spmd.rank_conn())] if progress else []
    carry, out = sampler._run(carry, size, bars, chunk, clock)
    run = {'captured': captured, 'peak_bytes': None}
    if captured:
        graph = sampler._graph_runners[(carry.keys.shape[0],
                                        tuple(sampler.track))]
        run.update(capture_seconds=graph.capture_seconds,
                   per_replay=list(graph.per_replay), replays=graph.replays)
    if device.type == 'cuda':
        run['peak_bytes'] = torch.cuda.max_memory_allocated(device)
    return {
        'draws': {k: v.cpu().numpy() for k, v in out.items()},
        'keys': carry.keys.cpu().numpy(),
        'states': {k: v.cpu().numpy() for k, v in carry.states.items()},
        'step': carry.step,
        'launches': [c.launches - b
                     for c, b in zip(KERNEL_COUNTERS, before)],
        'step_seconds': np.asarray(clock.seconds),
        'run': run,
        'collective_seconds': dict(sites.seconds),
        'collective_calls': dict(sites.calls),
    }


def _gather_row(row, name, cut, key):
    """One chain row's entry ``name`` of ``row[*][key]``: the site-sized
    entries (the names in ``cut``, :func:`_site_states`) concatenated
    over the bands, the others from site rank 0 after a check that every
    site rank holds the same bits."""
    vals = [r[key][name] for r in row]
    if name in cut:
        return np.concatenate(vals, axis=-1)
    for s, v in enumerate(vals[1:], 1):
        if not np.array_equal(v, vals[0], equal_nan=True):
            raise RuntimeError(
                f'site rank {s} holds other {name!r} values than site '
                f'rank 0 of its chain row'
            )
    return vals[0]


def sample_parallel_2d(
    sampler, size, mesh, burnin=0, start=None, chains=None,
    progressbar=False, *, timed=False,
):
    """Run ``sampler`` over a 2-D ('chains', 'sites') mesh
    (:func:`mesh_2d`): the chains split into ``mesh.shape['chains']``
    runs, each run's sites into ``mesh.shape['sites']`` bands (lattice
    rows; on a graph a run of sites and a run of the banded layout's
    blocks; else a run of sites, :func:`shard_sampler_2d`), one rank per
    (run, band), joined in one process group with a ``sites`` subgroup per
    chain row. Draws match the unsharded sampler up to
    partitioned-reduction rounding (bit for bit on a 1 x 1 mesh).

    The JAX ``sample_parallel_2d``'s arguments and errors: ``chains``
    defaults to the ``'chains'`` extent and must be a positive multiple
    of it; the ``'sites'`` extent must divide the site count, and the
    lattice rows on a lattice or the banded layout's block count on a
    graph (``... block count ...``). Serves all four samplers in every eta
    regime: ``LogitICARGibbs`` (``'chol'``, ``'cg'`` with either
    ``cg_impl``, ``'stencil'``, ``'graph'`` banded or ELL, every
    ``pg_method``), ``ProbitICARGibbs`` (``'spectral'``, ``'stencil'``,
    ``'graph'``), ``LogitRSRGibbs`` and ``ProbitRSRGibbs``. A dense solve
    (``'chol'``, ``'cg'``) gathers its chain row's field and runs whole on
    every rank of the row (:mod:`.sharded_dense`). The carry and the
    cold-start solver check are made once, here, by
    ``sampler.init_carry``.

    Each rank runs its band as :meth:`~..models.base.GibbsBase.sample`
    runs one process (:meth:`~..models.base.GibbsBase._run`), in chunks
    of one length for every rank, resolved here by the JAX
    ``_resolve_chunk`` rule on the unsharded carry (an explicit
    ``sampler.scan_chunk`` wins; on the CPU 64; on the card the whole
    run, or about 16 chunks with a progress bar, capped so that one
    chunk's ``track``-ed draws over the whole mesh stay within the 256 MB
    budget), and moves each chunk's ``track``-ed draws to its host as the
    chunk ends. The progress bar ticks once a chunk. On the card a rank
    whose ``sites`` group is NCCL's replays its band step captured as one
    CUDA graph, the all-reduces inside it; a gloo rank, a timed rank and
    a CPU rank run the host loop (:meth:`~..models.base.GibbsBase.
    _runs_eagerly`). The draws are the same bits either way. The ranks
    start for the call and stop when it returns, or stay up between the
    calls made inside ``with mesh:`` (:class:`Mesh2D`).

    Returns a :class:`~..posterior.PosteriorParameter` in the chain order
    of one process; alpha, beta and tau (and an RSR sampler's eta) come
    from site rank 0 of each chain row, which must hold the same bits as
    its other site ranks; site-sized ``track`` entries are joined over
    the bands. Sets
    ``sampler.final_carry`` (gathered on the sampler's device; a tripped
    solver guardrail raises after it is set),
    ``sampler.rank_step_seconds`` (per rank, each step's seconds: in the
    host loop the host clock with the card synchronised after every step;
    replaying the captured step CUDA events recorded after each replay
    and read when the chunk ends, with no host sync between replays) and
    ``sampler.rank_runs`` (per rank, ``captured``: whether it replayed
    the captured step, then ``capture_seconds``, ``per_replay`` (each
    kernel's launches recorded in the graph) and ``replays``; and
    ``peak_bytes``, its card's peak allocated memory, None off the card),
    and adds the ranks' kernel launches to the wrappers' counts.
    ``timed=True`` also synchronises the card
    around every all-reduce of the ranks and sets
    ``sampler.rank_collectives``: per rank, label -> (seconds, calls)
    over the steps after the first two: ``'dct'`` for the lattice
    preconditioner's coefficient field; on a graph ``'perm'`` for the
    banded solve's moves to and from the block runs, ``'gather'`` for the
    ELL matvec's field vector, ``'halo'`` for the block halos; in a dense
    regime ``'field'`` for the gathers of the solve's operands and of eta
    for the quad form; ``'sum'`` for the other site sums.
    """
    n_rows, n_sites = mesh.shape['chains'], mesh.shape['sites']
    if chains is None:
        chains = n_rows
    _check_chains(chains, n_rows)
    if burnin >= size:
        raise ValueError('burnin value cannot be larger than sample size')
    _check_2d(sampler, n_sites)
    carry = sampler.init_carry(chains, start)
    parts = shard_sampler_2d(sampler, carry, mesh)
    devices = [d for row in mesh.devices for d in row]
    if any(d.type == 'cuda' for d in devices):
        _build.build()
    bars = sampler._progress_bars(bool(progressbar), size, 1)
    # one chunk length for every rank, from the global shapes: the mesh
    # holds at most one budget of track-ed draws, as the JAX package does
    chunk = sampler._resolve_chunk(size, bool(bars), carry.states,
                                   devices[0])

    def on_progress(r, k):
        for bar in bars:
            bar.update(k)

    try:
        results = mesh._ranks().run_each(
            _sample_band,
            [(view, part, size, chunk, bool(bars) and r == 0, timed)
             for r, (view, part) in enumerate(parts)],
            on_progress,
        )
    except BaseException:
        mesh._stop()
        raise
    finally:
        for bar in bars:
            bar.close()
    if not mesh._held:
        mesh._stop()

    sampler.rank_step_seconds = [r['step_seconds'] for r in results]
    sampler.rank_runs = [r['run'] for r in results]
    if timed:
        sampler.rank_collectives = [
            {k: (r['collective_seconds'][k], r['collective_calls'][k])
             for k in r['collective_calls']}
            for r in results
        ]
    rows = [results[c * n_sites:(c + 1) * n_sites] for c in range(n_rows)]
    return _merge(sampler, rows, _site_states(sampler), burnin)
