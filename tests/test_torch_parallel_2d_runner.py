"""The runner layer on the ranks of the port's 2-D (chains x sites) sampler.

The JAX package runs ``sample_parallel_2d`` through ``sample(...,
resume_from=carry)``: one compiled scan a chunk, ``_resolve_chunk`` on the
global shapes, and each chunk's ``track``-ed draws moved to the host as
the chunk ends. The port's ranks run their bands through the same chunk
loop (``GibbsBase._run``), in chunks of one length that
``sample_parallel_2d`` resolves on the unsharded carry. These tests run a
1 x 2 gloo world of CPU ranks on a small logit lattice: each rank's
``track``-ed eta reaches its host one chunk at a time, ``scan_chunk`` is
honoured, and neither changes a draw against the one-chunk run. They
hold the chunk rule against the JAX package's ``_resolve_chunk`` on the
same global state (an RSR carry included), and the runner each band
picks: the host loop under gloo, when timed and off the card; the
captured step under NCCL on the card.

The sampler class below runs in the ranks, which import this module: it
imports no JAX at the top.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import make_lattice_dataset
from occuspytial_tpu_torch import LogitICARGibbs, LogitRSRGibbs
from occuspytial_tpu_torch.models.base import GibbsBase
from occuspytial_tpu_torch.parallel import (
    mesh_2d,
    sample_parallel_2d,
    shard_sampler_2d,
)
from occuspytial_tpu_torch.parallel._spmd import Workers, send_result
from occuspytial_tpu_torch.parallel.sharded_stencil import BandSites

torch.set_num_threads(1)

SIZE, CHAINS = 10, 2


@functools.lru_cache(maxsize=None)
def _lattice():
    return make_lattice_dataset(8, 8, ns=40, seed=3)[:4]


class SpyLogit(LogitICARGibbs):
    """``LogitICARGibbs`` whose ranks log, to the file named by
    ``spy_log``, each chunk the host loop runs and each chunk's move to
    the host: one line each, ``rank run length`` or ``rank host length
    device``."""

    spy_log = None

    def _log(self, *words):
        with open(self.spy_log, 'a') as f:
            f.write(' '.join(str(w) for w in (dist.get_rank(),) + words)
                    + '\n')

    def _run_eager(self, carry, size, clock=None):
        self._log('run', size)
        return super()._run_eager(carry, size, clock)

    def _chunk_to_host(self, out, track):
        moved = super()._chunk_to_host(out, track)
        self._log('host', moved['eta'].shape[0], moved['eta'].device.type)
        return moved


def _card_chunk(self, size, with_bar, states, device=None):
    """The chunk rule as on the card (the CPU's is a fixed 64)."""
    return GibbsBase._resolve_chunk(self, size, with_bar, states,
                                    torch.device('cuda'))


def _spy(log, **attrs):
    s = SpyLogit(*_lattice(), random_state=4, lattice=(8, 8, 8),
                 device='cpu')
    s.track = ('eta',)
    s.spy_log = str(log)
    for k, v in attrs.items():
        setattr(s, k, v)
    return s


def _read(log):
    """rank -> its log lines, each split into words."""
    out = {}
    for line in log.read_text().splitlines():
        rank, *words = line.split()
        out.setdefault(int(rank), []).append(words)
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The 1 x 2 gloo run in one chunk, in the card's chunks under a
    budget of 4 draws of the whole field's eta, and in ``scan_chunk=3``
    chunks: name -> (sampler, posterior, its ranks' logs)."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name in ('one', 'budget', 'scan'):
            log = tmp_path_factory.mktemp(name) / 'log'
            log.touch()
            if name == 'one':
                s = _spy(log, scan_chunk=SIZE)
            elif name == 'scan':
                s = _spy(log, scan_chunk=3)
            else:
                s = _spy(log)
                per_draw = CHAINS * s.n * 4
                s._auto_chunk_output_budget = 4 * per_draw + 1
                mp.setattr(SpyLogit, '_resolve_chunk', _card_chunk)
            post = sample_parallel_2d(s, SIZE, mesh_2d(1, 2, ['cpu'] * 2),
                                      chains=CHAINS)
            mp.undo()
            out[name] = (s, post, _read(log))
    finally:
        mp.undo()
    return out


def _same_run(a, b):
    (sa, pa, _), (sb, pb, _) = a, b
    for name in ('alpha', 'beta', 'tau', 'eta'):
        np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)
    assert sa.final_carry.step == sb.final_carry.step == SIZE
    assert torch.equal(sa.final_carry.keys, sb.final_carry.keys)
    for name, val in sb.final_carry.states.items():
        assert torch.equal(sa.final_carry.states[name], val), name


def test_each_chunk_goes_to_the_host_as_it_ends(runs):
    """(a) Under a budget of 4 draws of the field's eta, reckoned on the
    global shapes (a band holds half of them, which would give 8), every
    rank runs 4, 4 and 2 steps, each chunk's eta going to its host
    before the next chunk runs; the run is the one-chunk run, bit for
    bit, ``track``-ed eta joined over the bands included."""
    s, post, logs = runs['budget']
    want = [['run', '4'], ['host', '4', 'cpu'], ['run', '4'],
            ['host', '4', 'cpu'], ['run', '2'], ['host', '2', 'cpu']]
    assert logs == {0: want, 1: want}
    assert post['eta'].shape == (CHAINS, SIZE, 64)
    _same_run(runs['budget'], runs['one'])
    assert runs['one'][2] == {r: [['run', str(SIZE)],
                                  ['host', str(SIZE), 'cpu']]
                              for r in (0, 1)}
    # the host loop on the CPU, one clock entry a step
    assert [r['captured'] for r in s.rank_runs] == [False, False]
    assert [len(t) for t in s.rank_step_seconds] == [SIZE, SIZE]


def test_scan_chunk_is_honoured_on_the_2d_path(runs):
    """(b) ``scan_chunk=3`` cuts every rank's run into 3, 3, 3 and 1
    steps, and changes no draw."""
    _, _, logs = runs['scan']
    lengths = [w[1] for w in logs[0] if w[0] == 'run']
    assert lengths == ['3', '3', '3', '1'] and logs[1] == logs[0]
    _same_run(runs['scan'], runs['one'])


def test_2d_chunk_matches_the_jax_rule_on_the_global_state(monkeypatch):
    """(c) The chunk length ``sample_parallel_2d`` resolves (the
    sampler's ``_resolve_chunk`` on the unsharded carry, for the ranks'
    device) is the JAX package's ``_resolve_chunk`` on the same global
    state: on the CPU and on an accelerator, with and without a bar and
    an explicit ``scan_chunk``, ``track``-ing a site field and an RSR
    eta (chains, q), which the band does not cut."""
    import jax

    jax.config.update('jax_platforms', 'cpu')
    from occuspytial_tpu import LogitICARGibbs as JaxLogit
    from occuspytial_tpu import LogitRSRGibbs as JaxRSR
    from occuspytial_tpu.models import base as jbase

    data = _lattice()
    pairs = [
        (LogitICARGibbs(*data, random_state=1, lattice=(8, 8, 8),
                        device='cpu'),
         JaxLogit(*data, random_state=1, lattice=(8, 8, 8))),
        (LogitRSRGibbs(*data, random_state=1, q=6, device='cpu'),
         JaxRSR(*data, random_state=1, q=6)),
    ]
    sizes = [(1000, False), (3008, False), (3008, True), (100, True),
             (7, True)]
    card, cpu = torch.device('cuda'), torch.device('cpu')
    chains = 4096
    for ts, js in pairs:
        states = ts.init_carry(chains).states
        jstates = js.init_carry(chains)[1]
        assert {k: tuple(v.shape) for k, v in states.items()} == \
            {k: tuple(v.shape) for k, v in jstates.items()}
        for backend, device in (('cpu', cpu), ('gpu', card)):
            monkeypatch.setattr(jbase.jax, 'default_backend',
                                lambda b=backend: b)
            for chunk in (None, 17):
                for track in ((), ('eta',), ('eta', 'z')):
                    js.scan_chunk = ts.scan_chunk = chunk
                    js.track = ts.track = track
                    for size, bar in sizes:
                        assert ts._resolve_chunk(size, bar, states,
                                                 device) == \
                            js._resolve_chunk(size, bar, jstates), \
                            (type(ts).__name__, backend, chunk, track, size)
    # the RSR eta is (chains, q) whole: its budget cap counts q, not n
    rsr = pairs[1][0]
    rsr.scan_chunk, rsr.track = None, ('eta',)
    assert rsr._resolve_chunk(10 ** 6, False, rsr.init_carry(chains).states,
                              card) == (256 << 20) // (chains * 6 * 4)


def test_band_runner_is_decided_by_the_configuration(monkeypatch):
    """(d) Before anything runs, a band on the card replays the captured
    step when its ``sites`` group is NCCL's, and runs the host loop when
    it is gloo's, when the band is timed, off the card, with
    ``pg_method='devroye'`` and with ``_force_eager``. The card is a stub
    device here, and so are the groups: nothing is launched."""
    gloo, nccl = object(), object()
    monkeypatch.setattr(dist, 'get_backend',
                        lambda group=None: {id(gloo): 'gloo',
                                            id(nccl): 'nccl'}[id(group)])
    s = LogitICARGibbs(*_lattice(), random_state=4, lattice=(8, 8, 8),
                       device='cpu', pg_method='pallas_packed')
    view = shard_sampler_2d(s, s.init_carry(2),
                            mesh_2d(1, 2, ['cpu'] * 2))[0][0]

    def band(group, timed=False, device='cuda', **attrs):
        b = view._moved('cpu')
        b.device = torch.device(device)
        b._sites = BandSites(group, timed)
        for k, v in attrs.items():
            setattr(b, k, v)
        return b._runs_eagerly()

    assert not band(nccl)
    assert band(gloo)
    assert band(nccl, timed=True)
    assert band(gloo, timed=True)
    assert band(nccl, device='cpu')
    assert band(nccl, pg_method='devroye')
    assert band(nccl, _force_eager=True)
    # the whole field in one process: captured on the card
    card = s._moved('cpu')
    card.device = torch.device('cuda')
    assert not card._runs_eagerly()
    card._force_eager = True
    assert card._runs_eagerly()


def _answer(conn, n):
    """Worker body: an answer holding arrays above and below the piece
    size, in dicts, lists and tuples."""
    gen = np.random.default_rng(n)
    send_result(conn, {
        'big': gen.standard_normal(n),
        'parts': [np.arange(7), (gen.integers(0, 9, (3, n // 3)), 'tag')],
        'empty': np.zeros((0, 4), np.float32),
        'step': 5,
    })


def test_large_answers_arrive_whole_in_pieces():
    """A rank's answer goes over its pipe with each array over 1 MiB sent
    after it in 1 MiB pieces (a 2-D rank's ``track``-ed draws are GBs at
    config 5): every array arrives with its shape, dtype and bits."""
    n = (3 << 20) // 8 + 123  # 3 MiB of float64 and a piece's remainder
    workers = Workers(_answer, [(n,)], ['answer'])
    try:
        [got] = workers.gather()
    finally:
        workers.close()
    gen = np.random.default_rng(n)
    np.testing.assert_array_equal(got['big'], gen.standard_normal(n))
    assert got['big'].dtype == np.float64
    np.testing.assert_array_equal(got['parts'][0], np.arange(7))
    ints, tag = got['parts'][1]
    np.testing.assert_array_equal(ints, gen.integers(0, 9, (3, n // 3)))
    assert tag == 'tag' and got['step'] == 5
    assert got['empty'].shape == (0, 4) and got['empty'].dtype == np.float32


class FailingLogit(LogitICARGibbs):
    """A sampler whose ranks raise as they start to run."""

    def _run(self, *args, **kwargs):
        raise RuntimeError('this rank fails on purpose')


def _plain(cls=LogitICARGibbs):
    return cls(*_lattice(), random_state=4, lattice=(8, 8, 8), device='cpu')


def test_a_held_mesh_keeps_its_ranks_between_runs():
    """Inside ``with mesh:`` two runs go through one set of rank
    processes and draw what fresh ranks draw; a run that fails stops the
    ranks at once, the next run starts new ones, and the block's end
    stops them. Outside a block every run stops its ranks."""
    want = sample_parallel_2d(_plain(), 4, mesh_2d(1, 2, ['cpu'] * 2),
                              chains=2)
    mesh = mesh_2d(1, 2, ['cpu'] * 2)
    sample_parallel_2d(_plain(), 4, mesh, chains=2)
    assert mesh._world is None
    with mesh:
        runs = [sample_parallel_2d(_plain(), 4, mesh, chains=2)]
        world = mesh._world
        procs = list(world._workers.procs)
        runs.append(sample_parallel_2d(_plain(), 4, mesh, chains=2))
        assert mesh._world is world and all(p.is_alive() for p in procs)
        with pytest.raises(RuntimeError, match='fails on purpose'):
            sample_parallel_2d(_plain(FailingLogit), 4, mesh, chains=2)
        assert mesh._world is None
        assert not any(p.is_alive() for p in procs)
        runs.append(sample_parallel_2d(_plain(), 4, mesh, chains=2))
        procs = list(mesh._world._workers.procs)
    assert mesh._world is None and not any(p.is_alive() for p in procs)
    for post in runs:
        for name in ('alpha', 'beta', 'tau'):
            np.testing.assert_array_equal(post[name], want[name])
