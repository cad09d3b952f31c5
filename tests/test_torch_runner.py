"""The port's runner layer on the CPU: chunked runs and the chunk policy.

The JAX package serves a run in chunks of one compiled scan
(``models/base.py``: ``scan_chunk``, ``_resolve_chunk``, the chunk loop
of ``sample``). The port serves it in chunks too: on the card each chunk
is the replays of a captured step, elsewhere the host loop. These tests
hold the port's chunk policy against the JAX package's, show that
chunking never changes a draw (every sampler, every eta regime), that a
chunk's ``track``-ed draws go to the host as it ends, that the step
counter draws the same words as an int and as a device tensor, and that
no copy of a sampler carries a captured step.
"""

import copy
import functools
import pickle

import jax
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from chip_smoke import make_lattice_dataset
from occuspytial_tpu.models import base as jbase
from occuspytial_tpu.models.logit import LogitICARGibbs as JaxLogit
from occuspytial_tpu.utils import make_data as jmake_data
from occuspytial_tpu_torch import (
    LogitICARGibbs,
    LogitRSRGibbs,
    ProbitICARGibbs,
    ProbitRSRGibbs,
    rng,
)
from occuspytial_tpu_torch.models.base import _same_signature
from occuspytial_tpu_torch.utils import make_data

torch.set_num_threads(1)

HEAD = dict(n=150, ns=100, p=3, q=2, random_state=10)


@functools.lru_cache(maxsize=None)
def _head():
    return make_data(**HEAD)[:4]


@functools.lru_cache(maxsize=None)
def _lattice():
    return make_lattice_dataset(8, 8, ns=40, seed=3)[:4]


def _graph_q():
    q, w, x, y = _lattice()
    return (sps.csr_matrix(q), w, x, y)


#: every sampler, and both ICAR samplers' matrix-free regimes, at small n
CASES = {
    'logit-cg': lambda: LogitICARGibbs(*_head(), random_state=4,
                                       solver='cg', cg_iters=15,
                                       device='cpu'),
    'logit-rsr': lambda: LogitRSRGibbs(*_head(), random_state=4, q=8,
                                       device='cpu'),
    'probit-spectral': lambda: ProbitICARGibbs(*_lattice(), random_state=4,
                                               device='cpu'),
    'probit-rsr': lambda: ProbitRSRGibbs(*_lattice(), random_state=4,
                                         device='cpu'),
    'logit-stencil': lambda: LogitICARGibbs(*_lattice(), random_state=4,
                                            lattice=(8, 8, 8), device='cpu'),
    'logit-graph': lambda: LogitICARGibbs(*_graph_q(), random_state=4,
                                          solver='graph', device='cpu'),
    'probit-stencil': lambda: ProbitICARGibbs(*_lattice(), random_state=4,
                                              lattice=(8, 8, 8),
                                              device='cpu'),
    'probit-graph': lambda: ProbitICARGibbs(*_graph_q(), random_state=4,
                                            solver='graph', device='cpu'),
}


def _card_view(s):
    """A shallow copy of ``s`` whose device reads as a CUDA card (nothing
    runs on it): the card branch of the chunk policy."""
    card = copy.copy(s)
    card.device = torch.device('cuda')
    return card


# ------------------------- the chunk policy ----------------------------- #

def test_resolve_chunk_matches_the_jax_package(monkeypatch):
    """The port's ``_resolve_chunk`` is the JAX package's: on the CPU 64
    or an explicit ``scan_chunk``; on an accelerator (a CUDA device here,
    picked by the device's type) the whole run, ~16 ticks for a bar (at
    least 64 steps), and ``track``-ed draws capped at the 256 MB budget,
    as in the JAX test's table (tests/test_samplers.py:462-490)."""
    jax.config.update('jax_platforms', 'cpu')
    Q, W, X, y, *_ = jmake_data(**HEAD)
    js = JaxLogit(Q, W, X, y, random_state=1)
    ts = LogitICARGibbs(*_head(), random_state=1, device='cpu')
    assert ts.scan_chunk is None
    assert (ts._auto_chunk_output_budget
            == jbase.GibbsBase._auto_chunk_output_budget == 256 << 20)
    eta_j = {'eta': np.zeros((64, 1000), np.float32)}
    eta_t = {'eta': torch.zeros((64, 1000))}
    sizes = [(1000, False), (3008, False), (3008, True), (100, True),
             (100000, False), (7, True)]
    for chunk in (None, 17, 1):
        js.scan_chunk = ts.scan_chunk = chunk
        for track in ((), ('eta',)):
            js.track = ts.track = track
            for size, bar in sizes:
                assert ts._resolve_chunk(size, bar, eta_t) == \
                    js._resolve_chunk(size, bar, eta_j)
    js.scan_chunk = ts.scan_chunk = None
    js.track = ts.track = ()
    assert ts._resolve_chunk(1000, False, {}) == 64
    monkeypatch.setattr(jbase.jax, 'default_backend', lambda: 'gpu')
    card = _card_view(ts)
    for track in ((), ('eta',)):
        js.track = card.track = track
        for size, bar in sizes:
            assert card._resolve_chunk(size, bar, eta_t) == \
                js._resolve_chunk(size, bar, eta_j)
    card.track = ()
    assert card._resolve_chunk(3008, False, {}) == 3008
    assert card._resolve_chunk(3008, True, {}) == 188
    assert card._resolve_chunk(100, True, {}) == 64
    card.track = ('eta',)
    assert card._resolve_chunk(100000, False, eta_t) == \
        (256 << 20) // (64 * 1000 * 4)


def test_runner_policy_is_decided_by_the_configuration():
    """The host loop runs off the card and for the plain Pólya-Gamma
    sampler; everything else on the card replays the captured step (a
    band of a 2-D run calls the host loop itself, in
    ``parallel._sample_band``)."""
    s = LogitICARGibbs(*_head(), random_state=4, solver='cg', device='cpu')
    assert s._runs_eagerly()
    card = _card_view(s)
    assert card.pg_method == 'devroye' and card._runs_eagerly()
    card.pg_method = 'pallas_packed'
    assert not card._runs_eagerly()
    probit = _card_view(ProbitRSRGibbs(*_lattice(), random_state=4,
                                       device='cpu'))
    assert not probit._runs_eagerly()


# --------------------- chunking never changes a draw -------------------- #

@pytest.mark.parametrize('case', list(CASES))
def test_chunking_never_changes_the_draws(case):
    """``scan_chunk`` 1, 5 and None (64 on the CPU) give the same draws,
    the same ``track``-ed eta and z and the same final carry, bit for
    bit."""
    runs = []
    for chunk in (None, 1, 5):
        s = CASES[case]()
        s.scan_chunk = chunk
        s.track = ('eta', 'z')
        post = s.sample(12, burnin=2, chains=3, progressbar=False)
        runs.append((post, s.final_carry))
    (want, carry), rest = runs[0], runs[1:]
    for post, got in rest:
        for name in ('alpha', 'beta', 'tau', 'eta', 'z'):
            np.testing.assert_array_equal(post[name], want[name])
        assert got.step == carry.step == 12
        assert torch.equal(got.keys, carry.keys)
        for name, val in carry.states.items():
            assert torch.equal(got.states[name], val), name


def test_each_chunk_goes_to_the_host_as_it_ends(monkeypatch):
    """With a tiny output budget the card's policy cuts a ``track``-ed
    run into chunks; each chunk's draws go to the host right after the
    chunk runs, before the next one starts, and the bars tick once a
    chunk. The run is the unchunked run, bit for bit."""
    s = CASES['logit-cg']()
    s.track = ('eta',)
    per_draw = 3 * s.n * 4
    s._auto_chunk_output_budget = 4 * per_draw + 1
    card = _card_view(s)
    monkeypatch.setattr(s, '_resolve_chunk', card._resolve_chunk)
    log = []
    run_eager, to_host = s._run_eager, s._chunk_to_host

    def spy_run(carry, size, bars=()):
        log.append(('run', size))
        return run_eager(carry, size, bars)

    def spy_host(out, track):
        moved = to_host(out, track)
        log.append(('host', moved['eta'].shape[0],
                    moved['eta'].device.type))
        return moved

    class Bar:
        def update(self, k):
            log.append(('tick', k))

    monkeypatch.setattr(s, '_run_eager', spy_run)
    monkeypatch.setattr(s, '_chunk_to_host', spy_host)
    carry0 = s.init_carry(3)
    carry, out = s._run(carry0, 10, [Bar()])
    # a bar asks for at least 64 steps a chunk; the budget allows 4
    assert log == [('run', 4), ('host', 4, 'cpu'), ('tick', 4),
                   ('run', 4), ('host', 4, 'cpu'), ('tick', 4),
                   ('run', 2), ('host', 2, 'cpu'), ('tick', 2)]
    want_carry, want = run_eager(carry0, 10)
    for name, val in want.items():
        assert torch.equal(out[name], val), name
    for name, val in want_carry.states.items():
        assert torch.equal(carry.states[name], val), name


def test_cpu_bars_tick_once_a_chunk():
    """On the CPU a run goes in chunks of 64 steps and a bar ticks once
    a chunk, by the chunk's length."""
    s = CASES['logit-rsr']()
    ticks = []

    class Bar:
        def update(self, k):
            ticks.append(k)

    carry, out = s._run(s.init_carry(2), 100, [Bar()])
    assert ticks == [64, 36] and carry.step == 100
    assert out['tau'].shape == (100, 2)


# -------------------- the step counter as a tensor ---------------------- #

def test_draw_plan_takes_the_step_as_an_int_or_a_tensor():
    """``DrawPlan``, ``words`` and ``lane_words`` give step t's words for
    t an int and for t a 0-d int64 tensor on the keys' device; anything
    else as a tensor is refused."""
    keys = rng.chain_keys(9, 4, rng.RUN)
    plan = rng.DrawPlan({0: 2, 3: 17, 7: 64})
    lanes = torch.tensor([5, 0, 3], dtype=torch.int64)
    for t in (0, 1, 4097, 2 ** 32 + 5):
        step = torch.tensor(t, dtype=torch.int64)
        a, b = plan(keys, t), plan(keys, step)
        for uid in a:
            assert torch.equal(a[uid], b[uid])
        assert torch.equal(rng.words(keys, t, 3, 17),
                           rng.words(keys, step, 3, 17))
        assert torch.equal(rng.lane_words(keys, t, 2, lanes, 4),
                           rng.lane_words(keys, step, 2, lanes, 4))
    for bad in (torch.tensor(3, dtype=torch.int32),
                torch.tensor([3], dtype=torch.int64)):
        with pytest.raises(ValueError, match='0-d int64'):
            plan(keys, bad)


def test_tables_plan_takes_a_tensor_step():
    """A plan with a word table (a band of a 2-D run) draws the same
    words for an int and a tensor step."""
    keys = rng.chain_keys(2, 3, rng.RUN)
    table = rng.normal_words(torch.tensor([4, 1, 9]))
    plan = rng.DrawPlan({1: 40, 2: 6}, tables={1: table})
    a, b = plan(keys, 6), plan(keys, torch.tensor(6))
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    full = rng.DrawPlan({1: 40})(keys, 6)[1]
    assert torch.equal(a[1], full[:, table])


# ---------------- captured steps stay with their sampler ---------------- #

def test_copies_carry_no_captured_step():
    """``copy()``, ``copy.copy``, ``_moved()`` and pickling drop the
    cache of captured steps (a graph binds its sampler's addresses, and
    does not pickle); the sampler keeps its own."""
    s = CASES['logit-cg']()
    cache = {(2, ()): lambda: None}  # stands in for a graph: no pickling
    s._graph_runners = cache
    for other in (s.copy(), copy.copy(s), s._moved('cpu'),
                  pickle.loads(pickle.dumps(s))):
        assert '_graph_runners' not in vars(other)
        post = other.sample(3, chains=2, progressbar=False)
        assert post['tau'].shape == (2, 3)
    assert s._graph_runners is cache


def _tensors(obj, seen=None):
    """Every tensor reachable from ``obj`` through dicts, lists, tuples
    and the attributes of this package's objects."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif type(obj).__module__.startswith('occuspytial_tpu_torch') and \
            hasattr(obj, '__dict__'):
        items = vars(obj).values()
    else:
        return []
    return [t for v in items for t in _tensors(v, seen)]


def test_final_carry_aliases_nothing_the_sampler_keeps():
    """``final_carry`` shares no storage with a tensor the sampler holds,
    and a later run, resumed from it, leaves it as it was."""
    s = CASES['logit-stencil']()
    s.sample(4, chains=2, progressbar=False)
    kept = s.final_carry
    mine = {t.untyped_storage().data_ptr()
            for k, v in vars(s).items() if k != 'final_carry'
            for t in _tensors(v)}
    theirs = [kept.keys] + list(kept.states.values())
    assert not any(t.untyped_storage().data_ptr() in mine for t in theirs)
    saved = {k: v.clone() for k, v in kept.states.items()}
    s.sample(4, chains=2, progressbar=False, resume_from=kept)
    assert s.final_carry.step == 8
    for name, val in saved.items():
        assert torch.equal(kept.states[name], val), name


def test_graph_signature_follows_the_settings_the_step_reads():
    """A captured step is reused while the settings the step reads
    (``_STEP_SETTINGS``, a subclass's too), its fixed tensors, the
    non-fixed tensors and objects it reads and the carry's layout stay;
    changing any of them changes the signature, and how a run is chunked
    does not."""
    s = CASES['logit-cg']()
    carry = s.init_carry(2)
    sig = s._graph_signature(carry)

    def same():
        return _same_signature(s._graph_signature(carry), sig)

    s.scan_chunk = 7
    s._auto_chunk_output_budget = 123
    s.sample(2, chains=2, progressbar=False)
    assert same()
    s.cg_iters = 9
    assert not same()
    s.cg_iters = sig[0][s._STEP_SETTINGS.index('cg_iters')]
    assert same()
    s.pg_method = 'gamma'
    assert not same()
    s.pg_method = sig[0][s._STEP_SETTINGS.index('pg_method')]
    plan = s._plan
    s._plan = copy.copy(plan)
    assert not same()
    s._plan = plan
    assert same()
    s.fixed = dict(s.fixed, X=s.fixed['X'].clone())
    assert not same()
    assert not _same_signature(s._graph_signature(s.init_carry(3)),
                               s._graph_signature(carry))
