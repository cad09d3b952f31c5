"""The phase spans of the port's Gibbs step (``tracing.py``) on the host
loop: the span tree of each sampler, the counts of its phases, the draws
unchanged by tracing, nothing recorded while it is off, and the step
graph's signature holding the tracing state. Small problems, a few steps:
the whole file runs in seconds."""

import numpy as np
import pytest
import torch

from chip_smoke import make_lattice_dataset
from occuspytial_tpu_torch import (
    LogitICARGibbs,
    LogitRSRGibbs,
    ProbitICARGibbs,
    ProbitRSRGibbs,
    tracing,
)
from occuspytial_tpu_torch.models.base import _same_signature
from occuspytial_tpu_torch.utils import make_data

CHAINS, STEPS, BLOCKS = 2, 3, 2


def _head():
    return make_data(n=150, ns=100, p=3, q=2, random_state=10)[:4]


def _lattice():
    return make_lattice_dataset(8, 8, ns=40, seed=3)[:4]


SAMPLERS = {
    'logit-cg': lambda: LogitICARGibbs(*_head(), random_state=4,
                                       solver='cg', device='cpu'),
    'logit-stencil': lambda: LogitICARGibbs(*_lattice(), random_state=4,
                                            lattice=(8, 8, 8), device='cpu'),
    'logit-rsr': lambda: LogitRSRGibbs(*_head(), random_state=4,
                                       device='cpu'),
    'probit-icar': lambda: ProbitICARGibbs(*_lattice(), random_state=4,
                                           spatial_sweeps=2, device='cpu'),
    'probit-rsr': lambda: ProbitRSRGibbs(*_head(), random_state=4,
                                         spatial_sweeps=2, device='cpu'),
}


def _occurrences(s):
    """Each phase's occurrences in one step of sampler ``s``."""
    sweeps = s.spatial_sweeps
    want = {'step': 1, 'draws': 1, 'tau': sweeps, 'beta_eta': sweeps,
            'eta_solve': sweeps, 'alpha': 1, 'z': 1, 'store': 1}
    if s.asis:
        want['asis'] = sweeps
    if isinstance(s, (ProbitICARGibbs, ProbitRSRGibbs)):
        # the site and the visit utilities; the PX move before the sweeps
        # and one a sweep
        want['latent'] = 2
        if s.px:
            want['px'] = 1 + sweeps
        if isinstance(s, ProbitRSRGibbs) and s.collapsed:
            # the collapsed ladder's shared factor, once a sweep
            want['rsr_factor'] = sweeps
    else:
        want['pg'] = 1
    if isinstance(s, LogitRSRGibbs):
        # the reduced-basis draw: its precision, then its factor and solves
        del want['eta_solve']
        want['rsr_precision'] = want['rsr_factor'] = sweeps
    return want


def _blocks(s):
    """``BLOCKS`` sample() calls of ``STEPS`` steps, each resumed from
    the last: the draws stacked and the final carry."""
    post = [s.sample(STEPS, chains=CHAINS, progressbar=False)]
    for _ in range(BLOCKS - 1):
        post.append(s.sample(STEPS, chains=CHAINS, progressbar=False,
                             resume_from=s.final_carry))
    draws = {n: np.concatenate([p[n] for p in post], axis=1)
             for n in ('alpha', 'beta', 'tau')}
    return draws, s.final_carry


@pytest.fixture
def traced():
    """Tracing on for one test, with nothing accumulated before it."""
    tracing.report(reset=True)
    tracing.enable()
    yield
    tracing.disable()
    tracing.report(reset=True)


@pytest.mark.parametrize('case', list(SAMPLERS))
def test_span_tree_and_counts(traced, case):
    s = SAMPLERS[case]()
    _blocks(s)
    rep = tracing.report()
    spans = rep['spans']
    want = _occurrences(s)
    steps = STEPS * BLOCKS
    assert set(spans) == set(want)
    for name, entry in spans.items():
        assert entry['count'] == steps * want[name], name
        assert entry['parent'] == tracing.PARENT[name]
        assert entry['self_s'] >= 0.0, name
        children = sum(c['sum_s'] for c in spans.values()
                       if c['parent'] == name)
        assert children <= entry['sum_s'], name
    for name in ('eta_solve', 'rsr_factor', 'rsr_precision'):
        if name in spans:
            assert spans[name]['parent'] == 'beta_eta'
    # one gap between two steps of a block, one boundary between blocks
    assert rep['launch_gap']['count'] == BLOCKS * (STEPS - 1)
    assert rep['block_boundary']['count'] == BLOCKS - 1
    assert rep['launch_gap']['sum_s'] > 0
    assert rep['block_boundary']['sum_s'] > 0
    # the steps and the time between them fill the stretch of the marks
    stretch = rep['last_stamp_s'] - rep['first_stamp_s']
    covered = (spans['step']['sum_s'] + rep['launch_gap']['sum_s']
               + rep['block_boundary']['sum_s'])
    assert covered == pytest.approx(stretch, rel=1e-9)


@pytest.mark.parametrize('case', list(SAMPLERS))
def test_draws_are_bit_identical_with_tracing_on_and_off(case):
    off, off_carry = _blocks(SAMPLERS[case]())
    tracing.enable()
    try:
        on, on_carry = _blocks(SAMPLERS[case]())
    finally:
        tracing.disable()
        tracing.report(reset=True)
    for name in off:
        np.testing.assert_array_equal(on[name], off[name], err_msg=name)
    assert on_carry.step == off_carry.step
    assert torch.equal(on_carry.keys, off_carry.keys)
    for name, val in off_carry.states.items():
        assert torch.equal(on_carry.states[name], val), name


def test_report_stays_empty_with_tracing_off():
    tracing.report(reset=True)
    assert not tracing.enabled()
    s = SAMPLERS['logit-cg']()
    _blocks(s)
    assert tracing.report() == {}
    # off, a phase and a host span are one shared null context
    assert tracing.phase('step', s.device) is tracing.phase('pg')
    assert tracing.span('sample') is tracing.phase('draws')


def test_graph_signature_holds_the_tracing_state():
    s = SAMPLERS['logit-cg']()
    carry = s.init_carry(CHAINS)
    off = s._graph_signature(carry)
    tracing.enable()
    try:
        on = s._graph_signature(carry)
    finally:
        tracing.disable()
    assert _same_signature(off, s._graph_signature(carry))
    assert not _same_signature(off, on)


def test_host_accumulator_charges_gaps_by_the_first_flag():
    """The marker kernel's arithmetic on the host: a step's begin after a
    step's end adds the time between to ``launch_gap``, or, for a
    chunk's first step, to ``block_boundary``; a phase adds its span."""
    acc = [0] * tracing._SIZE
    pg = tracing.PHASES.index('pg')
    marks = [(10, -1, 0, True), (12, -1, pg, False), (15, pg, -1, False),
             (20, 0, -1, False), (23, -1, 0, False), (30, 0, -1, False),
             (40, -1, 0, True), (41, 0, -1, False)]
    for now, close, open_, first in marks:
        tracing._apply(acc, now, close, open_, first)
    assert acc[tracing._SUM] == (20 - 10) + (30 - 23) + (41 - 40)
    assert acc[tracing._COUNT] == 3
    assert (acc[tracing._SUM + pg], acc[tracing._COUNT + pg]) == (3, 1)
    assert (acc[tracing._GAP], acc[tracing._GAP_N]) == (3, 1)
    assert (acc[tracing._BOUNDARY], acc[tracing._BOUNDARY_N]) == (10, 1)
    assert (acc[tracing._FIRST], acc[tracing._LAST]) == (10, 41)


def test_default_build_leaves_the_marker_kernel_to_tracing(monkeypatch,
                                                           tmp_path):
    """``_build.build()`` with no names compiles the compute kernels only:
    the marker kernel waits for ``tracing.enable()``, which names it."""
    from occuspytial_tpu_torch import _build

    asked = []

    def built(name):
        asked.append(name)
        return tmp_path

    monkeypatch.setattr(_build, '_target', built)
    assert _build.build() == {}
    assert 'span_mark' in _build.sources()
    assert sorted(asked) == [n for n in _build.sources() if n != 'span_mark']
    asked.clear()
    assert _build.build(['span_mark']) == {}
    assert asked == ['span_mark']
