"""The probit RSR cell on the CPU at a tiny size (150 sites, q from r =
0.5): a sound run is correct; each fault planted in the timed step, and
the precision control in the program's place, is not; and the work and
bytes that ``rsr_factor.roofline`` counts at the cell's shapes are the
hand count."""

import pytest
import torch

from h100bench import judge, run, spec
from occuspytial_tpu_torch import ProbitRSRGibbs

SEED = 2 ** 31 + 2020
CELL = 'probit_rsr1k.collapsed.c256'


def _cell(tiny, chains=12):
    # q from upstream's threshold: 128 of the headline's 1000 sites would
    # be most of 150
    return tiny(CELL, chains=chains, sampler_args={'q': None})


def test_sound_run_is_correct(tiny):
    cell = _cell(tiny)
    res = run.run(cell, SEED, 0.3, False, device='cpu')
    assert res['correct'], res['checks']
    assert res['attempted'] >= 1 and res['failed'] == 0
    assert set(res['metrics']) == {'chain_steps_per_s', 'setup_s'}
    assert res['checks'][judge.STAT]['value'] < 1e-4


def _unchanged(self, keys, step, state, fixed):
    return dict(state)


def _half(step):
    def faulty(self, keys, t, state, fixed):
        new = step(self, keys, t, state, fixed)
        half = state['tau'].shape[0] // 2
        return {k: torch.cat([v[:half], state[k][half:]]) for k, v in
                new.items()}
    return faulty


def _altered(step, share=1.0):
    """tau off by 0.1% where it is drawn, in the first ``share`` of the
    chains."""
    def faulty(self, keys, t, state, fixed):
        new = step(self, keys, t, state, fixed)
        bad = int(-(-new['tau'].shape[0] * share // 1))
        new['tau'] = torch.cat([new['tau'][:bad] * 1.001,
                                new['tau'][bad:]])
        return new
    return faulty


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered',
                                   'altered_one_sixth'])
def test_fault_in_the_timed_step_is_not_correct(tiny, monkeypatch, fault):
    step = ProbitRSRGibbs._step
    faulty = {'unchanged': _unchanged, 'half': _half(step),
              'altered': _altered(step),
              'altered_one_sixth': _altered(step, 1 / 6)}[fault]
    monkeypatch.setattr(ProbitRSRGibbs, '_step', faulty)
    res = run.run(_cell(tiny), SEED, 0.3, False, device='cpu')
    assert not res['correct']
    chk = res['checks'][judge.STAT]
    assert chk['value'] > chk['limit']


def test_precision_control_fails_the_limit(tiny):
    cell = _cell(tiny, chains=4)
    c = run.Cell(cell, SEED, 'cpu')
    c.setup(0.0)
    c.window(0.3)
    c.release()
    sound, _ = c.reference_checks()
    ctl = spec.reference(c.cfg['reference']).build(c.data, c.args, 'cpu',
                                                   control=True)
    control, _ = c.reference_checks(program=ctl)
    limit = cell['traffic_spec']['limits'][judge.STAT]
    assert sound < limit < control


def test_factor_roofline_counts_at_the_cells_shapes():
    """(256 chains, q = 128, p = 3), one sweep: the factor's q^3 / 3
    multiply-adds a chain are 5.3 us at 67 TFLOP/s and the solves' 5.5
    right-hand sides of q^2 add 0.7 us; A and L are 10.0 us at 3.35
    TB/s and the 12 vectors of q add 0.5 us, so the bytes bound it at
    about 10.5 us."""
    m = spec.metric('rsr_factor.roofline')
    peaks = spec.peaks()
    factor = 2 * 256 * 128 ** 3 / 3 / 6.7e13
    solves = 2 * 256 * (4 + 1 + 0.5) * 128 ** 2 / 6.7e13
    matrices = 2 * 256 * 128 ** 2 * 4 / 3.35e12
    vectors = 256 * 12 * 128 * 4 / 3.35e12
    assert factor == pytest.approx(5.34e-6, rel=1e-3)
    assert matrices == pytest.approx(10.02e-6, rel=1e-3)
    assert m.sweep_flops(256, 128, 3) / 6.7e13 == pytest.approx(
        factor + solves, rel=1e-12)
    assert m.sweep_bytes(256, 128, 3) / 3.35e12 == pytest.approx(
        matrices + vectors, rel=1e-12)
    least = m.least_seconds(256, 128, 3, 1, peaks)
    assert least == pytest.approx(matrices + vectors, rel=1e-12)
    assert 10.4e-6 < least < 10.6e-6
    assert m.least_seconds(256, 128, 3, 2, peaks) == pytest.approx(
        2 * least)
