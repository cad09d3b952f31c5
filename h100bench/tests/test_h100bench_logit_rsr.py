"""The logit RSR cell on the CPU at a tiny size (12 x 14 lattice, q from
r = 0.5, the device route of the basis on the CPU): a sound run is
correct; each fault planted in the timed step, and the precision control
in the program's place, is not; and the work and bytes that
``rsr_precision.roofline`` counts at the cell's shapes are the hand
count."""

import pytest
import torch

from h100bench import judge, run, spec
from occuspytial_tpu_torch import LogitRSRGibbs

SEED = 2 ** 31 + 2424
CELL = 'logit_rsr10k.qspace.c32'


def _cell(tiny, chains=12):
    # q from upstream's threshold: the 10,000-site cut would be most of
    # 168 sites
    return tiny(CELL, chains=chains, sampler_args={
        'q': None, 'basis': 'device', 'spatial_sweeps': 2})


def test_sound_run_is_correct(tiny):
    res = run.run(_cell(tiny), SEED, 0.3, False, device='cpu')
    assert res['correct'], res['checks']
    assert res['attempted'] >= 1 and res['failed'] == 0
    assert set(res['metrics']) == {'chain_steps_per_s', 'setup_s'}
    assert res['checks'][judge.STAT]['value'] < 1e-4


def _unchanged(self, keys, step, state, fixed):
    return dict(state)


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


@pytest.mark.parametrize('fault', ['unchanged', 'altered',
                                   'altered_one_sixth'])
def test_fault_in_the_timed_step_is_not_correct(tiny, monkeypatch, fault):
    step = LogitRSRGibbs._step
    faulty = {'unchanged': _unchanged, 'altered': _altered(step),
              'altered_one_sixth': _altered(step, 1 / 6)}[fault]
    monkeypatch.setattr(LogitRSRGibbs, '_step', faulty)
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


def test_precision_roofline_counts_at_the_cells_shapes():
    """(32 chains, n = 10,000, q = 1,256), two sweeps: a sweep's
    symmetric product is 32 x 10,000 x 1,256 x 1,257 / 2 multiply-adds,
    7.54 ms at 67 TFLOP/s, the factor's q^3 / 3 a chain 0.63 ms, the
    solves' q^2 a chain 1.5 us; K (50.2 MB) and 32 x (omega and three
    q x q matrices, 19.0 MB) are 0.196 ms at 3.35 TB/s, so the work
    bounds it at 8.17 ms a sweep."""
    m = spec.metric('rsr_precision.roofline')
    peaks = spec.peaks()
    chains, n, q = 32, 10000, 1256
    product = 2 * chains * n * q * (q + 1) / 2 / 6.7e13
    factor = 2 * chains * q ** 3 / 3 / 6.7e13
    solves = 2 * chains * q ** 2 / 6.7e13
    moved = (4 * n * q + 4 * chains * (n + 3 * q ** 2)) / 3.35e12
    assert product == pytest.approx(7.5405e-3, rel=1e-4)
    assert factor == pytest.approx(0.63089e-3, rel=1e-4)
    assert moved == pytest.approx(0.19621e-3, rel=1e-4)
    assert m.sweep_flops(chains, n, q) / 6.7e13 == pytest.approx(
        product + factor + solves, rel=1e-12)
    assert m.sweep_bytes(chains, n, q) / 3.35e12 == pytest.approx(
        moved, rel=1e-12)
    least = m.least_seconds(chains, n, q, 1, peaks)
    assert least == pytest.approx(product + factor + solves, rel=1e-12)
    assert 8.17e-3 < least < 8.18e-3
    assert m.least_seconds(chains, n, q, 2, peaks) == pytest.approx(
        2 * least)
    assert m.read({'args': {'q': None, 'spatial_sweeps': 2}}) is None
    assert m.read({'args': {'q': q}}) is None
