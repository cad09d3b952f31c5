"""A whole run of the harness on the CPU at a tiny size: the program's
plain path through set-up, window and comparison. It passes the
harness's look for a card and checks control flow and the comparison
only (no time or device number is read here). Each fault planted in the
timed path underneath must make ``correct`` false."""

import numpy as np
import pytest
import torch

from h100bench import judge, run, spec
from h100bench.reference import operators
from occuspytial_tpu_torch import LogitICARGibbs

SEED = 2 ** 31 + 12345
CELLS = ('icar1k.k3.c64', 'lattice10k.stencil.c32')


def _run(cell):
    return run.run(cell, SEED, 0.3, False, device='cpu')


@pytest.mark.parametrize('workload', CELLS)
def test_sound_run_is_correct(tiny, workload):
    res = _run(tiny(workload))
    assert res['correct'], res['checks']
    assert res['attempted'] >= 1 and res['failed'] == 0
    assert set(res['metrics']) == {m['name'] for m in tiny(workload)[
        'end_to_end']}
    assert {'chain_steps_per_s', 'setup_s'} <= set(res['metrics'])
    assert list(res)[-1] == 'checks'
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
    chains (a sixth: the chains of one of K3's six 64-row tiles at 64
    chains)."""
    def faulty(self, keys, t, state, fixed):
        new = step(self, keys, t, state, fixed)
        bad = -(-new['tau'].shape[0] * share // 1)
        new['tau'] = torch.cat([new['tau'][:int(bad)] * 1.001,
                                new['tau'][int(bad):]])
        return new
    return faulty


@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered',
                                   'altered_one_tile'])
def test_fault_in_the_timed_path_is_not_correct(tiny, monkeypatch, fault):
    step = LogitICARGibbs._step
    faulty = {'unchanged': _unchanged, 'half': _half(step),
              'altered': _altered(step),
              'altered_one_tile': _altered(step, 1 / 6)}[fault]
    monkeypatch.setattr(LogitICARGibbs, '_step', faulty)
    res = _run(tiny('icar1k.k3.c64', chains=12))
    assert not res['correct']
    chk = res['checks'][judge.STAT]
    assert chk['value'] > chk['limit']


def test_precision_control_fails_the_limit(tiny):
    cell = tiny('icar1k.k3.c64')
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


@pytest.mark.parametrize('kind', ['dense', 'stencil'])
def test_noise_factor_squares_to_q(kind):
    from h100bench.generators.make_data import lattice_q

    q = lattice_q(6, 7, 8)
    ar = operators.Arith('cpu')
    ops = {'dense': lambda: operators.Dense(q, 8, ar),
           'stencil': lambda: operators.Stencil(q, 6, 7, 8, 15, ar)}[kind]()
    eye = torch.eye(ops.noise_dim, dtype=torch.float64)
    b = ops.noise(eye).T  # (n, noise_dim)
    np.testing.assert_allclose((b @ b.T).numpy(), q.toarray(), atol=1e-10)
