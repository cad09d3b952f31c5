"""The precision control on the card (marked ``cuda``; skipped without a
card): at a size a test holds, the program's draws stay under the
cell's limit and the control's (the plain reference in float32 with
TF32 products, in the program's place) go over it. The readings at the
cells' own sizes come from ``python3 -m h100bench.control``."""

import pytest

from h100bench import control, judge, spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize('workload', ['icar1k.k3.c64',
                                      'lattice10k.stencil.c32'])
def test_control_fails_and_program_passes(cuda_card, workload):
    cell = spec.cell(spec.load_benchmark(), workload)
    tr = dict(cell['traffic_spec'], chains=8, burnin=16, check_blocks=3)
    cell = dict(cell, traffic_spec=tr)
    limit = tr['limits'][judge.STAT]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = control.readings(cell, seed, 1.0)
        assert r['program'] < limit < r['control'], r
        assert r['carry_faults'] == 0
