"""The work and byte counts of the roofline and mfu metrics against the
hand reckoning of the eigenbasis solve at the main path's shapes."""

import pytest

from h100bench import spec


@pytest.fixture(scope='module')
def k3():
    return spec.metric('eta_solve.k3_roofline')


def test_k3_work_is_20_products_of_384_by_1000_by_1000(k3):
    prod, elem = k3.solve_flops(64, 6, 1000, 8)
    assert k3.products(8) == 20
    assert prod == 20 * 2 * 384 * 1000 * 1000 == 15.36e9
    assert elem == 15 * 384 * 1000 * 8


def test_k3_least_time_is_work_bound(k3):
    peaks = spec.peaks()
    least = k3.least_seconds(64, 6, 1000, 8, peaks)
    prod, elem = k3.solve_flops(64, 6, 1000, 8)
    work = 3 * prod / 4.95e14 + elem / 6.7e13
    assert least == pytest.approx(work)
    assert k3.solve_bytes(64, 6, 1000) / 3.35e12 < work
    # 15.36 GFLOP at 495 / 3 TFLOP/s: 93.1 us, plus 0.7 us elementwise
    assert 93e-6 < least < 95e-6


def test_step_mfu_counts_three_sweeps():
    mfu = spec.metric('step_mfu')
    k3 = spec.metric('eta_solve.k3_roofline')
    per_sweep = (k3.solve_flops(64, 6, 1000, 8)[0] + 2 * 64 * 999 * 1000
                 + 2 * 64 * 1000 * 1000)
    assert mfu.step_flops(64, 6, 1000, 8, 3) == 3 * per_sweep
