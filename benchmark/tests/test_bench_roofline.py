"""The work functions of K1 and K2 on hand-worked shapes."""

import pytest

from benchmark.roofline import k1, k2, peaks


def test_k2_hand_worked():
    # 2 queries, 3 stored sketches, 64 slots of 13 bits, 24 B of counts
    nbytes, ops = k2.work(2, 3, 64, 13, 24)
    assert nbytes == (2 + 3) * 64 * 13 / 8 + 24 == 544
    assert ops == 2 * 3 * 64 * 13 / 32 == 156


def test_k2_at_the_config5_shapes():
    # 96 x 102,400 x 4096 slots: bound by operations, 0.978 ms
    nb, ops = k2.work(96, 102400, 4096, 13, 96 * 102400 * 4)
    assert peaks.least_seconds(nb, ops) == pytest.approx(0.978e-3, rel=1e-3)
    assert ops / peaks.INT32_OPS_PER_S > nb / peaks.HBM_BYTES_PER_S
    # one query: bound by bytes, 0.204 ms (no packing reads less)
    nb, ops = k2.work(1, 102400, 4096, 13, 102400 * 4)
    assert peaks.least_seconds(nb, ops) == pytest.approx(0.2036e-3,
                                                         rel=1e-3)
    # the -M block at S=15: 2.50 ms, 56% of a 4.5 ms call
    nb, ops = k2.work(768, 4096, 32768, 13, 768 * 4096 * 4)
    assert peaks.least_seconds(nb, ops) / 4.5e-3 == pytest.approx(0.556,
                                                                 abs=0.01)


def test_k1_hand_worked():
    assert k1.work(96, 1 << 14) == (8.0 * 96 * 16384, 0.0)
    nb, ops = k1.work(256, 1 << 17)
    assert peaks.least_seconds(nb, ops) == pytest.approx(0.0801e-3,
                                                         rel=1e-2)


def test_peaks():
    assert peaks.INT32_OPS_PER_S == pytest.approx(16.73e12, rel=1e-3)
    assert peaks.least_seconds(3.35e12, 0) == 1.0
