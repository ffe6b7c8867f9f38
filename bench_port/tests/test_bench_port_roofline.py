"""The roofline's counts: functions of the shapes alone."""

import pytest

import roofline


def test_peaks():
    assert roofline.INT32_MAD_PER_S == 16.75e12
    assert roofline.mul_mads(12) == 300 and roofline.mul_mads(8) == 136


def test_a_2e22_transform_counts_the_three_ntt_bounds():
    # The tile's 0.3065 ms and the two butterfly_stages launches' 0.2043 and
    # 0.1703 ms: the ladder's products, bound by operations.
    nbytes, mads = roofline.transform_work(1 << 22)
    assert roofline.least_ms(nbytes, mads) == pytest.approx(0.3065 + 0.2043 + 0.1703, abs=2e-4)
    assert nbytes == (1 << 22) * 32 * 2
    _, coset = roofline.transform_work(1 << 22, batch=4, coset=True)
    assert coset == 4 * (mads + (1 << 22) * 136)


def test_a_2e20_commit_counts_6_61_ms():
    nbytes, mads = roofline.commit_work(1 << 20)
    assert roofline.least_ms(nbytes, mads) == pytest.approx(6.611, abs=1e-3)
    assert nbytes == (1 << 20) * (96 + 32)
    # 16 sets of 2^16 are as much work as one set of 2^20.
    assert roofline.commit_work(16 << 16) == (nbytes, mads)


def test_bytes_bound_small_work():
    assert roofline.least_ms(3.35e9, 0) == pytest.approx(1.0)
