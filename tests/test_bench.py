"""bench.py's device bookkeeping: the peaks table and the FP32 floor.

The benchmark itself needs the GPU; what it computes from published
peaks is checked here.
"""

import pytest

import bench


def test_peaks_unknown_device_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        bench._peaks("cpu")


def test_fp32_floor_of_the_cap512_solve():
    """2 * cap^2 * N * GPs FLOP at 67 TFLOP/s: 1.05e12 FLOP -> 15.65 ms."""
    ms = bench._fp32_floor_ms("NVIDIA H100 80GB HBM3", 512, 10 ** 6, 2)
    assert ms == pytest.approx(2 * 512 ** 2 * 1e6 * 2 / 67e12 * 1e3)
    assert 15.6 < ms < 15.7
