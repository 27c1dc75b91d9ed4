"""Checks that only the GPU can make: float32 interval noise, native
float64 oracle agreement and the compiled step, at reduced sizes.

Marked ``gpu``; each test takes the ``gpu`` fixture, which skips on the
CPU. Run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``;
``chip_smoke.py`` runs the same phases at full size.
"""

import jax
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_interval_pass_float32(gpu):
    with jax.enable_x64(False):
        out = cs.phase_intervals(n_rows=65536, caps=(64, 512),
                                 check_rows=8192, timing=False)
    assert all(r["q_err"] < cs.Q_TOL for r in out.values())


def test_flagship_rounds_float32(gpu):
    with jax.enable_x64(False):
        out = cs.phase_flagship(n_side=256, rounds=3, timing_reps=0)
    assert out["q_err_max"] < cs.Q_TOL


def test_device_oracle_matches_host_and_precision_refused(gpu):
    with jax.enable_x64(False):
        out = cs.phase_cap512(n_side=256, check_rows=8192, timing_reps=0)
    assert out["oracle_match"]
    assert "refused on the GPU" in out["refused"]
