"""CPU rehearsal of ``chip_smoke.py`` at a tiny size.

The script's ``main`` refuses any backend but the GPU; its phase
functions take their sizes as arguments, so the same code paths, checks
and references run here in seconds. What only the card can say (the
GPU compiler's verdict, device memory, times) is left to the script.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_without_gpu():
    """No accelerator: a non-zero exit and no JSON result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_main_refuses_outside_checkout(tmp_path):
    """chip_smoke.py alone in a directory must fail: it drives the
    package of its own checkout, not one found elsewhere."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_intervals_tiny():
    out = cs.phase_intervals(n_rows=2000, caps=(16, 64), check_rows=500,
                             timing=False)
    assert set(out) == {"cap16_rbf", "cap16_context", "cap64_rbf",
                        "cap64_context"}
    assert all(r["q_err"] < cs.Q_TOL for r in out.values())


def test_phase_flagship_tiny():
    out = cs.phase_flagship(n_side=40, rounds=2, timing_reps=2)
    assert len(out["flips"]) == 2
    assert out["q_err_max"] < cs.Q_TOL
    assert out["optimize_ms"] > 0


def test_phase_cap512_tiny():
    out = cs.phase_cap512(n_side=30, cap=64, n_obs=60, check_rows=300,
                          timing_reps=1)
    assert out["oracle_match"]
    assert "not refused" in out["refused"]      # the CPU keeps it


def test_phase_expander_tiny():
    out = cs.phase_expander(n_side=48, chunk=32, timing=False)
    assert out["chunks"] >= 2 and out["unsafe"] > 0


def test_phase_entry_points_tiny():
    out = cs.phase_entry_points(swarm_iters=2, loop_side=30, loop_iters=2,
                                fleet_k=2, sparse_n=200, sparse_m=16,
                                sparse_side=30, lag_iters=3)
    assert out["lagged_match"] and out["fleet_k"] == 2


def test_phase_four_on_virtual_devices():
    """The four-card path on the suite's virtual CPU devices."""
    out = cs.phase_four(n_rows=40 * 40, fleet_per_card=1)
    assert out["sharded_equal"]


def test_check_decisions_flags_flips_outside_band():
    Q64 = np.array([[0.5, 1.0, 0.6, 1.2],      # margin 0.3: clear
                    [0.0, 1.0, 0.5005, 1.1]])  # margin 5e-4: in band
    ref = (Q64, np.array([True, True]), np.array([True, False]),
           np.zeros(2, bool), 0)
    fmin, scaling = [-np.inf, 0.5], [1.0, 1.0]
    inside = cs.check_decisions(np.array([True, False]),
                                np.array([True, False]), np.zeros(2, bool),
                                Q64, ref, fmin, scaling, 1e-3)
    assert inside["S_flips"] == 1 and inside["outside_band"] == 0
    with pytest.raises(AssertionError, match="outside the band"):
        cs.check_decisions(np.array([False, True]),
                           np.array([False, False]), np.zeros(2, bool),
                           Q64, ref, fmin, scaling, 1e-3)


def test_chunks_visited_counts_reference_order():
    """Visit order is width descending, larger index first on ties; the
    walk stops in the chunk holding the expander."""
    n = 10
    width = np.array([5, 4, 4, 3, 3, 3, 2, 1, 1, 1], float)
    Q = np.stack([np.zeros(n), width], axis=1)
    S = np.ones(n, bool)
    M = np.zeros(n, bool)
    M[9] = True                       # max_var = width[9] = 1
    G = np.zeros(n, bool)
    G[3] = True       # visit order 0, 2, 1, 5, 4, 3, 6: sixth, chunk 3
    assert cs.chunks_visited(Q, S, M, G, [1.0], 0.0, 2) == (3, 7)
    assert cs.chunks_visited(Q, S, M, np.zeros(n, bool), [1.0], 0.0,
                             2) == (4, 7)


def test_last_line_contract():
    """The result line the driver reads: one JSON object, these keys."""
    line = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}})
    parsed = json.loads(line)
    assert parsed["ok"] is True
    assert set(parsed["device"]) == {"platform", "kind", "count"}
