"""The port's long-horizon run (``aloam_tpu_torch/drift.py``) on the CPU:
the drift scene and its config against tests/test_long_drift.py's bit for
bit, the committed reference trajectories (``tests/_torch_drift_ref.npz``)
against what JAX and the f64 oracle give, the port's ``step`` and
``step_b`` at B = 1 held to JAX's rows over the first frames, and the
command line's JSON.

The two slow tests are the counterparts of tests/test_long_drift.py's own
slow tests (the 500-frame gate and the 200-frame oracle ratio) on the
port, here on the CPU (~0.6 s a frame); on the card, chip_smoke.py's
[drift] phase runs both paths over the 500 frames.

The reference file is made by tests/_torch_drift_witness.py; the oracle
part resumes a copy of the tracked checkpoint, which is only read here.
"""

import contextlib
import dataclasses
import io
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aloam_tpu import pipeline as jpipe
from aloam_tpu.io import synthetic as jsyn
from aloam_tpu_torch import drift
from aloam_tpu_torch.eval.ate import ate_rmse
from tests import test_long_drift as jdrift

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(
    REPO, "tests", "_cache",
    "oracle_drift-scene-v1:200:8.0_973c2b9d02be12c6.npz.ckpt")
METRIC = {n: i for i, n in enumerate(drift.pipeline.METRIC_NAMES)}

# the port against JAX's rows, every frame. The odometry does not read the
# map, but its f32 solve is not bit-equal to XLA's: from frame 6 on the two
# poses part by ~1e-6 rad with the same correspondences, and the integrated
# position gap grows by ~7e-6 m a frame (1.24e-4 m at frame 23 on the CPU,
# one thread); the bound is twice that. The mapped position moves with
# near-degenerate fits that flip on rounding (0.0358 m measured on the CPU
# over 24 frames of step); the port's ATE within a quarter of JAX's
ODOM_ATOL_M, MAP_ATOL_M = 2.5e-4, 0.05
ATE_FACTOR, ATE_SLACK_M = 1.25, 0.01

torch.set_num_threads(1)


@pytest.fixture()
def scene_cache(monkeypatch, tmp_path):
    """The port's scene cache in a fresh directory."""
    monkeypatch.setattr(drift, "CACHE_DIR", str(tmp_path))
    return tmp_path


@pytest.fixture(scope="module")
def ref():
    with np.load(drift.REF) as z:
        return dict(z)


def test_drift_constants_match_jax():
    assert dataclasses.asdict(drift.DRIFT_CFG) == \
        dataclasses.asdict(jdrift.DRIFT_CFG)
    assert (drift.N_FRAMES, drift.SPEED, drift.N_ORACLE,
            drift.ENGINE_OVER_ORACLE_GATE) == \
        (jdrift.N_FRAMES, jdrift.SPEED, jdrift.N_ORACLE,
         jdrift.ENGINE_OVER_ORACLE_GATE)


def test_render_scene_matches_jax(scene_cache):
    traj, scans = drift.render_scene(3)
    jtraj, jscans = jdrift._render_scene(3)
    assert np.array_equal(traj.trans, jtraj.trans)
    assert np.array_equal(traj.quats, jtraj.quats)
    assert len(scans) == len(jscans) == 3
    for s, j in zip(scans, jscans):
        assert s.dtype == j.dtype and np.array_equal(s, j)
    # the second call reads the cache: the same scans
    _, again = drift.render_scene(3)
    assert all(np.array_equal(a, b) for a, b in zip(again, scans))


def test_reference_jax_rows(ref):
    """The file's first 8 rows of JAX's step are what JAX's
    make_step_fn gives on the CPU."""
    cfg = jdrift.DRIFT_CFG
    _, scans = jdrift._render_scene(8)
    step = jpipe.make_step_fn(cfg)
    state = jpipe.init_state(cfg)
    rows = {k: [] for k in ("t_map", "q_map", "t_odom", "q_odom",
                            "metrics")}
    for s in scans:
        xyz, mask = jsyn.pad_scan(s, cfg.n_raw)
        state, out = step(state, jnp.asarray(xyz), jnp.asarray(mask))
        for k in rows:
            rows[k].append(np.asarray(getattr(out, k)))
    for k, v in rows.items():
        np.testing.assert_allclose(ref[f"jax_{k}"][:8], np.stack(v),
                                   atol=1e-6, rtol=0, err_msg=k)
    assert ref["jax_t_map"].shape == ref["jaxb_t_map"].shape == (500, 3)


def test_reference_oracle_rows(ref):
    """The oracle part resumes the tracked 80-frame checkpoint: its first
    80 frames are the checkpoint's lists exactly."""
    with open(CKPT, "rb") as fh:
        ck = pickle.load(fh)
    assert ck[0] == 80
    t_odom, t_map, q_map = (np.asarray(x) for x in ck[11:14])
    assert np.array_equal(ref["oracle_t_odom"][:80], t_odom)
    assert np.array_equal(ref["oracle_t_map"][:80], t_map)
    assert np.array_equal(ref["oracle_q_map"][:80], q_map)
    assert ref["oracle_t_map"].shape == (drift.N_ORACLE, 3)


@pytest.mark.parametrize("batched,frames", [(False, 24), (True, 8)],
                         ids=["step", "step_b"])
def test_port_against_jax(ref, scene_cache, batched, frames):
    traj, scans = drift.render_scene(frames)
    res = drift.run(drift.DRIFT_CFG, scans, "cpu", batched=batched)
    pre = "jaxb_" if batched else "jax_"
    j_map, j_odom = ref[pre + "t_map"][:frames], ref[pre + "t_odom"][:frames]
    odom_gap = np.abs(res["t_odom"] - j_odom).max(axis=1)
    map_gap = np.linalg.norm(res["t_map"] - j_map, axis=1)
    assert odom_gap.max() <= ODOM_ATOL_M, odom_gap
    assert map_gap.max() <= MAP_ATOL_M, map_gap
    solved = METRIC["map_solved"]
    assert np.array_equal(res["metrics"][:, solved],
                          ref[pre + "metrics"][:frames, solved])
    gt = drift.ground_truth(traj, frames)[0]
    ate_p = ate_rmse(res["t_map"], gt, align=False)
    ate_j = ate_rmse(j_map, gt, align=False)
    assert ate_p <= ATE_FACTOR * ate_j + ATE_SLACK_M, (ate_p, ate_j)
    assert [b["frames"] for b in res["blocks"]] == [(0, frames)]


# the JSON line's keys: tools/oracle_drift.py's, then the port's own
TOOL_KEYS = {"n_frames", "oracle_drift_pct", "engine_drift_pct",
             "engine_over_oracle", "oracle_ate_m", "engine_ate_m",
             "n_segments", "max_engine_oracle_gap_m"}
PORT_KEYS = {"oracle_frames", "run_drift_pct", "run_ate_m", "run_segments",
             "jax_drift_pct", "jax_ate_m", "max_engine_jax_gap_m",
             "jax_over_oracle", "odom_drift_pct", "map_solved", "finite",
             "blocks", "occupancy", "map_overflow", "map_evicted",
             "jax_gap_m", "ms_per_scan"}
# too few frames for a 100 m segment (125 frames at 0.8 m)
NO_SEGMENT = {"oracle_drift_pct", "engine_drift_pct", "engine_over_oracle",
              "run_drift_pct", "jax_drift_pct", "jax_over_oracle",
              "odom_drift_pct"}


def test_cli_prints_every_key(scene_cache):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        drift.main(["--device", "cpu", "--frames", "6", "--ref", drift.REF])
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    assert "NaN" not in lines[0] and "Infinity" not in lines[0]
    s = json.loads(lines[0])
    assert set(s) == TOOL_KEYS | PORT_KEYS
    assert s["n_frames"] == s["oracle_frames"] == 6
    assert s["n_segments"] == s["run_segments"] == 0
    for k in NO_SEGMENT:
        assert s[k] is None, k
    flat = [v for k, v in s.items() if k not in NO_SEGMENT]
    flat = np.array([x for v in flat for x in np.ravel(v)], np.float64)
    assert np.isfinite(flat).all()
    # frame 0 maps onto an empty map: nothing to solve against
    assert s["finite"] and s["map_solved"] == 5 and s["blocks"] == [6]
    assert len(s["occupancy"]) == len(s["ms_per_scan"]) == 1
    assert 0 < s["occupancy"][0][0] < 1 and 0 < s["occupancy"][0][1] < 1
    assert s["max_engine_jax_gap_m"] == s["jax_gap_m"][0] < MAP_ATOL_M


def test_cli_refuses_without_a_card(scene_cache):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as e:
        drift.main(["--frames", "1"])
    assert "no CUDA device" in str(e.value)


def test_gates_read_the_summary():
    """Each gate fails on its own figure, and the oracle-relative limit
    follows JAX's own ratio where that is above the gate."""
    good = dict(n_frames=500, map_solved=499, finite=True, run_segments=900,
                run_drift_pct=1.5, run_ate_m=4.0, n_segments=300,
                engine_drift_pct=1.2, oracle_drift_pct=1.0,
                engine_over_oracle=1.2, jax_over_oracle=1.1)
    assert drift.gates(good) == []
    bad = {"map_solved": 494, "finite": False, "run_segments": 200,
           "run_drift_pct": 3.0, "run_ate_m": None, "n_segments": 50,
           "engine_over_oracle": 1.26}
    for k, v in bad.items():
        assert len(drift.gates(dict(good, **{k: v}))) == 1, k
    assert drift.gates(dict(good, engine_over_oracle=1.6,
                            jax_over_oracle=1.4)) == []
    assert drift.oracle_limit(None) == drift.ENGINE_OVER_ORACLE_GATE


def _full_run(n):
    traj, scans = drift.render_scene(n)
    with np.load(drift.REF) as z:
        ref = dict(z)
    return drift.summary(drift.run(drift.DRIFT_CFG, scans, "cpu"), traj,
                         ref)


@pytest.mark.slow
def test_500_frame_drift_gate_port():
    s = _full_run(drift.N_FRAMES)
    assert drift.gates(s) == [], s


@pytest.mark.slow
def test_oracle_relative_drift_port():
    s = _full_run(drift.N_ORACLE)
    assert s["n_segments"] > drift.MIN_SEGMENTS_ORACLE
    assert s["engine_over_oracle"] is not None
    assert s["engine_over_oracle"] <= drift.oracle_limit(
        s["jax_over_oracle"]), s
