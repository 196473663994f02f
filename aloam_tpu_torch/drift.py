"""The long-horizon run of the port: the 500-frame drift scene stepped by
``pipeline.make_step_fn`` or ``parallel.batched_step_jit`` and held to the
JAX package's trajectory and the f64 oracle's (the port's counterpart of
``tools/oracle_drift.py`` and of ``tests/test_long_drift.py``'s scene).

The scene is VLP-16 at 256 azimuth steps driving a slalom down a street
canyon at 0.8 m a frame, about 400 m in all. Over that distance the map
tables (8192 × 32 corner, 16384 × 48 surf buckets) fill up, so the run
exercises the merge's eviction priorities, ``map_overflow`` and the knn
cache's ``map_cache_crossed`` as no short run does.

    python -m aloam_tpu_torch.drift [--frames 500] [--batched]
    python -m aloam_tpu_torch.drift --device cpu --frames 6

It runs on the card by default and refuses without one; ``--device cpu``
runs the kernels' plain versions. It prints one JSON line: the keys of
``tools/oracle_drift.py`` over the oracle's frames (the first
``N_ORACLE``, or all of them when fewer), then the port's own over the
whole run, JAX's over the same frames from the reference file
(``tests/_torch_drift_ref.npz``, made by ``tests/_torch_drift_witness.py``
on the CPU), and per block of ``BLOCK`` frames the tables' occupancy, the
overflow and eviction sums, the largest gap to JAX's mapped position and
the milliseconds a scan. A figure whose segments do not fit prints null.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import time

import numpy as np
import torch

from aloam_tpu_torch import parallel, pipeline
from aloam_tpu_torch.config import PRESETS
from aloam_tpu_torch.eval.ate import ate_rmse, kitti_drift
from aloam_tpu_torch.io import synthetic as syn
from aloam_tpu_torch.ops import gridmap

N_FRAMES = 500
SPEED = 8.0          # 0.8 m/frame: inside the 1.0 m map NN gate

# the drift scene's capacities (tests/test_long_drift.py's DRIFT_CFG)
DRIFT_CFG = PRESETS["VLP-16"].replace(
    n_raw=8192, ring_cap=512, less_flat_cap=8192,
    corner_stack_cap=1024, surf_stack_cap=2048,
    map_cell_cap=512, map_insert_cell_cap=512)

# the oracle-relative run's frames and gate (tests/test_long_drift.py)
N_ORACLE = 200
ENGINE_OVER_ORACLE_GATE = 1.25
# the 500-frame gates of tests/test_long_drift.py::test_500_frame_drift_gate
DRIFT_GATE_PCT, ATE_GATE_M, SOLVED_SLACK = 3.0, 10.0, 5
MIN_SEGMENTS_RUN, MIN_SEGMENTS_ORACLE = 200, 50

BLOCK = 100          # frames a block of the per-block figures
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(_ROOT, "tests", "_torch_drift_ref.npz")
CACHE_DIR = os.path.join(_ROOT, ".bench_cache")
# scenes this short render in the calling process: a pool costs more
_INLINE_FRAMES = 32


def s_curve_trajectory(n: int, speed: float, period: float = 0.1):
    """Slalom down the canyon: sinusoidal yaw (±0.05 rad, 20 s period)
    keeps rotation persistently excited while the lateral excursion stays
    ~±1.3 m, mid-canyon for the whole run (a linear yaw drift would leave
    the canyon after ~100 frames at this speed)."""
    ts = np.arange(n) * period
    yaw = 0.05 * np.sin(2 * np.pi * ts / 20.0)
    x = np.concatenate([[0.0], np.cumsum(speed * period * np.cos(yaw[:-1]))])
    y = np.concatenate([[0.0], np.cumsum(speed * period * np.sin(yaw[:-1]))])
    z = np.full(n, 1.8)
    quats = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)],
                     axis=-1)
    return syn.Trajectory(quats=quats, trans=np.stack([x, y, z], axis=-1))


def _render_frames(idx) -> list:
    """Frames ``idx`` of the scene. The world and trajectory are always
    built at the full N_FRAMES extent, so frame i is the same whatever
    frames a caller asks for."""
    world = syn.street_canyon(seed=11, length=SPEED * 0.1 * N_FRAMES + 60)
    traj = s_curve_trajectory(N_FRAMES, SPEED)
    return [syn.render_scan(world, traj.quats[i], traj.trans[i],
                            scan_lines=16, n_azimuth=256,
                            seed=11 * 10007 + i, noise=0.01, dropout=0.05)
            for i in idx]


def render_scene(n: int):
    """(trajectory of all N_FRAMES frames, the first ``n`` scans, each (N,
    4) f32). Raytraced on the host (~0.04 s a frame), over a pool of
    processes past a few frames, and cached in ``CACHE_DIR`` (written to
    a temporary file first, so a reader never sees half of one)."""
    if not 1 <= n <= N_FRAMES:
        raise ValueError(f"the drift scene has 1..{N_FRAMES} frames, "
                         f"asked for {n}")
    traj = s_curve_trajectory(N_FRAMES, SPEED)
    path = os.path.join(CACHE_DIR, f"drift_scene_v1_f{n}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return traj, np.split(z["points"], np.cumsum(z["counts"])[:-1])
    if n <= _INLINE_FRAMES:
        scans = _render_frames(range(n))
    else:
        workers = min(os.cpu_count() or 1, 8)
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) \
                as pool:
            parts = pool.map(_render_frames,
                             np.array_split(np.arange(n), workers))
            scans = [s for part in parts for s in part]
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp.npz"
    np.savez(tmp, points=np.concatenate(scans),
             counts=np.array([len(s) for s in scans]))
    os.replace(tmp, path)
    return traj, scans


def ground_truth(traj, n: int):
    """(positions (n, 3) f64 from frame 0, quaternions (n, 4))."""
    return ((traj.trans[:n] - traj.trans[0]).astype(np.float64),
            traj.quats[:n])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def occupancy(grid: gridmap.GridMap) -> float:
    """Live entries of a table over its capacity (buckets × bucket_cap,
    every stream)."""
    cap = grid.aux.shape[0] * grid.aux.shape[1] * grid.bucket_cap
    return int(gridmap.n_valid(grid)) / cap


def device_frames(cfg, scans, device) -> list:
    """Each scan padded to ``cfg.n_raw``: (xyz (n_raw, 3), mask (n_raw,))
    on ``device``."""
    return [tuple(torch.from_numpy(a).to(device)
                  for a in syn.pad_scan(s, cfg.n_raw)) for s in scans]


def run(cfg, scans, device, batched: bool = False) -> dict:
    """Step one stream over ``scans``: ``batched=False`` through
    ``pipeline.make_step_fn`` (the exact per-round map search),
    ``batched=True`` through ``parallel.batched_step_jit`` at B = 1 (the
    knn cache and ``assoc_cell``); on a CUDA device each replays a CUDA
    graph captured on frame 0. Returns per frame ``t_map``, ``q_map``,
    ``t_odom``, ``q_odom`` and ``metrics`` (``pipeline.METRIC_NAMES``'
    columns), and per block of BLOCK frames ``blocks``: its (first, end)
    frames, the ms a scan (a synchronize on both sides, frame 0's capture
    left out), and the corner and surf tables' occupancy at its end."""
    device = torch.device(device)
    frames = device_frames(cfg, scans, device)
    if batched:
        step = parallel.batched_step_jit(cfg)
        state = parallel.batched_init(cfg, 1, device)
        frames = [(x[None], m[None]) for x, m in frames]
    else:
        step = pipeline.make_step_fn(cfg)
        state = pipeline.init_state(cfg, 1, device)
    outs, blocks = [], []
    for lo in range(0, len(frames), BLOCK):
        hi = min(lo + BLOCK, len(frames))
        first, t0 = max(lo, 1), None
        for f in range(lo, hi):
            if f == first:
                _sync(device)
                t0 = time.perf_counter()
            state, out = step(state, *frames[f])
            outs.append(out)
        _sync(device)
        ms = None if t0 is None else \
            1e3 * (time.perf_counter() - t0) / (hi - first)
        blocks.append(dict(frames=(lo, hi), ms_per_scan=ms,
                           occupancy=(occupancy(state.map.corner),
                                      occupancy(state.map.surf))))
    res = {k: torch.stack([getattr(o, k).reshape(-1) for o in outs])
           .cpu().numpy() for k in ("t_map", "q_map", "t_odom", "q_odom",
                                    "metrics")}
    res["blocks"] = blocks
    return res


def _finite(x):
    """A float, or None where it is NaN or infinite (JSON has neither)."""
    x = float(x)
    return x if np.isfinite(x) else None


def _ratio(a, b):
    return None if a is None or not b else _finite(a / b)


def summary(res: dict, traj, ref: dict, batched: bool = False) -> dict:
    """The run's figures (module docstring): ``res`` from :func:`run`,
    ``ref`` the reference file's arrays (its ``jaxb_`` rows for the
    batched path, ``jax_`` for the other, and the oracle's)."""
    n = len(res["t_map"])
    k = min(n, N_ORACLE)
    gt_t, gt_q = ground_truth(traj, n)
    col = {name: i for i, name in enumerate(pipeline.METRIC_NAMES)}
    pre = "jaxb_" if batched else "jax_"
    est_t, est_q = res["t_map"], res["q_map"]
    j_t, j_q = ref[pre + "t_map"][:n], ref[pre + "q_map"][:n]
    o_t, o_q = ref["oracle_t_map"][:k], ref["oracle_q_map"][:k]

    def drift(t, q, frames=n):
        d, nseg = kitti_drift(t[:frames], gt_t[:frames], est_q=q[:frames],
                              gt_q=gt_q[:frames])
        return _finite(d), nseg

    def ate(t):
        return _finite(ate_rmse(t, gt_t[:len(t)], align=False))

    eng_o, nseg_o = drift(est_t, est_q, k)
    orc = drift(o_t, o_q, k)[0]
    run_d, nseg = drift(est_t, est_q)
    gap = np.linalg.norm(est_t - j_t, axis=1)
    spans = [slice(*b["frames"]) for b in res["blocks"]]
    m = res["metrics"]
    return dict(
        # tools/oracle_drift.py's keys, over the oracle's first k frames
        n_frames=n, oracle_drift_pct=orc, engine_drift_pct=eng_o,
        engine_over_oracle=_ratio(eng_o, orc), oracle_ate_m=ate(o_t),
        engine_ate_m=ate(est_t[:k]), n_segments=nseg_o,
        max_engine_oracle_gap_m=float(
            np.linalg.norm(est_t[:k] - o_t, axis=1).max()),
        # the whole run, and JAX's over the same frames
        oracle_frames=k, run_drift_pct=run_d, run_ate_m=ate(est_t),
        run_segments=nseg, jax_drift_pct=drift(j_t, j_q)[0],
        jax_ate_m=ate(j_t), max_engine_jax_gap_m=float(gap.max()),
        jax_over_oracle=_ratio(drift(j_t, j_q, k)[0], orc),
        odom_drift_pct=drift(res["t_odom"], res["q_odom"])[0],
        map_solved=int(m[:, col["map_solved"]].sum()),
        finite=all(bool(np.isfinite(res[key]).all())
                   for key in ("t_map", "q_map", "t_odom", "q_odom")),
        # per block of BLOCK frames, by its end
        blocks=[b["frames"][1] for b in res["blocks"]],
        occupancy=[list(b["occupancy"]) for b in res["blocks"]],
        map_overflow=[float(m[sp, col["map_overflow"]].sum())
                      for sp in spans],
        map_evicted=[float(m[sp, col["map_evicted"]].sum())
                     for sp in spans],
        jax_gap_m=[float(gap[sp].max()) for sp in spans],
        ms_per_scan=[b["ms_per_scan"] for b in res["blocks"]])


def oracle_limit(jax_over_oracle) -> float:
    """The limit on the engine's drift over the oracle's: the JAX test's
    ENGINE_OVER_ORACLE_GATE, or that times JAX's own ratio where JAX's
    is above it (the port is not held tighter than its reference)."""
    if jax_over_oracle is not None and \
            jax_over_oracle > ENGINE_OVER_ORACLE_GATE:
        return ENGINE_OVER_ORACLE_GATE * jax_over_oracle
    return ENGINE_OVER_ORACLE_GATE


def gates(s: dict) -> list:
    """The failures of a whole run's :func:`summary` against
    tests/test_long_drift.py's two gates (the 500-frame run's map_solved,
    drift and ATE over the run, every pose finite; the oracle-relative
    drift over the first N_ORACLE frames). Empty when all hold."""
    n = s["n_frames"]
    checks = (
        (s["map_solved"] >= n - SOLVED_SLACK,
         f"map_solved {s['map_solved']} < {n - SOLVED_SLACK}"),
        (s["finite"], "a pose is not finite"),
        (s["run_segments"] > MIN_SEGMENTS_RUN,
         f"{s['run_segments']} segments, too short for the drift gate"),
        (s["run_drift_pct"] is not None
         and s["run_drift_pct"] < DRIFT_GATE_PCT,
         f"drift {s['run_drift_pct']} % >= {DRIFT_GATE_PCT} %"),
        (s["run_ate_m"] is not None and s["run_ate_m"] < ATE_GATE_M,
         f"ATE {s['run_ate_m']} m >= {ATE_GATE_M} m"),
        (s["n_segments"] > MIN_SEGMENTS_ORACLE,
         f"{s['n_segments']} segments over the oracle's frames"),
        (s["engine_over_oracle"] is not None and s["engine_over_oracle"]
         <= oracle_limit(s["jax_over_oracle"]),
         f"drift {s['engine_drift_pct']} % over the oracle's "
         f"{s['oracle_drift_pct']} %: ratio {s['engine_over_oracle']} > "
         f"{oracle_limit(s['jax_over_oracle'])}"))
    return [msg for ok, msg in checks if not ok]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batched", action="store_true",
                    help="step through parallel.batched_step_jit at B = 1")
    ap.add_argument("--ref", default=REF,
                    help="the reference trajectories (npz)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device "
                             "(torch.cuda.is_available() is False)")
        torch.backends.cuda.matmul.allow_tf32 = False
    traj, scans = render_scene(args.frames)
    res = run(DRIFT_CFG, scans, device, batched=args.batched)
    with np.load(args.ref) as z:
        ref = dict(z)
    print(json.dumps(summary(res, traj, ref, args.batched)))


if __name__ == "__main__":
    main()
