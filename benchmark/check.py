"""The check that decides ``correct``: what the timed path produced, held
against the plain reference (``benchmark/reference/aloam``, a frozen copy of
the step in plain PyTorch with no CUDA kernel, run on the card after the
window).

**The replay.** Logs the window played, drawn from the seed: on the fleet
path ``replay_streams`` streams of one pass, on the single path one pass.
The reference steps the same scans from a fresh state of its own, frame by
frame from frame 0 through ``replay_frames`` frames, so registration,
features, odometry, association, the LM solve, insert and evict, and the
map tables they fill, are all worked out again from the scans alone; it
takes nothing the program made. The program's outputs of every one of
those frames are compared.

Numbers compared (each with its limit in ``benchmark/workloads/<cell>.json``):
the largest position gap (m) and rotation gap (rad) of the odometry pose
(``q_odom`` / ``t_odom``) and of the mapped pose (``q_map`` / ``t_map``, as
the host received it) over the replayed frames; the largest gap of the
feature counts (exact: registration and feature selection depend on the
scan alone); and the largest relative gap of the correspondence and factor
counts of the odometry and the mapping solve.

The control (``--control``, never in a benchmark run) puts the reference in
the program's place computed in bfloat16: every float32 result of every
operation it runs is rounded to bfloat16 (:class:`Bfloat16`), while the
scans it is handed stay float32.
"""

from __future__ import annotations

import contextlib
import json
import sys
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

NUMBERS = ("t_m", "q_rad", "feature_gap", "factor_gap")
# the front half's feature counts: a function of the scan alone, so the
# same in the program and the reference, count for count
FEATURES = ("n_sharp", "n_flat", "n_less_sharp", "n_less_flat")
# the correspondences and factors of the odometry and the mapping solve
FACTORS = ("corner_corr", "plane_corr", "map_corner_factors",
           "map_surf_factors")
BLOCK = 40            # frames a block of the printed gap profile


def _ref():
    from benchmark.reference.aloam import config, pipeline
    return config, pipeline


def ref_config(cell_config: dict):
    from benchmark.harness import aloam_config
    config, _ = _ref()
    return aloam_config(config.AloamConfig, cell_config)


class Bfloat16(TorchDispatchMode):
    """Every float32 tensor an operation writes is rounded to bfloat16 (in
    float32 storage): arithmetic, reductions, gathers and solves alike.
    Views write nothing and are left alone."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) and len(returns) > 1 \
            else (out,)
        for ret, o in zip(returns, outs):
            alias = ret.alias_info
            if alias is not None and not alias.is_write:
                continue                            # a view
            for t in tree_leaves(o):
                if torch.is_tensor(t) and t.dtype == torch.float32:
                    t.copy_(t.to(torch.bfloat16))
        return out


def _host(out, b: int) -> dict:
    """A step's outputs as host arrays with a stream axis."""
    return {k: getattr(out, k).reshape(b, -1).double().cpu().numpy()
            for k in ("q_odom", "t_odom", "q_map", "t_map", "metrics")}


def run_reference(path: str, rcfg, frames, b: int, device,
                  lower=False) -> list:
    """The reference over ``frames`` (an iterable of (xyz, mask)) from a
    fresh state of B streams: the host outputs of each frame. ``lower``:
    computed in bfloat16 (the control)."""
    _, pipeline = _ref()
    step = pipeline.step_b if path == "fleet" else pipeline.step
    mode = Bfloat16 if lower else contextlib.nullcontext
    with mode():
        state = pipeline.init_state(rcfg, b, device)
    outs = []
    for xyz, mask in frames:          # the scans are made outside the mode
        with mode():
            state, out = step(state, xyz, mask, rcfg)
        outs.append(_host(out, b))
    return outs


def quat_gap(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Rotation angle (rad) between quaternions, row by row (q and -q are
    one rotation; exact 0 for equal rows, well conditioned near 0)."""
    a = q1 / np.linalg.norm(q1, axis=-1, keepdims=True)
    b = q2 / np.linalg.norm(q2, axis=-1, keepdims=True)
    b = b * np.where((a * b).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    return 4.0 * np.arctan2(np.linalg.norm(a - b, axis=-1),
                            np.linalg.norm(a + b, axis=-1))


def column_gaps(got: list, want: list, metric_names) -> dict:
    """The largest gap of each count, absolute, over frames (diagnostic)."""
    out = {}
    for i, n in enumerate(metric_names):
        out[n] = max(float(np.max(np.abs(g["metrics"][:, i]
                                         - w["metrics"][:, i]), initial=0))
                     for g, w in zip(got, want))
    return out


def gaps(got: list, want: list, metric_names) -> dict:
    """Over frames of host outputs: the largest position gap t (m) and
    rotation gap q (rad) of both poses, the largest feature-count gap f
    (absolute) and the largest factor-count gap c (relative, against at
    least 1). NaN reads as infinitely far."""
    feat = [metric_names.index(n) for n in FEATURES]
    fac = [metric_names.index(n) for n in FACTORS]
    t = q = f = c = 0.0
    for g, w in zip(got, want, strict=True):
        for qk, tk in (("q_odom", "t_odom"), ("q_map", "t_map")):
            t = max(t, float(np.max(np.linalg.norm(g[tk] - w[tk], axis=-1),
                                    initial=0.0)))
            q = max(q, float(np.max(quat_gap(g[qk], w[qk]), initial=0.0)))
        gm, wm = g["metrics"], w["metrics"]
        f = max(f, float(np.max(np.abs(gm[:, feat] - wm[:, feat]),
                                initial=0.0)))
        c = max(c, float(np.max(np.abs(gm[:, fac] - wm[:, fac])
                                / np.maximum(np.abs(wm[:, fac]), 1),
                                initial=0.0)))
    return {k: (v if np.isfinite(v) else float("inf"))
            for k, v in zip("tqfc", (t, q, f, c))}


class Replay(NamedTuple):
    pass_: int            # the pass whose logs are replayed
    streams: tuple        # the streams of that pass replayed
    frames: int           # frames 0 .. frames - 1 of each


def choose(cell, prog, window, seed: int) -> Replay:
    """The replay, drawn from the seed: a pass among those whose first
    ``replay_frames`` frames the window stepped (or, where none did, among
    those that got furthest, over as many frames), and on the fleet path
    ``replay_streams`` of its streams."""
    reached = {}
    for p, f in window.schedule:
        reached[p] = max(reached.get(p, 0), f + 1)
    n = min(cell.check["replay_frames"], prog.frames, max(reached.values()))
    done = sorted(p for p, k in reached.items() if k >= n)
    rng = np.random.default_rng([seed % (1 << 63), 3])
    p = int(done[rng.integers(len(done))])
    k = cell.check.get("replay_streams", 1) if prog.path == "fleet" else 1
    streams = tuple(sorted(rng.choice(prog.streams, size=k,
                                      replace=False).tolist()))
    return Replay(p, streams, n)


def compare(prog, window, replay: Replay, rcfg, metric_names,
            control=False) -> dict:
    """The numbers of one run (see the module docstring); the control's
    with ``control``."""
    path, b = prog.path, prog.streams
    index = {pf: i for i, pf in enumerate(window.schedule)}
    rows = list(replay.streams)
    sel = torch.tensor(rows, device=prog.device)

    def scans():
        for f in range(replay.frames):
            x, m = prog.frame(replay.pass_, f)
            yield (x[sel], m[sel]) if path == "fleet" else (x, m)

    def program(f):
        i = index[(replay.pass_, f)]
        got = _host(window.outs[i], b)
        got["q_map"] = window.poses[i][:, :4].astype(np.float64)
        got["t_map"] = window.poses[i][:, 4:].astype(np.float64)
        return {k: v[rows] for k, v in got.items()}

    k = len(rows)
    want = run_reference(path, rcfg, scans(), k, prog.device)
    got = run_reference(path, rcfg, scans(), k, prog.device,
                        lower=True) if control else \
        [program(f) for f in range(replay.frames)]
    g = gaps(got, want, metric_names)
    profile = [gaps(got[i:i + BLOCK], want[i:i + BLOCK], metric_names)
               for i in range(0, replay.frames, BLOCK)]
    who = "control" if control else "program"
    print(f"[check] {who}: largest gaps by {BLOCK} frames: t m "
          + ", ".join(repr(x["t"]) for x in profile) + "; q rad "
          + ", ".join(repr(x["q"]) for x in profile), file=sys.stderr,
          flush=True)
    print(f"[check] {who}: largest count gaps " + json.dumps(column_gaps(
        got, want, metric_names)), file=sys.stderr, flush=True)
    return {"t_m": g["t"], "q_rad": g["q"], "feature_gap": g["f"],
            "factor_gap": g["c"]}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[n] <= limits[n] for n in NUMBERS)


def say(numbers: dict, limits: dict, stream=sys.stderr) -> None:
    """Each number beside its limit, one line each (a run's last lines on
    standard error)."""
    for n in NUMBERS:
        print(f"[check] {n} {numbers[n]!r} limit {limits[n]!r}", file=stream,
              flush=True)
