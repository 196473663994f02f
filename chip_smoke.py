"""Drive the PyTorch/CUDA port's SLAM step once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA:

    python3 chip_smoke.py

It needs no JAX: of the JAX package it imports only the framework-free
``aloam_tpu.config``, ``aloam_tpu.io.synthetic`` and ``aloam_tpu.eval.ate``.
Phases, each printing its own lines:

1. device: the card's name and power limit (from nvidia-smi), torch and
   CUDA versions; TF32 off;
2. build: the six CUDA kernels from ``aloam_tpu_torch/csrc/`` (one nvcc
   per source, sm_90a);
3. data: B = 16 synthetic HDL-64 streams of 8 frames (the bench's seeds
   and speeds), padded to the bench config (``bench.batched_bench_cfg``:
   ring_cap 1856, n_raw 115200, less_flat_cap 36864, assoc_cspan 128,
   map_query_chunk 2048), cached under ``.bench_cache/``;
4. kernels: each kernel against its plain PyTorch version on the card, on
   every distinct input shape the main path gave it in frame 1 of
   ``step_b``, with the stated tolerance, and both timed with CUDA events;
5. front: ``pipeline.front_step_b`` over the first 5 frames with the
   kernels (its four launch counters must rise) and with the plain
   versions; per-frame odometry poses must agree;
6. step: ``pipeline.step_b`` over the 8 frames with the kernels (all six
   launch counters must rise) and with the plain versions; map poses must
   agree (tightly unless a gate flipped); a third kernel run times each
   stage and mapping sub-stage with CUDA events; scans/s, peak device
   memory and the odometry and mapped ATE against the ground truth (must
   be < 0.5 m).

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line; so does a machine without a CUDA card.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np

B = 16
N_FRAMES = 8           # bench.py's batched default
N_FRONT = 5            # frames of the front_step_b phase
N_AZIMUTH = 1800
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache",
                     f"chip_smoke_hdl64_a{N_AZIMUTH}_b{B}_f{N_FRAMES}.npz")
# kernel name -> (module, kernel function, plain function, CUDA source,
# the Pallas kernel it replaces at its pallas_call)
KERNELS = {
    "select_rings": ("select", "select_rings", "select_rings_plain",
                     "aloam_tpu_torch/csrc/select.cu",
                     "aloam_tpu/ops/pallas_select.py:141"),
    "segmented_prefix_sums": ("voxel", "segmented_prefix_sums",
                              "segmented_prefix_sums_plain",
                              "aloam_tpu_torch/csrc/seg_scan.cu",
                              "aloam_tpu/ops/pallas_voxel.py:98"),
    "window_mins": ("odom", "window_mins", "window_mins_plain",
                    "aloam_tpu_torch/csrc/odom_window.cu",
                    "aloam_tpu/ops/pallas_odom.py:199"),
    "lm_fused": ("lm", "lm_fused", "lm_fused_plain",
                 "aloam_tpu_torch/csrc/lm.cu",
                 "aloam_tpu/ops/pallas_lm.py:326"),
    "assoc_cell": ("assoc", "assoc_cell", "assoc_cell_plain",
                   "aloam_tpu_torch/csrc/assoc.cu",
                   "aloam_tpu/ops/pallas_assoc.py:356"),
    "merge_tiles": ("insert", "merge_tiles", "merge_tiles_plain",
                    "aloam_tpu_torch/csrc/insert.cu",
                    "aloam_tpu/ops/pallas_insert.py:167"),
}
FRONT_KERNELS = ("select_rings", "segmented_prefix_sums", "window_mins",
                 "lm_fused")
# step_b's stages and mapping sub-stages, timed with CUDA events:
# label -> (module, attribute called through it)
STAGES = {
    "register": ("aloam_tpu_torch.pipeline", "register_scan_b"),
    "features": ("aloam_tpu_torch.pipeline", "extract_features_b"),
    "odometry": ("aloam_tpu_torch.odometry", "odometry_step_b"),
    "mapping": ("aloam_tpu_torch.mapping", "mapping_step_b"),
    "map.evict": ("aloam_tpu_torch.mapping", "_eager_evict_count"),
    "map.downsample": ("aloam_tpu_torch.mapping",
                       "voxel_downsample_masked_b"),
    "map.cache_build": ("aloam_tpu_torch.ops.gridmap", "knn_cache_b"),
    "map.assoc": ("aloam_tpu_torch.mapping", "_assoc_out8_b"),
    "map.lm": ("aloam_tpu_torch.mapping", "lm_solve_b"),
    "map.insert": ("aloam_tpu_torch.ops.gridmap", "insert_vds_b"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def bench_cfg():
    """bench.batched_bench_cfg() (bench.py imports JAX, so its fields are
    copied here)."""
    from aloam_tpu.config import PRESETS
    return PRESETS["HDL-64"].replace(ring_cap=N_AZIMUTH + 56,
                                     n_raw=64 * N_AZIMUTH,
                                     less_flat_cap=36864, assoc_cspan=128,
                                     map_query_chunk=2048)


def make_streams(cfg):
    """(F, B, n_raw, 3) xyz, (F, B, n_raw) mask, (B, F, 3) ground truth:
    the bench's streams (seed 100 + b, speed 5 + 0.25 b m/s)."""
    if os.path.exists(CACHE):
        z = np.load(CACHE)
        return z["xyz"], z["mask"], z["gt"]
    from aloam_tpu.io import synthetic as syn
    xyz = np.zeros((N_FRAMES, B, cfg.n_raw, 3), np.float32)
    mask = np.zeros((N_FRAMES, B, cfg.n_raw), bool)
    gt = np.zeros((B, N_FRAMES, 3), np.float32)
    for b in range(B):
        scans, traj = syn.make_sequence(N_FRAMES, scan_lines=64,
                                        n_azimuth=N_AZIMUTH, seed=100 + b,
                                        speed=5.0 + 0.25 * b)
        for f, s in enumerate(scans):
            if s.shape[0] > cfg.n_raw:
                fail(f"stream {b} frame {f}: {s.shape[0]} points > n_raw")
            xyz[f, b], mask[f, b] = syn.pad_scan(s, cfg.n_raw)
        gt[b] = traj.trans - traj.trans[0]
    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    tmp = CACHE + f".{os.getpid()}.tmp.npz"
    np.savez(tmp, xyz=xyz, mask=mask, gt=gt)
    os.replace(tmp, CACHE)
    return xyz, mask, gt


class Patched:
    """Swap module attributes for the duration of a with-block."""

    def __init__(self, swaps):
        self.swaps = swaps               # [(module, name, replacement)]
        self.saved = []

    def __enter__(self):
        for mod, name, fn in self.swaps:
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved.clear()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, CUDA events around `reps` calls after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_frames(step, pipeline, cfg, frames, device):
    """``step`` (front_step_b or step_b) over every frame from a fresh
    state; returns the per-frame outputs (on the host, as dicts) and host
    milliseconds per frame."""
    import torch
    st = pipeline.init_state(cfg, B, device)
    outs, ms = [], []
    for xyz, mask in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, out = step(st, xyz, mask, cfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append({k: (v.cpu().numpy() if torch.is_tensor(v) else
                         {n: m.cpu().numpy() for n, m in v.items()})
                     for k, v in out._asdict().items()})
    return outs, ms


def absdiff(got, want):
    """|got - want| with equal entries (inf included) at 0."""
    import torch
    return torch.where(got == want, 0.0, (got.double() - want.double()).abs())


def compare(name, got, want, kind=None):
    """max_abs_err of a kernel against its plain version, failing past the
    kernel's tolerance:
      select_rings           labels exact;
      segmented_prefix_sums  |k - p| <= 1e-5 + 1e-6 |p| (f32 summation
                             order; sums reach ~1e3 at HDL-64 coordinates,
                             where one f32 ulp is ~6e-5), count channel
                             exact;
      window_mins            exact: both compute d2 with the same
                             rounded operations in the same order;
      lm_fused               q atol 2e-5, t atol 2e-4, cost0 rtol 2e-4,
                             cost rtol 2e-3, counts exact (reduction order
                             and unpivoted elimination vs LU);
      assoc_cell             ok flags differ on at most 1 query in 10^4 and
                             columns of queries live in both within 1e-4:
                             d2, select and fit are the same rounded
                             operations in the same order (bit-equal where
                             measured), a margin for a near-tie;
      merge_tiles            every output exact (no arithmetic but the
                             midpoint and the priority formula, identical)."""
    import torch
    if name == "select_rings":
        err = absdiff(got, want).max().item()
        ok = torch.equal(got, want)
    elif name == "segmented_prefix_sums":
        d = absdiff(got, want)
        err = d.max().item()
        ok = bool((d <= 1e-5 + 1e-6 * want.abs()).all()) \
            and torch.equal(got[-1], want[-1])
    elif name in ("window_mins", "merge_tiles"):
        err = max(absdiff(g, w).max().item() for g, w in zip(got, want))
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
    elif name == "assoc_cell":
        okc = 6 if kind == "corner" else 4
        live = (got[:, okc] > 0) & (want[:, okc] > 0)
        flips = (got[:, okc] != want[:, okc]).sum().item()
        err = absdiff(got[live], want[live]).max().item() if live.any() \
            else 0.0
        ok = flips <= max(1, want.shape[0] // 10000) and err <= 1e-4 \
            and live.sum().item() > 0
    else:
        d = absdiff(got, want)
        rel = d[:, 7:9] / want[:, 7:9].abs().clamp_min(1e-12)
        err = d[:, :7].max().item()
        ok = (d[:, 0:4].max() <= 2e-5 and d[:, 4:7].max() <= 2e-4
              and rel[:, 0].max() <= 2e-4 and rel[:, 1].max() <= 2e-3
              and torch.equal(got[:, 9:], want[:, 9:]))
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err:.6g})")
    return err


def check_kernels(pipeline, mods, cfg, frames, device, card):
    """Phase 4: record each kernel's inputs in frame 1 of step_b (one
    record per distinct shape), then compare and time kernel and plain
    version on them. Returns {name: dict(max_abs_err, ms, plain_ms)}, the
    times of each kernel's largest input."""
    import torch
    recorded = {}                       # (name, signature) -> (args, kw)

    def recorder(name, fn):
        def call(*args, **kw):
            key = (name, tuple(tuple(a.shape) if torch.is_tensor(a) else a
                               for a in args if not isinstance(a, float)))
            if key not in recorded:
                recorded[key] = (tuple(a.clone() if torch.is_tensor(a) else a
                                       for a in args), dict(kw))
            return fn(*args, **kw)
        return call

    st = pipeline.init_state(cfg, B, device)
    st, _ = pipeline.step_b(st, *frames[0], cfg)
    swaps = [(mods[n], spec[1], recorder(n, getattr(mods[n], spec[1])))
             for n, spec in KERNELS.items()]
    with Patched(swaps):
        pipeline.step_b(st, *frames[1], cfg)
    torch.cuda.synchronize()
    del st

    results = {}
    for (name, _), (args, kw) in sorted(recorded.items(),
                                        key=lambda kv: str(kv[0])):
        mod, spec = mods[name], KERNELS[name]
        kern, plain = getattr(mod, spec[1]), getattr(mod, spec[2])
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        extra = [a for a in args if isinstance(a, (str, bool))]
        err = compare(name, got, want, *extra[:1])
        ms = cuda_ms(lambda: kern(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 5)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        size = sum(a.numel() for a in args if torch.is_tensor(a))
        say(f"[kernel] {name}{extra if extra else ''}: inputs {shapes} "
            f"max_abs_err {err:.3g} kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms ({card})")
        prev = results.get(name)
        if prev is None or size > prev["size"]:
            results[name] = dict(max_abs_err=max(err, prev["max_abs_err"])
                                 if prev else err, ms=ms, plain_ms=plain_ms,
                                 size=size)
        else:
            prev["max_abs_err"] = max(err, prev["max_abs_err"])
    missing = set(KERNELS) - set(results)
    if missing:
        fail(f"the main path never called {sorted(missing)}")
    return results


def run_front(pipeline, mods, cfg, frames, device, card):
    """Phase 5: front_step_b with the kernels and with the plain
    versions."""
    for name in FRONT_KERNELS:
        mods[name].launches = 0
    k_outs, k_ms = run_frames(pipeline.front_step_b, pipeline, cfg, frames,
                              device)
    launches = {name: mods[name].launches for name in FRONT_KERNELS}
    say(f"[front] kernel launches over {len(frames)} frames: {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the front path was never launched: {launches}")
    with Patched([(mods[n], KERNELS[n][1], getattr(mods[n], KERNELS[n][2]))
                  for n in FRONT_KERNELS]):
        p_outs, p_ms = run_frames(pipeline.front_step_b, pipeline, cfg,
                                  frames, device)
    cols = [lambda o, c=c: o["metrics"][c]
            for c in ("corner_corr", "plane_corr")]
    for f, (ko, po) in enumerate(zip(k_outs, p_outs)):
        flipped = np.zeros(B, bool)
        for c in cols:
            flipped |= c(ko) != c(po)
        dq = np.abs(ko["q_odom"] - po["q_odom"]).max(axis=1)
        dt = np.abs(ko["t_odom"] - po["t_odom"]).max(axis=1)
        if not np.isfinite(ko["t_odom"]).all():
            fail(f"front frame {f}: non-finite pose")
        say(f"[front] frame {f}: kernel {k_ms[f]:.1f} ms plain {p_ms[f]:.1f} "
            f"ms; max |dq| {dq.max():.3g} max |dt| {dt.max():.3g} m")
        bad = ((dq > 1e-3) | (dt > 5e-3)) & ~flipped
        if bad.any():
            fail(f"front frame {f}: poses differ without a gate flip in "
                 f"streams {np.flatnonzero(bad).tolist()}")
    sk, sp = float(np.mean(k_ms[1:])), float(np.mean(p_ms[1:]))
    say(f"[front] frames 1-{len(frames) - 1}: kernels {sk:.2f} ms/frame = "
        f"{B * 1e3 / sk:.1f} scans/s; plain {sp:.2f} ms/frame = "
        f"{B * 1e3 / sp:.1f} scans/s (B={B}, {card})")


def stage_times(pipeline, cfg, frames, device):
    """A kernel run of step_b with CUDA events around each stage and
    mapping sub-stage (the device time between the stage's first and last
    operation). Returns {label: per-frame ms list}."""
    import torch
    events = {label: [] for label in STAGES}

    def timed(label, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            events[label][-1].append((start, end))
            return out
        return call

    swaps = []
    for label, (mod_name, attr) in STAGES.items():
        mod = importlib.import_module(mod_name)
        swaps.append((mod, attr, timed(label, getattr(mod, attr))))
    per_frame = {label: [] for label in STAGES}
    with Patched(swaps):
        st = pipeline.init_state(cfg, B, device)
        for xyz, mask in frames:
            for label in STAGES:
                events[label].append([])
            st, _ = pipeline.step_b(st, xyz, mask, cfg)
            torch.cuda.synchronize()
            for label in STAGES:
                per_frame[label].append(sum(s.elapsed_time(e)
                                            for s, e in events[label][-1]))
    return per_frame


def run_step(pipeline, mods, cfg, frames, gt, device, card):
    """Phase 6: step_b with the kernels, with the plain versions, and a
    staged kernel run."""
    import torch
    from aloam_tpu.eval.ate import ate_rmse
    from aloam_tpu_torch.pipeline import METRIC_NAMES

    for mod in mods.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    k_outs, k_ms = run_frames(pipeline.step_b, pipeline, cfg, frames, device)
    peak = torch.cuda.max_memory_allocated(device)
    launches = {name: mods[name].launches for name in KERNELS}
    say(f"[step] kernel launches over {len(frames)} frames: {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the step was never launched: {launches}")
    with Patched([(mods[n], spec[1], getattr(mods[n], spec[2]))
                  for n, spec in KERNELS.items()]):
        p_outs, p_ms = run_frames(pipeline.step_b, pipeline, cfg, frames,
                                  device)
    if any(mods[n].launches != launches[n] for n in KERNELS):
        fail("the plain run launched a kernel")

    col = {n: i for i, n in enumerate(METRIC_NAMES)}
    gates = ("corner_corr", "plane_corr", "map_corner_factors",
             "map_surf_factors", "map_solved")
    flipped = np.zeros(B, bool)
    for f, (ko, po) in enumerate(zip(k_outs, p_outs)):
        for name in ("q_odom", "t_odom", "q_map", "t_map"):
            if ko[name].shape[0] != B or not np.isfinite(ko[name]).all():
                fail(f"step frame {f}: non-finite or misshapen {name}")
        # a gate that flipped on a rounding difference (the f64 plain
        # segmented sums, summation order) changes a count; from then on
        # that stream may drift apart
        for g in gates:
            flipped |= ko["metrics"][:, col[g]] != po["metrics"][:, col[g]]
        dq = np.abs(ko["q_map"] - po["q_map"]).max(axis=1)
        dt = np.abs(ko["t_map"] - po["t_map"]).max(axis=1)
        say(f"[step] frame {f}: kernel {k_ms[f]:.1f} ms plain {p_ms[f]:.1f} "
            f"ms; map max |dq| {dq.max():.3g} max |dt| {dt.max():.3g} m; "
            f"gate flips in streams {np.flatnonzero(flipped).tolist()}")
        # with a flip, the bound JAX holds its own batched and single
        # mapping paths to (tests/test_batched_kernels.py)
        bad = (((dq > 1e-3) | (dt > 5e-3)) & ~flipped) \
            | (dq > 2.5e-2) | (dt > 2.5e-2)
        if bad.any():
            fail(f"step frame {f}: map poses differ in streams "
                 f"{np.flatnonzero(bad).tolist()}")

    sk, sp = float(np.mean(k_ms[1:])), float(np.mean(p_ms[1:]))
    say(f"[step] frames 1-{len(frames) - 1}: kernels {sk:.2f} ms/frame = "
        f"{B * 1e3 / sk:.1f} scans/s; plain {sp:.2f} ms/frame = "
        f"{B * 1e3 / sp:.1f} scans/s; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB (B={B}, {card})")

    per_frame = stage_times(pipeline, cfg, frames, device)
    med = {label: float(np.median(v[1:])) for label, v in per_frame.items()}
    say(f"[step] device ms per frame by stage, CUDA events, median of frames "
        f"1-{len(frames) - 1}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items()) + f" ({card})")

    last = k_outs[-1]["metrics"]
    say("[step] last-frame metrics (stream 0): "
        + json.dumps({n: float(last[0, i]) for n, i in col.items()}))
    if not last[:, col["map_solved"]].all():
        fail("mapping did not solve in every stream")
    for name, key in (("odometry", "t_odom"), ("mapped", "t_map")):
        est = np.stack([o[key] for o in k_outs], axis=1)          # (B, F, 3)
        ate = np.array([ate_rmse(est[b], gt[b], align=False)
                        for b in range(B)])
        say(f"[step] {name} ATE vs ground truth over {len(frames)} frames: "
            f"max {ate.max():.4f} m, median {np.median(ate):.4f} m, per "
            f"stream {np.round(ate, 4).tolist()}")
        if not (np.isfinite(ate).all() and ate.max() < 0.5):
            fail(f"{name} pose does not track the ground truth")
    return launches


def main() -> None:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    from aloam_tpu_torch import pipeline
    from aloam_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"{kind}, power limit not readable"
    say(card)                 # as nvidia-smi gives it: name, power limit
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} python {sys.version.split()[0]}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    say(f"[build] {len(_build.sources())} CUDA sources -> {lib_path.name} "
        f"in {time.perf_counter() - t0:.1f} s")

    # ---- 3. data --------------------------------------------------------
    cfg = bench_cfg()
    t0 = time.perf_counter()
    xyz, mask, gt = make_streams(cfg)
    frames = [(torch.from_numpy(xyz[f]).to(device),
               torch.from_numpy(mask[f]).to(device))
              for f in range(N_FRAMES)]
    say(f"[data] B={B} HDL-64 streams x {N_FRAMES} frames, "
        f"{int(mask.sum(axis=2).mean())} points/scan, n_raw {cfg.n_raw}, "
        f"ring_cap {cfg.ring_cap}, less_flat_cap {cfg.less_flat_cap}, "
        f"assoc_cspan {cfg.assoc_cspan}, map_query_chunk "
        f"{cfg.map_query_chunk} ({time.perf_counter() - t0:.1f} s)")

    # ---- 4-6. kernels, the front half, the whole step ---------------------
    mods = {name: importlib.import_module(f"aloam_tpu_torch.ops.{spec[0]}")
            for name, spec in KERNELS.items()}
    results = check_kernels(pipeline, mods, cfg, frames, device, card)
    run_front(pipeline, mods, cfg, frames[:N_FRONT], device, card)
    launches = run_step(pipeline, mods, cfg, frames, gt, device, card)

    kernels = [dict(name=name, route="cuda", source=spec[3],
                    replaces=spec[4], launches=launches[name],
                    max_abs_err=results[name]["max_abs_err"],
                    ms=results[name]["ms"],
                    plain_ms=results[name]["plain_ms"])
               for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
