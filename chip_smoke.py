"""Drive the PyTorch/CUDA port's SLAM steps once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA:

    python3 chip_smoke.py

It imports torch, numpy and the port (``aloam_tpu_torch``), and nothing
of JAX or of the JAX package. Phases, each printing its own lines:

1. device: the card's name and power limit (from nvidia-smi), torch and
   CUDA versions; TF32 off;
2. build: the seven CUDA kernels from ``aloam_tpu_torch/csrc/`` (one nvcc
   per source, sm_90a);
3. data: B = 16 synthetic HDL-64 streams of 8 frames (the bench's seeds
   and speeds), padded to the bench config (``bench.batched_bench_cfg``:
   ring_cap 1856, n_raw 115200, less_flat_cap 36864, assoc_cspan 128,
   map_query_chunk 2048), and the single-stream bench scene (seed 42,
   10 m/s, padded to ``PRESETS["HDL-64"]``), cached under
   ``.bench_cache/``;
4. kernels: each of step_b's six kernels against its plain PyTorch
   version on the card, on every distinct input shape the main path gave
   it in frame 1 of ``step_b``, with the stated tolerance, both timed
   with CUDA events (the kernel back to back, its wrapper's host cost
   included, and queued behind a sleep for its device time alone),
   beside the kernel's bound (the least time the card could take for the
   same work, from the bytes and the operations these inputs need); then
   ``window_mins`` and ``segmented_prefix_sums`` on adversarial inputs
   (an all-poisoned reference, duplicate points, queries on the first
   and last rings, with and without ``ring_seg``;
   rows without heads across many tiles, heads only at tile boundaries,
   a row length that is not a multiple of 4, 70000 short rows);
5. front: ``pipeline.front_step_b`` over the first 5 frames with the
   kernels (its four launch counters must rise, and every odometry search
   must declare ``ring_seg`` > 0) and with the plain versions; per-frame
   odometry poses must agree;
6. step: ``pipeline.step_b`` over the 8 frames with the kernels (its six
   launch counters must rise, ``ring_seg`` > 0 as in phase 5) and with
   the plain versions; map poses must agree (tightly unless a gate
   flipped); a third kernel run times each stage and mapping sub-stage
   with CUDA events (its device span), a fourth under torch.profiler
   gives each stage's device busy time and the device's idle share;
   scans/s, peak device
   memory and the odometry and mapped ATE against the ground truth (must
   be < 0.5 m);
7. single-stream kernels: each of the single-stream step's six kernels
   against its plain version, timed and bounded as in phase 4, at the
   inputs frame 1 of the single-stream step gave them, and
   ``knn_select`` at one B = 16 ``corner_associations_b`` /
   ``surf_associations_b`` call on the map phase 6 left;
8. single: ``pipeline.step`` over the single-stream scene's 8 frames at
   ``PRESETS["HDL-64"]`` with the kernels (its six launch counters, knn
   among them, must rise; ``ring_seg`` > 0) and with the plain versions;
   map poses as in phase 6; ms/scan, peak device memory, a staged kernel
   run as in phase 6, and the odometry and mapped ATE (< 0.5 m);
9. cli: ``aloam_tpu_torch.cli.main`` over 4 synthetic HDL-64 frames with a
   checkpoint every 2, its eval.json and metrics.jsonl read back, and a
   run resumed from the frame-2 checkpoint must give frame 3's pose.

The second-to-last line is a JSON object with one entry per kernel (its
launches on the main path, worst error, kernel ms back to back, device
ms, plain and bound ms at its largest input); the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; so does a machine without a CUDA card.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

B = 16
N_FRAMES = 8           # bench.py's batched default
N_FRONT = 5            # frames of the front_step_b phase
N_AZIMUTH = 1800
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache")
CACHE = os.path.join(CACHE_DIR,
                     f"chip_smoke_hdl64_a{N_AZIMUTH}_b{B}_f{N_FRAMES}.npz")
# the single-stream bench scene (bench.bench_single: seed 42, 10 m/s)
SINGLE_SEED, SINGLE_SPEED = 42, 10.0
SINGLE_CACHE = os.path.join(
    CACHE_DIR, f"chip_smoke_single_hdl64_a{N_AZIMUTH}_f{N_FRAMES}_"
    f"s{SINGLE_SEED}.npz")
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
    "knn_select": ("knn", "knn_select", "knn_select_plain",
                   "aloam_tpu_torch/csrc/knn.cu",
                   "aloam_tpu/ops/pallas_knn.py:108"),
}
# the kernels each path runs
FRONT_KERNELS = ("select_rings", "segmented_prefix_sums", "window_mins",
                 "lm_fused")
STEP_KERNELS = FRONT_KERNELS + ("assoc_cell", "merge_tiles")
SINGLE_KERNELS = FRONT_KERNELS + ("merge_tiles", "knn_select")
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM3
# bytes/s and fp32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
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
# the single-stream step's stages: its front half is step_b's at B = 1,
# its mapping searches exactly every round (gridmap.knn)
SINGLE_STAGES = {
    **{k: v for k, v in STAGES.items() if k in ("register", "features",
                                                 "odometry", "map.evict",
                                                 "map.downsample",
                                                 "map.lm", "map.insert")},
    "mapping": ("aloam_tpu_torch.mapping", "mapping_step"),
    "map.knn": ("aloam_tpu_torch.ops.gridmap", "knn"),
    "map.fit": ("aloam_tpu_torch.ops.assoc", "assoc_xla"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def bench_cfg():
    """bench.batched_bench_cfg() (bench.py imports JAX, so its fields are
    copied here)."""
    from aloam_tpu_torch.config import PRESETS
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
    from aloam_tpu_torch.io import synthetic as syn
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


def make_single(cfg):
    """(F, n_raw, 3) xyz, (F, n_raw) mask, (F, 3) ground truth of
    bench.bench_single's scene, padded to cfg.n_raw."""
    if os.path.exists(SINGLE_CACHE):
        z = np.load(SINGLE_CACHE)
        return z["xyz"], z["mask"], z["gt"]
    from aloam_tpu_torch.io import synthetic as syn
    scans, traj = syn.make_sequence(N_FRAMES, scan_lines=64,
                                    n_azimuth=N_AZIMUTH, seed=SINGLE_SEED,
                                    speed=SINGLE_SPEED)
    pads = [syn.pad_scan(s, cfg.n_raw) for s in scans]
    xyz = np.stack([p[0] for p in pads])
    mask = np.stack([p[1] for p in pads])
    gt = (traj.trans - traj.trans[0]).astype(np.float32)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = SINGLE_CACHE + f".{os.getpid()}.tmp.npz"
    np.savez(tmp, xyz=xyz, mask=mask, gt=gt)
    os.replace(tmp, SINGLE_CACHE)
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


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls after
    one warm-up call, back to back: a short kernel's time is then its
    wrapper's host launch cost, as the main path pays it. With ``queued``
    the calls wait behind a ~10 ms sleep kernel, so the host has launched
    them all before the first starts and the time is the device's
    alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_frames(step, pipeline, cfg, frames, device, batch=B):
    """``step`` (front_step_b, step_b, or step with batch 1) over every
    frame from a fresh state; returns the per-frame outputs (on the host,
    as dicts), host milliseconds per frame and the final state."""
    import torch
    st = pipeline.init_state(cfg, batch, device)
    outs, ms = [], []
    for xyz, mask in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, out = step(st, xyz, mask, cfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append({k: (v.cpu().numpy() if torch.is_tensor(v) else
                         {n: m.cpu().numpy() for n, m in v.items()})
                     for k, v in out._asdict().items() if v is not None})
    return outs, ms, st


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
                             midpoint and the priority formula, identical);
      knn_select             d2 and neighbours exact (the same rounded
                             operations in the same order, lowest-index
                             ties)."""
    import torch
    if name == "select_rings":
        err = absdiff(got, want).max().item()
        ok = torch.equal(got, want)
    elif name == "segmented_prefix_sums":
        d = absdiff(got, want)
        err = d.max().item()
        ok = bool((d <= 1e-5 + 1e-6 * want.abs()).all()) \
            and torch.equal(got[-1], want[-1])
    elif name in ("window_mins", "merge_tiles", "knn_select"):
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


def _nbytes(x) -> int:
    import torch
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(y) for y in x)
    return 0


def window_rows(ref, idx_nn, nearby: float, ring_seg: int):
    """(B, Q) rows that pass 2 of window_mins scans per query, chosen as
    the kernel chooses them: the query's ring window when ``ring_seg`` > 0
    and its nearest neighbour lies on a real ring, else all M."""
    import torch
    m = ref.shape[2]
    br = ref[:, 3].gather(1, idx_nn.long())
    if ring_seg <= 0:
        return torch.full(br.shape, m, device=br.device)
    real = (br >= 0) & (br < m // ring_seg) & (br == br.floor())
    r = torch.where(real, br, 0.0).long()
    nb = math.floor(nearby)
    lo = ((r - nb) * ring_seg).clamp(0, m)
    hi = ((r + nb + 1) * ring_seg).clamp(0, m)
    return torch.where(real, hi - lo, m)


def kernel_work(name, args, kw, out):
    """(bytes, flops) a call must cost at least: every input read once and
    every output written once; the arithmetic these inputs need, 8 flops
    per d2 (window_mins: every (query, point) pair of pass 1 and the rows
    each query's pass 2 scans; knn_select and assoc_cell: every candidate
    of each query's row) and one add per element and channel of the
    segmented scan. select_rings, lm_fused and merge_tiles count bytes
    only: their arithmetic per byte is far below the card's balance."""
    nbytes = _nbytes(list(args)) + _nbytes(list(kw.values())) + _nbytes(out)
    flops = 0
    if name == "window_mins":
        sel, ref, nearby = args[0], args[1], args[2]
        ring_seg = args[4] if len(args) > 4 else kw.get("ring_seg", 0)
        pairs = sel.shape[0] * sel.shape[1] * ref.shape[2]
        flops = 8 * (pairs + int(window_rows(ref, out[1], nearby,
                                             ring_seg).sum()))
    elif name == "segmented_prefix_sums":
        flops = args[0].numel()
    elif name in ("knn_select", "assoc_cell"):
        flops = 8 * args[2].shape[0] * 8 * (args[0].shape[1] // 24)
    return nbytes, flops


def bound_of(nbytes: int, flops: int):
    """(bound ms, what bounds it) against the card's published peaks."""
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def record_inputs(mods, names, drive):
    """Run ``drive()`` with each named kernel's wrapper recording its
    inputs, one record per distinct input signature. Returns {(name,
    signature): (args, kw)}."""
    import torch
    recorded = {}

    def recorder(name, fn):
        def call(*args, **kw):
            key = (name, tuple(tuple(a.shape) if torch.is_tensor(a) else a
                               for a in args if not isinstance(a, float)))
            if key not in recorded:
                recorded[key] = (tuple(a.clone() if torch.is_tensor(a) else a
                                       for a in args), dict(kw))
            return fn(*args, **kw)
        return call

    swaps = [(mods[n], KERNELS[n][1], recorder(n, getattr(mods[n],
                                                          KERNELS[n][1])))
             for n in names]
    with Patched(swaps):
        drive()
    torch.cuda.synchronize()
    missing = set(names) - {name for name, _ in recorded}
    if missing:
        fail(f"the main path never called {sorted(missing)}")
    return recorded


def check_recorded(mods, recorded, results, card):
    """Compare and time kernel and plain version on each recorded input;
    ``results`` keeps per kernel the worst error and the times of its
    largest input."""
    import torch
    for (name, _), (args, kw) in sorted(recorded.items(),
                                        key=lambda kv: str(kv[0])):
        mod, spec = mods[name], KERNELS[name]
        kern, plain = getattr(mod, spec[1]), getattr(mod, spec[2])
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        extra = [a for a in args if isinstance(a, (str, bool, int))]
        err = compare(name, got, want,
                      *[a for a in extra if isinstance(a, str)])
        nbytes, flops = kernel_work(name, args, kw, got)
        bound_ms, bound_by = bound_of(nbytes, flops)
        ms = cuda_ms(lambda: kern(*args, **kw), 20)
        device_ms = cuda_ms(lambda: kern(*args, **kw), 20, queued=True)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 5)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        size = sum(a.numel() for a in args if torch.is_tensor(a))
        say(f"[kernel] {name}{extra if extra else ''}: inputs {shapes} "
            f"max_abs_err {err:.3g} kernel {ms:.4f} ms (device "
            f"{device_ms:.4f}) plain {plain_ms:.4f} ms bound {bound_ms:.4f} "
            f"ms ({bound_by}: "
            f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP) ({card})")
        prev = results.get(name)
        if prev is None or size > prev["size"]:
            results[name] = dict(max_abs_err=max(err, prev["max_abs_err"])
                                 if prev else err, ms=ms, device_ms=device_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, size=size)
        else:
            prev["max_abs_err"] = max(err, prev["max_abs_err"])


def check_kernels(pipeline, mods, cfg, frames, device, card):
    """Phase 4: step_b's kernels at the inputs frame 1 of step_b gives
    them. Returns {name: dict(max_abs_err, ms, plain_ms, size)}."""
    st = pipeline.init_state(cfg, B, device)
    st, _ = pipeline.step_b(st, *frames[0], cfg)
    recorded = record_inputs(
        mods, STEP_KERNELS, lambda: pipeline.step_b(st, *frames[1], cfg))
    del st
    results = {}
    check_recorded(mods, recorded, results, card)
    return results


def check_single_kernels(pipeline, mods, cfg_b, map_state, odom_state,
                         cfg_1, single, device, results, card):
    """Phase 7: the single-stream step's kernels at the inputs its frame 1
    gives them, and knn_select at one B = 16 corner_associations_b and
    surf_associations_b call on
    ``map_state`` (phase 6's last map) with the last frame's handoff
    clouds, downsampled to the stack caps."""
    import torch
    from aloam_tpu_torch import mapping as mp
    from aloam_tpu_torch.frontend.voxel import voxel_downsample_masked_b

    st = pipeline.init_state(cfg_1, 1, device)
    st, _ = pipeline.step(st, *single[0], cfg_1)
    recorded = record_inputs(
        mods, SINGLE_KERNELS, lambda: pipeline.step(st, *single[1], cfg_1))
    del st

    def assoc_b():
        for fn, cloud, grid, leaf, cap in (
                (mp.corner_associations_b, odom_state.corner_last,
                 map_state.corner, cfg_b.line_resolution,
                 cfg_b.corner_stack_cap),
                (mp.surf_associations_b, odom_state.surf_last,
                 map_state.surf, cfg_b.plane_resolution,
                 cfg_b.surf_stack_cap)):
            vals = torch.cat([cloud.xyz, cloud.intensity[..., None]], -1)
            ds, m, _ = voxel_downsample_masked_b(vals, cloud.mask, leaf, cap)
            f, _, _ = fn(ds[..., :3], m, grid, map_state.q_w, map_state.t_w,
                         cfg_b)
            if int(f.mask.sum()) == 0:
                fail(f"{fn.__name__}: no factors on the B={B} map")

    recorded.update(record_inputs(mods, ("knn_select",), assoc_b))
    check_recorded(mods, recorded, results, card)


def segmented_reference(rng, bsz: int, rings: int, seg: int, pad: int,
                        fill: float = 0.8):
    """A ring-segmented odometry reference in the frontend's ring_heads
    layout, planar and poisoned as window_mins takes it: (B, 4, M) f32
    [x | y | z | ring], M = rings·seg + pad; ring r's valid points first
    in rows [r·seg, (r+1)·seg), on a cone at height 0.4 r - 12.8 around
    the sensor; padding at 1e9."""
    m = rings * seg + pad
    ref = np.full((bsz, 4, m), 1e9, np.float32)
    for b in range(bsz):
        for r in range(rings):
            cnt = int(seg * fill) - int(rng.integers(0, 8))
            th = rng.uniform(-np.pi, np.pi, cnt)
            rad = rng.uniform(6, 40, cnt)
            rows = slice(r * seg, r * seg + cnt)
            ref[b, 0, rows] = rad * np.cos(th)
            ref[b, 1, rows] = rad * np.sin(th)
            ref[b, 2, rows] = 0.4 * r - 12.8 + rng.normal(0, 0.02, cnt)
            ref[b, 3, rows] = r
    return ref


def queries_near(rng, ref, q: int, rings=None):
    """(B, Q, 3) f32 queries 0.3 m off valid reference points (of the
    given rings only, if any)."""
    sel = np.zeros((ref.shape[0], q, 3), np.float32)
    for b in range(ref.shape[0]):
        ok = ref[b, 3] < 1e8
        if rings is not None:
            ok &= np.isin(ref[b, 3], rings)
        pick = rng.choice(np.flatnonzero(ok), q)
        sel[b] = ref[b, :3, pick] + rng.normal(0, 0.3, (q, 3))
    return sel


def check_adversarial(mods, device, results, card):
    """Phase 4, second part: window_mins bit-equal to its plain version,
    and to itself without ``ring_seg``, on B = 4 ring-segmented references
    of the bench's surf layout (64 rings x 576 rows): plain queries,
    queries on the first and last rings only, duplicate points (exact
    ties), an all-poisoned reference (frame 0). segmented_prefix_sums
    within its tolerance on long rows: no head at all, heads only at
    multiples of 1024, sparse heads, a row length not a multiple of 4;
    and on more rows than a grid's y or z extent (65535) allows.
    The scan's values are quarters and its last channel counts ones, so
    every partial sum is exact and kernel and plain agree exactly."""
    import torch
    rng = np.random.default_rng(2024)
    odom, vox = mods["window_mins"], mods["segmented_prefix_sums"]
    seg = 576
    ref = segmented_reference(rng, 4, 64, seg, 0)
    dup = ref.copy()
    for r in (0, 17, 40, 63):
        dup[:, :3, r * seg + 3] = dup[:, :3, r * seg + 1]
        if r < 63:
            dup[:, :3, (r + 1) * seg + 2] = dup[:, :3, r * seg + 1]
            dup[:, 2, (r + 1) * seg + 2] += 0.4
    sel_dup = queries_near(rng, dup, 1536)
    sel_dup[:, :8] = dup[:, :3, 17 * seg + 1][:, None, :]
    cases = {
        "segmented": (queries_near(rng, ref, 1536), ref),
        "first_and_last_rings": (queries_near(rng, ref, 768, [0, 63]), ref),
        "duplicates": (sel_dup, dup),
        "all_poisoned": (queries_near(rng, ref, 1536),
                         np.full_like(ref, 1e9)),
    }
    worst = 0.0
    for label, (sel_np, ref_np) in cases.items():
        sel = torch.from_numpy(sel_np).to(device)
        r = torch.from_numpy(ref_np).to(device)
        for want_same in (False, True):
            got = odom.window_mins(sel, r, 2.5, want_same, seg)
            worst = max(worst, compare(
                "window_mins", got,
                odom.window_mins_plain(sel, r, 2.5, want_same, seg)))
            compare("window_mins", got,
                    odom.window_mins(sel, r, 2.5, want_same, 0))
        if label == "all_poisoned" and not (
                (got[1] == 0).all() and (got[5] == 1).all()):
            fail("window_mins: an all-poisoned reference must give the "
                 "exhaustive scan's indices 0 and 1")
        if label == "duplicates" and not (got[1][:, :8] == 17 * seg + 1).all():
            fail("window_mins: a tie must go to the lowest index")
        say(f"[adversarial] window_mins {label}: sel {tuple(sel.shape)} ref "
            f"{tuple(r.shape)} ring_seg {seg}: bit-equal to plain and to "
            f"ring_seg 0 ({card})")

    def scan_case(label, k, rows, n, heads):
        chan = rng.integers(-8, 9, size=(k, rows, n)) / 4
        chan[-1] = 1.0
        v = torch.from_numpy(chan.astype(np.float32)).to(device)
        h = torch.from_numpy(heads).to(device)
        err = compare("segmented_prefix_sums",
                      vox.segmented_prefix_sums(v, h),
                      vox.segmented_prefix_sums_plain(v, h))
        say(f"[adversarial] segmented_prefix_sums {label}: vals "
            f"{tuple(v.shape)} {int(heads.sum())} heads: max_abs_err "
            f"{err:.3g} ({card})")
        return err

    n = 40960
    none = np.zeros((1, n), bool)
    tiles = np.zeros((2, 16384), bool)
    tiles[:, ::1024] = True
    sparse = rng.uniform(size=(3, 2048 * 33 + 4)) < 2e-4
    odd = rng.uniform(size=(5, 8191)) < 0.05
    odd[:, 0] = True
    many = rng.uniform(size=(70000, 64)) < 0.1
    worst_scan = 0.0
    for args in (("no head", 1, 1, n, none), ("no head", 8, 1, n, none),
                 ("heads every 1024", 8, 2, 16384, tiles),
                 ("sparse heads", 5, 3, sparse.shape[1], sparse),
                 ("n = 8191", 5, 5, 8191, odd),
                 ("70000 rows", 2, 70000, 64, many)):
        worst_scan = max(worst_scan, scan_case(*args))
    for name, err in (("window_mins", worst),
                      ("segmented_prefix_sums", worst_scan)):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)


@contextlib.contextmanager
def ring_seg_spy(mods, tag):
    """Record the ``ring_seg`` of every window_mins call in the with-block;
    fail after it unless there was one and every one was > 0."""
    mod, segs = mods["window_mins"], []
    real = mod.window_mins

    def spy(sel, ref, nearby, want_same, ring_seg=0):
        segs.append(ring_seg)
        return real(sel, ref, nearby, want_same, ring_seg)

    with Patched([(mod, "window_mins", spy)]):
        yield
    say(f"[{tag}] window_mins calls: {len(segs)}, ring_seg "
        f"{sorted(set(segs))}")
    if not segs or min(segs) <= 0:
        fail(f"{tag}: the odometry search ran with ring_seg 0")


def run_front(pipeline, mods, cfg, frames, device, card):
    """Phase 5: front_step_b with the kernels and with the plain
    versions."""
    for name in FRONT_KERNELS:
        mods[name].launches = 0
    with ring_seg_spy(mods, "front"):
        k_outs, k_ms, _ = run_frames(pipeline.front_step_b, pipeline, cfg,
                                     frames, device)
    launches = {name: mods[name].launches for name in FRONT_KERNELS}
    say(f"[front] kernel launches over {len(frames)} frames: {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the front path was never launched: {launches}")
    with Patched([(mods[n], KERNELS[n][1], getattr(mods[n], KERNELS[n][2]))
                  for n in FRONT_KERNELS]):
        p_outs, p_ms, _ = run_frames(pipeline.front_step_b, pipeline, cfg,
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


def stage_times(step, stages, pipeline, cfg, frames, device, batch):
    """A kernel run of ``step`` with CUDA events around each stage and
    mapping sub-stage (the device time between the stage's first and last
    operation). Returns {label: per-frame ms list}."""
    import torch
    events = {label: [] for label in stages}

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
    for label, (mod_name, attr) in stages.items():
        mod = importlib.import_module(mod_name)
        swaps.append((mod, attr, timed(label, getattr(mod, attr))))
    per_frame = {label: [] for label in stages}
    with Patched(swaps):
        st = pipeline.init_state(cfg, batch, device)
        for xyz, mask in frames:
            for label in stages:
                events[label].append([])
            st, _ = step(st, xyz, mask, cfg)
            torch.cuda.synchronize()
            for label in stages:
                per_frame[label].append(sum(s.elapsed_time(e)
                                            for s, e in events[label][-1]))
    return per_frame


def stage_busy(step, stages, pipeline, cfg, frames, device, batch):
    """A kernel run of ``step`` with frames 1.. under torch.profiler, each
    stage and mapping sub-stage in a record_function range: the device
    time of the kernels each stage launched (the device's idle gaps left
    out, unlike the CUDA-event spans of stage_times), the device's busy
    time per frame and the frame's wall time under the profiler. Returns
    ({label: ms per frame}, busy ms per frame, wall ms per frame,
    kernels per frame, {device operation: ms per frame})."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def labelled(label, fn):
        def call(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return call

    swaps = []
    for label, (mod_name, attr) in stages.items():
        mod = importlib.import_module(mod_name)
        swaps.append((mod, attr, labelled(label, getattr(mod, attr))))
    n = len(frames) - 1
    with Patched(swaps):
        st = pipeline.init_state(cfg, batch, device)
        st, _ = step(st, *frames[0], cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for xyz, mask in frames[1:]:
                st, _ = step(st, xyz, mask, cfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
    # each stage range has a device-side mirror: the span from its first
    # device operation to its last. One stream runs the operations in
    # order, so a stage's device time is that of the operations starting
    # inside its spans (the host ranges miss the kernels launched through
    # ctypes, which no aten op encloses)
    cuda = torch.autograd.DeviceType.CUDA
    spans = {label: [] for label in stages}
    ops = []                                   # (start, duration, name)
    for ev in prof.events():
        if ev.device_type != cuda:
            continue
        if ev.name in stages:
            spans[ev.name].append((ev.time_range.start, ev.time_range.end))
        else:
            ops.append((ev.time_range.start, ev.time_range.elapsed_us(),
                        ev.name))
    ops.sort()
    starts = [o[0] for o in ops]
    before = np.concatenate([[0.0], np.cumsum([o[1] for o in ops])])
    per_stage = {label: sum(before[bisect.bisect_left(starts, e)]
                            - before[bisect.bisect_left(starts, s)]
                            for s, e in spans[label]) / 1e3 / n
                 for label in stages}
    per_op = {}
    for _, dur, name in ops:
        per_op[name] = per_op.get(name, 0.0) + dur / 1e3 / n
    return per_stage, before[-1] / 1e3 / n, wall, len(ops) / n, per_op


def say_busy(tag, stages, pipeline, cfg, frames, device, batch, card):
    per_stage, busy, wall, kernels, per_op = stage_busy(
        pipeline.step_b if batch > 1 else pipeline.step, stages, pipeline,
        cfg, frames, device, batch)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    say(f"[{tag}] device busy ms per frame by stage, torch.profiler, mean "
        f"of frames 1-{len(frames) - 1}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_stage.items())
        + f"; the device busy {busy:.3f} of {wall:.2f} ms per frame "
        f"(idle {100 * (1 - busy / wall):.1f}%), {kernels:.0f} device "
        f"operations per frame ({card})")
    say(f"[{tag}] device ms per frame by operation, the ten largest: "
        + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))


def say_stages(tag, per_frame, card):
    med = {label: float(np.median(v[1:])) for label, v in per_frame.items()}
    say(f"[{tag}] device ms per frame by stage, CUDA events, median of "
        f"frames 1-{len(next(iter(per_frame.values()))) - 1}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items()) + f" ({card})")


def pose_agreement(tag, k_outs, p_outs, k_ms, p_ms, batch):
    """Map poses of a kernel run and a plain run, frame by frame: within
    1e-3 (q) / 5e-3 m (t) unless a gate flipped in that stream (from then
    on), and within 2.5e-2 always."""
    from aloam_tpu_torch.pipeline import METRIC_NAMES
    col = {n: i for i, n in enumerate(METRIC_NAMES)}
    gates = ("corner_corr", "plane_corr", "map_corner_factors",
             "map_surf_factors", "map_solved")
    flipped = np.zeros(batch, bool)
    for f, (ko, po) in enumerate(zip(k_outs, p_outs)):
        for name in ("q_odom", "t_odom", "q_map", "t_map"):
            v = np.reshape(ko[name], (batch, -1))
            if not np.isfinite(v).all():
                fail(f"{tag} frame {f}: non-finite or misshapen {name}")
        # a gate that flipped on a rounding difference (the f64 plain
        # segmented sums, summation order) changes a count; from then on
        # that stream may drift apart
        km = np.reshape(ko["metrics"], (batch, -1))
        pm = np.reshape(po["metrics"], (batch, -1))
        for g in gates:
            flipped |= km[:, col[g]] != pm[:, col[g]]
        dq = np.abs(np.reshape(ko["q_map"] - po["q_map"], (batch, -1))).max(1)
        dt = np.abs(np.reshape(ko["t_map"] - po["t_map"], (batch, -1))).max(1)
        say(f"[{tag}] frame {f}: kernel {k_ms[f]:.1f} ms plain {p_ms[f]:.1f} "
            f"ms; map max |dq| {dq.max():.3g} max |dt| {dt.max():.3g} m; "
            f"gate flips in streams {np.flatnonzero(flipped).tolist()}")
        # with a flip, the bound JAX holds its own batched and single
        # mapping paths to (tests/test_batched_kernels.py)
        bad = (((dq > 1e-3) | (dt > 5e-3)) & ~flipped) \
            | (dq > 2.5e-2) | (dt > 2.5e-2)
        if bad.any():
            fail(f"{tag} frame {f}: map poses differ in streams "
                 f"{np.flatnonzero(bad).tolist()}")


def ate_check(tag, k_outs, gt, batch):
    """Odometry and mapped ATE of a kernel run against the ground truth
    (B, F, 3); fails at 0.5 m."""
    from aloam_tpu_torch.eval.ate import ate_rmse
    for name, key in (("odometry", "t_odom"), ("mapped", "t_map")):
        est = np.stack([np.reshape(o[key], (batch, 3)) for o in k_outs],
                       axis=1)                                    # (B, F, 3)
        ate = np.array([ate_rmse(est[b], gt[b], align=False)
                        for b in range(batch)])
        say(f"[{tag}] {name} ATE vs ground truth over {len(k_outs)} frames: "
            f"max {ate.max():.4f} m, median {np.median(ate):.4f} m, per "
            f"stream {np.round(ate, 4).tolist()}")
        if not (np.isfinite(ate).all() and ate.max() < 0.5):
            fail(f"{tag}: {name} pose does not track the ground truth")


def kernel_and_plain(tag, step, pipeline, mods, names, cfg, frames, device,
                     batch):
    """``step`` over the frames with the kernels (every kernel in
    ``names`` must launch) and with every kernel's plain version (none may
    launch). Returns (kernel outputs, kernel ms, plain outputs, plain ms,
    launches, final kernel-run state, the kernel run's peak device memory
    in bytes)."""
    import torch
    for mod in mods.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    with ring_seg_spy(mods, tag):
        k_outs, k_ms, st = run_frames(step, pipeline, cfg, frames, device,
                                      batch)
    peak = torch.cuda.max_memory_allocated(device)
    launches = {name: mods[name].launches for name in KERNELS}
    say(f"[{tag}] kernel launches over {len(frames)} frames: {launches}")
    if min(launches[n] for n in names) < 1:
        fail(f"a kernel of the {tag} path was never launched: {launches}")
    with Patched([(mods[n], spec[1], getattr(mods[n], spec[2]))
                  for n, spec in KERNELS.items()]):
        p_outs, p_ms, _ = run_frames(step, pipeline, cfg, frames, device,
                                     batch)
    if any(mods[n].launches != launches[n] for n in KERNELS):
        fail(f"the plain {tag} run launched a kernel")
    return k_outs, k_ms, p_outs, p_ms, launches, st, peak


def run_step(pipeline, mods, cfg, frames, gt, device, card):
    """Phase 6: step_b with the kernels, with the plain versions, and a
    staged kernel run. Returns (launches, the kernel run's final state)."""
    from aloam_tpu_torch.pipeline import METRIC_NAMES

    k_outs, k_ms, p_outs, p_ms, launches, st, peak = kernel_and_plain(
        "step", pipeline.step_b, pipeline, mods, STEP_KERNELS, cfg, frames,
        device, B)
    pose_agreement("step", k_outs, p_outs, k_ms, p_ms, B)
    sk, sp = float(np.mean(k_ms[1:])), float(np.mean(p_ms[1:]))
    say(f"[step] frames 1-{len(frames) - 1}: kernels {sk:.2f} ms/frame = "
        f"{B * 1e3 / sk:.1f} scans/s; plain {sp:.2f} ms/frame = "
        f"{B * 1e3 / sp:.1f} scans/s; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB (B={B}, {card})")

    say_stages("step", stage_times(pipeline.step_b, STAGES, pipeline, cfg,
                                   frames, device, B), card)
    say_busy("step", STAGES, pipeline, cfg, frames, device, B, card)

    col = {n: i for i, n in enumerate(METRIC_NAMES)}
    last = k_outs[-1]["metrics"]
    say("[step] last-frame metrics (stream 0): "
        + json.dumps({n: float(last[0, i]) for n, i in col.items()}))
    if not last[:, col["map_solved"]].all():
        fail("mapping did not solve in every stream")
    ate_check("step", k_outs, gt, B)
    return launches, st


def run_single(pipeline, mods, cfg, frames, gt, device, card):
    """Phase 8: the single-stream step with the kernels and with the plain
    versions. Returns the launches of the kernel run."""
    from aloam_tpu_torch.pipeline import METRIC_NAMES
    k_outs, k_ms, p_outs, p_ms, launches, _, peak = kernel_and_plain(
        "single", pipeline.step, pipeline, mods, SINGLE_KERNELS, cfg, frames,
        device, 1)
    pose_agreement("single", k_outs, p_outs, k_ms, p_ms, 1)
    sk, sp = float(np.mean(k_ms[1:])), float(np.mean(p_ms[1:]))
    say(f"[single] frames 1-{len(frames) - 1}: kernels {sk:.2f} ms/scan = "
        f"{1e3 / sk:.1f} scans/s; plain {sp:.2f} ms/scan = "
        f"{1e3 / sp:.1f} scans/s; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB (one HDL-64 stream, PRESETS['HDL-64'], "
        f"{card})")
    say_stages("single", stage_times(pipeline.step, SINGLE_STAGES, pipeline,
                                     cfg, frames, device, 1), card)
    say_busy("single", SINGLE_STAGES, pipeline, cfg, frames, device, 1, card)
    last = dict(zip(METRIC_NAMES, k_outs[-1]["metrics"].tolist()))
    say("[single] last-frame metrics: " + json.dumps(last))
    if last["map_solved"] != 1:
        fail("single-stream mapping did not solve")
    ate_check("single", k_outs, gt[None], 1)
    return launches


def run_cli(device, card):
    """Phase 9: the CLI end to end on the card, and a resumed run."""
    from aloam_tpu_torch import cli
    with tempfile.TemporaryDirectory() as tmp:
        out, res = os.path.join(tmp, "run"), os.path.join(tmp, "resumed")
        base = ["--device", str(device), "--preset", "HDL-64", "--synthetic"]
        t0 = time.perf_counter()
        cli.main(base + ["--frames", "4", "--checkpoint-every", "2",
                         "--out", out])
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "eval.json")) as fh:
            ev = json.load(fh)
        with open(os.path.join(out, "metrics.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        if [r["frame"] for r in recs] != [0, 1, 2, 3] \
                or recs[-1]["map_solved"] != 1:
            fail(f"cli: metrics.jsonl {recs}")
        if not (ev["frames"] == 4 and 0 <= ev["ate_rmse_m"] < 0.5):
            fail(f"cli: eval.json {ev}")
        cli.main(base + ["--frames", "4", "--skip-first", "2", "--resume",
                         os.path.join(out, "state_000002.npz"), "--out",
                         res])
        with np.load(os.path.join(out, "trajectory.npz")) as a, \
                np.load(os.path.join(res, "trajectory.npz")) as b:
            d = max(np.abs(b["t_map"][1] - a["t_map"][3]).max(),
                    np.abs(b["q_map"][1] - a["q_map"][3]).max())
        say(f"[cli] 4 frames in {wall:.1f} s, ATE {ev['ate_rmse_m']:.4f} m, "
            f"median {ev['median_wall_ms']:.1f} ms/scan; resumed from "
            f"state_000002.npz: frame 3 pose max |diff| {d:.3g} ({card})")
        if d > 1e-6:
            fail("cli: the resumed run does not reach the same frame 3 pose")


def main() -> None:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    from aloam_tpu_torch.config import PRESETS
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
    check_adversarial(mods, device, results, card)
    run_front(pipeline, mods, cfg, frames[:N_FRONT], device, card)
    launches, st_b = run_step(pipeline, mods, cfg, frames, gt, device, card)

    # ---- 7-9. knn_select, the single-stream step, the CLI ----------------
    cfg_1 = PRESETS["HDL-64"]
    t0 = time.perf_counter()
    sx, sm, sgt = make_single(cfg_1)
    single = [(torch.from_numpy(sx[f]).to(device),
               torch.from_numpy(sm[f]).to(device)) for f in range(N_FRAMES)]
    say(f"[data] single stream: seed {SINGLE_SEED}, {SINGLE_SPEED:g} m/s, "
        f"{N_FRAMES} frames, {int(sm.sum(axis=1).mean())} points/scan, "
        f"PRESETS['HDL-64'] (n_raw {cfg_1.n_raw}, ring_cap "
        f"{cfg_1.ring_cap}, less_flat_cap {cfg_1.less_flat_cap}) "
        f"({time.perf_counter() - t0:.1f} s)")
    check_single_kernels(pipeline, mods, cfg, st_b.map, st_b.odom, cfg_1,
                         single, device, results, card)
    del st_b
    single_launches = run_single(pipeline, mods, cfg_1, single, sgt, device,
                                 card)
    launches["knn_select"] = single_launches["knn_select"]
    run_cli(device, card)

    kernels = [dict(name=name, route="cuda", source=spec[3],
                    replaces=spec[4], launches=launches[name],
                    max_abs_err=results[name]["max_abs_err"],
                    ms=results[name]["ms"],
                    device_ms=results[name]["device_ms"],
                    plain_ms=results[name]["plain_ms"],
                    bound_ms=results[name]["bound_ms"],
                    bound_by=results[name]["bound_by"],
                    # no one PyTorch call computes any of these functions
                    library_ms=None)
               for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
