"""Drive the PyTorch/CUDA port's SLAM steps once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA:

    python3 chip_smoke.py
    python3 chip_smoke.py --tables 4   # phase 11 (c) alone: NCCL, 4 cards

It imports torch, numpy and the port (``aloam_tpu_torch``), and nothing
of JAX or of the JAX package. Phases, each printing its own lines:

1. device: the card's name and power limit (from nvidia-smi), torch and
   CUDA versions; TF32 off;
2. build: the CUDA kernels from ``aloam_tpu_torch/csrc/`` (one nvcc per
   source, sm_90a);
3. data: B = 16 synthetic HDL-64 streams of 8 frames (the bench's seeds
   and speeds), padded to the bench config (``bench.batched_bench_cfg``:
   ring_cap 1856, n_raw 115200, less_flat_cap 36864, assoc_cspan 128,
   map_query_chunk 2048), and the single-stream bench scene (seed 42,
   10 m/s, padded to ``PRESETS["HDL-64"]``), cached under
   ``.bench_cache/``;
4. kernels: each of step_b's eight kernels (the six that replace a
   ``pallas_call``, the row gather, ``bgather``, and the map window's
   evict and census, ``evict_and_count``) against its plain
   PyTorch version on the card, on every distinct input shape the main path gave
   it in frame 1 of ``step_b``, with the stated tolerance, both timed
   with CUDA events (the kernel back to back, its wrapper's host cost
   included, and queued behind a sleep for its device time alone),
   beside the kernel's bound (the least time the card could take for the
   same work, from the bytes and the operations these inputs need; the
   row gather also beside the library's ``flat[gidx]``, ``library_ms``);
   then
   ``window_mins`` and ``segmented_prefix_sums`` on adversarial inputs
   (an all-poisoned reference, duplicate points, queries on the first
   and last rings, with and without ``ring_seg``;
   rows without heads across many tiles, heads only at tile boundaries,
   a row length that is not a multiple of 4, 70000 short rows);
   ``assoc_cell`` bit-equal to its plain version on adversarial tiles
   (one row for all 256 queries, a row per query, all poisoned, the
   cell-window edge, degenerate fits, n not a multiple of 32) and
   ``lm_fused`` within its tolerance, counts exact and bit-equal from
   launch to launch (B = 1, 16, 32; no edges; no planes; an all-masked
   stream; a NaN factor; counts not divisible by the cluster size);
   ``select_rings`` labels exact on rows that press on one rule each
   (ties, all above or below the threshold, ±inf and NaN, a window over
   the whole row, disabled windows, bcum stepping everywhere or nowhere,
   marks across region edges; C = 1000; R' = 1 and 4096); the in-place
   map merge (``merge_tiles``, ``insert.merge_rows``) with both tables
   bit-equal to its plain version's as a whole (no row used, every point
   merging, evictions in both priority classes, priority ties, cnt past
   the cap; (Bk, P) (32, 16), (48, 16), (48, 48), (128, 128)); the
   stamp of the port's spans (``aloam_stamp``) alone, eager and in a CUDA
   graph: stamps rise with their slot and, on the host clock, lie between
   host readings around the launches (``check_stamp``); the row gather
   (``ops/gather.bgather``, ``csrc/gather.cu``) bit-equal to
   ``flat[gidx]`` at the ``hdl64-fleet-b32`` frame's five gather shapes
   and on small cases, timed beside its byte bound and the library's
   indexing, and an index past either end of a stream's rows ending a
   child process with a CUDA error (``check_gather``); the map window's
   evict and census (``ops/evict.evict_and_count``, ``csrc/evict.cu``)
   bit-equal to its plain version, tables and counts, with ``evict`` on
   and off, on tables planted with cells out of the window at the
   ``hdl64-fleet-b32`` frame's shapes, at B = 1 and on small tables that
   take the 8- and 4-byte vectors, and timed beside its byte bound at
   four fillings of the fleet's tables (``check_evict``). A kernel
   that updates the tables in place gets a fresh clone of them for every
   call, timed calls included;
5. front: ``pipeline.front_step_b`` over the first 5 frames with the
   kernels (its five launch counters must rise, and every odometry search
   must declare ``ring_seg`` > 0) and with the plain versions; per-frame
   odometry poses must agree;
6. step: ``pipeline.step_b`` over the 8 frames with the kernels (its eight
   launch counters must rise, ``ring_seg`` > 0 as in phase 5) and with
   the plain versions; map poses must agree (tightly unless a gate
   flipped); a third kernel run reads each stage's device span from the
   port's spans (``spans.stage``: ``%globaltimer`` stamps), a fourth under
   torch.profiler gives each span's device busy time (the operations
   inside the record_function range each stage opens under a profiler)
   and the device's idle share; in the kernel run ``gather.launches``
   must equal the ``bgather`` calls that moved rows (phases 5, 8 and 10
   the same); scans/s, peak device
   memory and the odometry and mapped ATE against the ground truth (must
   be < 0.5 m);
7. single-stream kernels: each of the single-stream step's eight kernels
   against its plain version, timed and bounded as in phase 4, at the
   inputs frame 1 of the single-stream step gave them (``knn_select``:
   the table entry, ``ops/knn.knn_grid``, which ``gridmap.knn`` calls),
   and the cache entry (``knn_select_rows``, ``ops/knn.knn_select``) at
   one B = 16 ``corner_associations_b`` / ``surf_associations_b`` call on
   the map phase 6 left, whose launches it counts; then both entries
   bit-equal to their plain versions on adversarial tables
   (``_torch_scenes.knn_case``: H = 8, an empty table, fewer than 5 real
   candidates, equal distances, negative coordinates, queries on cell
   boundaries, ±1e5 m, Q = 1 and 1001; Bk 32 and 48);
8. single: ``pipeline.step`` over the single-stream scene's 8 frames at
   ``PRESETS["HDL-64"]`` with the kernels (its eight launch counters, the
   table entry's among them, must rise; ``ring_seg`` > 0) and with the
   plain versions;
   map poses as in phase 6; ms/scan, peak device memory, a staged kernel
   run as in phase 6, and the odometry and mapped ATE (< 0.5 m);
9. cli: ``aloam_tpu_torch.cli.main`` over 4 synthetic HDL-64 frames with a
   checkpoint every 2, its eval.json and metrics.jsonl read back, and a
   run resumed from the frame-2 checkpoint must give frame 3's pose; both
   runs step through the graphed ``make_step_fn`` (one capture a run, a
   replay a frame);
10. distortion: the motion-distortion path (``cfg.distortion``) on
   motion-distorted scenes (``make_distorted_sequence``, 8 frames,
   accelerating at 12 m/s² and turning at 0.3 rad/s): B = 16 streams
   (seed 200 + b, 6 + 0.25 b m/s) at the bench config and one stream
   (tests/test_pipeline.py's scene, seed 11 at 6 m/s, at full width) at
   ``PRESETS["HDL-64"]``, cached under ``.bench_cache/``. ``lm_fused``
   with the s channel ("lm_fused_s") against its plain version at the
   inputs frame 1 of the distorted ``step_b`` and of the distorted
   ``step`` give it (two launches bit-equal; timed beside the s-free
   launch on the same factors; its adversarial cases run in phase 4);
   the distorted ``step_b`` and ``step`` with the kernels and with the
   plain versions (poses as in phase 6, ms/frame, the device spans, the
   slerp transforms inside odom.assoc / odom.handoff, busy ms and the
   idle share); and on the
   same scenes with the kernels,
   the frame-to-frame translation error from frame 2 on must fall below
   0.75 of the rigid model's in the mean over streams and below it on
   every stream, and every stream's aligned mapped ATE against the
   sweep-end ground truth must stay under its limit (0.12 m on the one
   stream, 0.15 m on each of the B: ``DIST_ATE_LIMIT_1`` / ``_B``); the
   gates of tests/test_pipeline.py's distortion tests;
11. parallel: ``aloam_tpu_torch.parallel`` over ``torch.distributed``.
   (a) One NCCL rank, a (1, 1) mesh, through the compiled entry points:
   ``batched_step_fn`` over phase 6's 16 streams and 8 frames, captured
   once (its body launching each of step_b's eight kernels as one eager
   frame does) and replayed 8 times, every output of every frame and the
   final tables bit-equal to phase 6's eager kernel run; ``step_b`` with
   the rank's ``TableShard`` of the NCCL group of one through a
   ``graph.StepGraph``, its ``all_reduce``s captured in the graph,
   bit-equal to phase 6 the same way; ``sharded_knn`` captured, equal to
   the dense ``neighbors.knn`` (d2 and indices) at Q = 4096, M = 36864
   on phase 6's map points. (b) Two ranks on the one card over gloo
   (NCCL refuses two ranks on one GPU; gloo takes the CUDA tensors): two
   worker processes (this script with ``--parallel-worker``, each with a
   time limit) step 8 streams each over a (2, 1) mesh with the kernels
   through the eager sharded step (``batched_step_fn(...).step``), their
   poses held against phase 6's at ``pose_agreement``'s tolerance (8
   streams get another ``lm_fused`` cluster plan than 16), each rank's
   scans/s and device busy time under torch.profiler beside the one
   process's; then ``sharded_knn`` over a (1, 2) mesh equal to the dense
   knn, with the gloo exchange timed. (c) The map tables split over
   "model": two worker processes (``--table-worker``, gloo, the one card)
   as a (1, 2) mesh, each holding half of every table of phase 6's 16
   streams (the partition assert of ``parallel.dryrun.check_partition``
   before and after), step the 8 frames with the kernels (launch counters
   from 0, each of step_b's eight must rise); both ranks' poses and
   metrics equal each other and phase 6's bit for bit, and rank 0 steps
   the same frames with the whole tables (``pipeline.step_b``): the
   tables gathered by ``gather_tables`` equal them bit for bit. Rank 0's
   ``merge_rows``, ``assoc_cell`` and ``evict_and_count`` inputs at frame 1
   agree with their plain versions, two launches bit-equal. Scans/s, each rank's table
   MiB and the exchange ms a frame (every collective of the step timed
   between two synchronizes, on a second pass through the eager step).
   Over gloo ``batched_step_fn`` runs eagerly (``parallel.graphed``).
   With ``--tables n`` the script runs this phase alone over NCCL on a
   (1, n) mesh, a card a rank, each rank held to step_b with whole
   tables on its own; there ``batched_step_fn`` is captured (one capture,
   8 replays a rank, its all_reduces inside), bit-equal on every rank to
   its eager body (outputs and the rank's tables), and eager and graphed
   frames are timed in turn three times;
12. graph: the compiled step (``aloam_tpu_torch/graph.py``, CUDA graphs).
   (a) One eager frame of step_b (B = 16) and one of step under
   ``torch.cuda.set_sync_debug_mode("error")``: no host synchronization.
   (b) ``parallel.batched_step_jit`` over phase 6's 16 streams and 8
   frames: the outputs of every frame, kept on the card until the end,
   and the final tables bit-equal to phase 6's eager kernel run; one
   capture, whose body launched each of step_b's eight kernels as often as
   one eager frame does, and 8 replays. (c) ``pipeline.make_step_fn`` over
   phase 8's frames, bit-equal to phase 8, then 4 frames at
   ``mapping_skip_frame`` 2 (two graphs, one a gate branch) bit-equal to
   the eager step. (d) ``pipeline.run_sequence(scan=True)`` over the same
   8 frames: one graph of all 8, one replay, bit-equal to (c); capture
   and instantiate ms, node count (cuGraphGetNodes), the graph pool's MiB
   and the peak memory. (e) The distorted step_b graphed over 4 of phase
   10's frames, bit-equal to phase 10's eager run, ``lm_fused_s`` inside
   the capture. Its run time is printed;
13. bench: first the bench's preset rung in this process, ``step_b`` at
   ``PRESETS["HDL-64"]``'s caps over phase 3's streams, its launches
   counted from 0 (all eight kernels must launch), its kernels held against
   their plain versions at its frame-1 inputs as in phase 4, and its ATE
   as in phase 6; then ``python -m aloam_tpu_torch.pregen_streams`` and
   ``python -m aloam_tpu_torch.bench`` as child processes, each with a
   time limit, at BENCH_BATCH=16 BENCH_BATCH_FRAMES=8 BENCH_FRAMES=8
   (the bench checks every kernel against its plain
   version on the card first, and step_b's again at each batched run's
   frame-1 inputs); each of its runs must launch every kernel
   of its path (the counts it prints); its last line must carry exactly
   bench.py's keys but ``step_gflops`` and ``mfu_pct`` (``BENCH_KEYS``),
   no ``batch_fallback``, ``value`` > 0, every ATE under 0.5 m and
   phase 1's device name; the line is printed;
14. drift: the long-horizon run (``aloam_tpu_torch.drift``): (a) the
   500-frame drift scene of tests/test_long_drift.py (VLP-16, 256 azimuth
   steps, 0.8 m a frame, ``drift.DRIFT_CFG``), rendered over a process
   pool or read from ``.bench_cache/``; (b) the kernels of ``step`` and
   of ``step_b`` at B = 1 against their plain versions at the inputs the
   scene's frame 1 gives them, as phase 4; (c) ``make_step_fn`` and
   ``batched_step_jit`` over frames 0-19 bit-equal to the eager ``step``
   and ``step_b``; (d) ``make_step_fn`` and (e) ``batched_step_jit`` at
   B = 1 over all 500 frames, each path's launch counters set to 0 just
   before and read just after (each of its eight must rise), held to
   tests/test_long_drift.py's gates (``drift.gates``: map_solved >= 495,
   drift < 3 %, ATE < 10 m, every pose finite, the first 200 frames'
   drift within 1.25 x the f64 oracle's, or 1.25 x JAX's own ratio where
   that is higher); it prints per path the drift, ATE, odometry drift and
   ratio to the oracle, JAX's figures from ``tests/_torch_drift_ref.npz``
   (made on the CPU by tests/_torch_drift_witness.py) and per 100 frames
   the tables' occupancy, the summed map_overflow and map_evicted, the
   largest gap to JAX's mapped position and the graphed ms a scan, the
   peak device memory and the phase's run time.

The second-to-last line is a JSON object with one entry per kernel (its
launches on the main path, worst error, kernel ms back to back, device
ms, plain and bound ms at its largest input; ``knn_select_rows``'s
launches are the association call's of phase 7, ``lm_fused_s``'s the
distorted ``step_b``'s of phase 10; ``launches_by_path`` those of phase
13's preset rung and of the bench's runs, and of phase 14's two paths;
the row gather, ``bgather``, replaces no ``pallas_call`` and is the one
with a ``library_ms``, the library's indexing at the same input);
the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; so does a machine without a CUDA card.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the seeded adversarial scenes, shared with the CPU tests (numpy only)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from _torch_scenes import (KNN_CASES, MERGE_CASES,  # noqa: E402
                           SELECT_CASES, evict_table, knn_case, merge_case,
                           queries_near, segmented_reference, select_case)

# the kernel table: each kernel's wrapper, plain twin, counter, in-place
# arguments, tolerance and source, and the kernels each path launches
from aloam_tpu_torch.ops import kernels  # noqa: E402

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
# the distorted scenes: B = 16 streams of seed 200 + b at 6 + 0.25 b m/s,
# and tests/test_pipeline.py's scene (seed 11, 6 m/s) as the one stream,
# all accelerating at 12 m/s² and turning at 0.3 rad/s
DIST_SEED, DIST_SINGLE_SEED = 200, 11
DIST_SPEED, DIST_ACCEL, DIST_YAW_RATE = 6.0, 12.0, 0.3
# the aligned mapped ATE limits of the distortion phase, each stream held
# to its own. The one stream is tests/test_pipeline.py's scene, held to that
# test's 0.12 m. Each of the B streams is held to 0.15 m: on these 16
# scenes the JAX package itself scores up to 0.1342 m (seed 206, at its
# test's size over these 8 frames; tests/_torch_distortion_witness.py),
# and 0.15 m is that with the headroom its test leaves on its own scene
# (0.12 m over the 0.1116 m it scores there over its 7 frames), rounded up
# to the centimetre
DIST_ATE_LIMIT_1, DIST_ATE_LIMIT_B = 0.12, 0.15
# phase 11: sharded_knn's shapes (the surf stack's width of refs) and
# the time limit of its two worker processes
KNN_Q, KNN_M = 4096, 36864
WORKER_TIMEOUT_S = 420
DIST_CACHE = os.path.join(
    CACHE_DIR, f"chip_smoke_dist_hdl64_a{N_AZIMUTH}_b{B}_f{N_FRAMES}.npz")
DIST_SINGLE_CACHE = os.path.join(
    CACHE_DIR, f"chip_smoke_dist_single_hdl64_a{N_AZIMUTH}_f{N_FRAMES}_"
    f"s{DIST_SINGLE_SEED}.npz")
# phase 13: the bench's settings, the keys of its line (bench.py's, as in
# BENCH_r05.json, but step_gflops and mfu_pct)
# and the time limits of its two child processes
BENCH_ENV = {"BENCH_BATCH": "16", "BENCH_BATCH_FRAMES": "8",
             "BENCH_FRAMES": "8"}
BENCH_KEYS = {"metric", "unit", "device_kind", "ms_per_scan_single",
              "ate_rmse_m", "frames", "value", "batch", "blocks",
              "spread_sps", "ate_batched_max_m", "ate_batched_med_m",
              "batch_frames", "batch_ladder", "bench_caps", "value_preset",
              "ate_preset_max_m", "preset_caps", "vs_baseline", "vs_target"}
PREGEN_TIMEOUT_S, BENCH_TIMEOUT_S = 240, 420
# phase 14: the frames over which graphed and eager must be bit-equal
DRIFT_EQUAL_FRAMES = 20
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM3
# bytes/s and fp32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def bench_cfg():
    """The bench's batched config,
    ``aloam_tpu_torch.bench.batched_bench_cfg()`` (ring_cap 1856, n_raw
    115200, less_flat_cap 36864, assoc_cspan 128, map_query_chunk 2048 at
    BENCH_AZIMUTH 1800)."""
    from aloam_tpu_torch.bench import batched_bench_cfg
    return batched_bench_cfg()


def cached(path, build):
    """The arrays ``build()`` returns (a dict of name -> array), from the
    npz at ``path`` when it exists, else built and saved there."""
    if os.path.exists(path):
        with np.load(path) as z:
            return dict(z)
    arrays = build()
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return arrays


def stack_streams(cfg, runs):
    """(F, B, n_raw, 3) xyz and (F, B, n_raw) mask of B (scans, traj)
    sequences padded to cfg.n_raw."""
    from aloam_tpu_torch.io import synthetic as syn
    n_frames = len(runs[0][0])
    xyz = np.zeros((n_frames, len(runs), cfg.n_raw, 3), np.float32)
    mask = np.zeros((n_frames, len(runs), cfg.n_raw), bool)
    for b, (scans, _) in enumerate(runs):
        for f, s in enumerate(scans):
            if s.shape[0] > cfg.n_raw:
                fail(f"stream {b} frame {f}: {s.shape[0]} points > n_raw")
            xyz[f, b], mask[f, b] = syn.pad_scan(s, cfg.n_raw)
    return xyz, mask


def make_streams(cfg):
    """(F, B, n_raw, 3) xyz, (F, B, n_raw) mask, (B, F, 3) ground truth:
    the bench's streams (seed 100 + b, speed 5 + 0.25 b m/s)."""
    from aloam_tpu_torch.io import synthetic as syn

    def build():
        runs = [syn.make_sequence(N_FRAMES, scan_lines=64,
                                  n_azimuth=N_AZIMUTH, seed=100 + b,
                                  speed=5.0 + 0.25 * b) for b in range(B)]
        xyz, mask = stack_streams(cfg, runs)
        gt = np.stack([traj.trans - traj.trans[0] for _, traj in runs])
        return dict(xyz=xyz, mask=mask, gt=gt.astype(np.float32))
    z = cached(CACHE, build)
    return z["xyz"], z["mask"], z["gt"]


def make_single(cfg):
    """(F, n_raw, 3) xyz, (F, n_raw) mask, (F, 3) ground truth of
    bench.bench_single's scene, padded to cfg.n_raw."""
    from aloam_tpu_torch.io import synthetic as syn

    def build():
        run = syn.make_sequence(N_FRAMES, scan_lines=64, n_azimuth=N_AZIMUTH,
                                seed=SINGLE_SEED, speed=SINGLE_SPEED)
        xyz, mask = stack_streams(cfg, [run])
        gt = run[1].trans - run[1].trans[0]
        return dict(xyz=xyz[:, 0], mask=mask[:, 0], gt=gt.astype(np.float32))
    z = cached(SINGLE_CACHE, build)
    return z["xyz"], z["mask"], z["gt"]


def make_distorted(cfg, path, seeds, speeds):
    """(F, S, n_raw, 3) xyz, (F, S, n_raw) mask and (S, F + 1, 3) ground
    truth of S motion-distorted streams: frame i sweeps from ground-truth
    pose i to i + 1, so the estimate of frame i compares with pose i + 1."""
    from aloam_tpu_torch.io import synthetic as syn

    def build():
        runs = [syn.make_distorted_sequence(
            N_FRAMES, scan_lines=64, n_azimuth=N_AZIMUTH, seed=seed,
            speed=speed, yaw_rate=DIST_YAW_RATE, accel=DIST_ACCEL)
            for seed, speed in zip(seeds, speeds)]
        xyz, mask = stack_streams(cfg, runs)
        gt = np.stack([traj.trans for _, traj in runs])
        return dict(xyz=xyz, mask=mask, gt=gt)
    z = cached(path, build)
    return z["xyz"], z["mask"], z["gt"]


def plain_run(names):
    """A with-block in which each named kernel's wrapper is its plain
    twin."""
    return Patched([(kernels.module(n), kernels.KERNELS[n].wrapper,
                     kernels.plain(n)) for n in names])


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
        outs.append(to_host(out))
    return outs, ms, st


def to_host(out) -> dict:
    """A step's output on the host, as a dict of numpy arrays."""
    import torch
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else
                {n: m.cpu().numpy() for n, m in v.items()})
            for k, v in out._asdict().items() if v is not None}


def compare(name, got, want, kind=None, inputs=None):
    """max_abs_err of a kernel against its plain version, failing past the
    kernel's tolerance (``aloam_tpu_torch/ops/kernels.py`` states each
    one; the seg scan's reads its ``inputs``)."""
    ok, err = kernels.agree(name, got, want, kind, inputs)
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
    each query's pass 2 scans; knn_select, knn_select_rows and assoc_cell:
    every candidate of each live query's block) and one add per element
    and channel of the segmented scan. select_rings, lm_fused and
    merge_tiles count bytes only: their arithmetic per byte is far below
    the card's balance. The in-place merge counts the bucket rows it reads
    and writes (the used rows, not the whole table), their bucket ids and
    points, the counts in and the stats out. The knn entries count the
    rows their queries name, each once, not the whole table or cache: the
    table entry the distinct bucket rows of the queries' blocks (a
    duplicate bucket is read once), the cache entry the distinct rows of
    its live queries (a gated query reads its row's first candidate). The
    row gather counts its distinct source rows (``gather_bytes``)."""
    import torch
    nbytes = _nbytes(list(args)) + _nbytes(list(kw.values())) + _nbytes(out)
    flops = 0
    if name == "bgather":
        nbytes = gather_bytes(args[0], args[1], out)
    elif name == "evict_and_count":
        nbytes = evict_bytes(args[1], int(out[2].sum())) \
            + _nbytes(list(args[2:5])) + _nbytes(list(out[2:]))
    elif name == "knn_select":
        from aloam_tpu_torch.ops.gridmap import block_buckets
        pts, q, cell, radius = args[0], args[1], args[3], args[4]
        hh, dup = block_buckets(q, pts.shape[0], cell, radius)
        rows = hh[~dup].unique().numel()
        nbytes = rows * pts.shape[1] * 4 + _nbytes([q]) + _nbytes(out)
        flops = 8 * q.shape[0] * 8 * (pts.shape[1] // 3)
    elif name == "knn_select_rows":
        cand, row, q4 = args[0], args[1], args[2]
        live = q4[:, 3] <= 0
        rows = row[live].unique()
        gated = row[~live].unique()
        n_gated = int((~torch.isin(gated, rows)).sum())
        nbytes = (rows.numel() * cand.shape[1] * 4 + n_gated * 12
                  + _nbytes([row, q4]) + _nbytes(out))
        flops = 8 * int(live.sum()) * (cand.shape[1] // 3)
    elif name == "merge_tiles":
        aux, slot_h, cnt, pvox = args[1], args[2], args[3], args[8]
        used = cnt > 0
        row = 8 * (aux.shape[-1] // 5) * 4                # 3 + 5 planes
        n_pts = int(cnt.clamp(0, pvox.shape[-1]).sum())
        nbytes = (int(used.sum()) * (2 * row + slot_h.element_size())
                  + n_pts * 5 * 4 + 4 * cnt.numel() * cnt.element_size()
                  + _nbytes(list(args[9:11])))
    elif name == "window_mins":
        sel, ref, nearby = args[0], args[1], args[2]
        ring_seg = args[4] if len(args) > 4 else kw.get("ring_seg", 0)
        pairs = sel.shape[0] * sel.shape[1] * ref.shape[2]
        flops = 8 * (pairs + int(window_rows(ref, out[1], nearby,
                                             ring_seg).sum()))
    elif name == "segmented_prefix_sums":
        flops = args[0].numel()
    elif name == "assoc_cell":
        flops = 8 * args[2].shape[0] * 8 * (args[0].shape[1] // 24)
    return nbytes, flops


def gather_bytes(x, idx, out) -> int:
    """The least bytes of ``bgather(x, idx)``: each distinct source row
    read once (a row that several indices name can be served from the
    cache after its first read), the indices read and the output written
    once."""
    import torch
    b, n = x.shape[:2]
    off = n * torch.arange(b, device=idx.device).reshape(
        (b,) + (1,) * (idx.dim() - 1))
    rows = (idx.long() + off).unique().numel()
    row = math.prod(x.shape[2:]) * x.element_size()
    return rows * row + _nbytes([idx, out])


def evict_bytes(aux, cleared: int) -> int:
    """The least bytes of the window pass over a table ``aux`` as it was
    before the call: every slot's cx read (4 bytes), a live slot's cy and
    cz besides (8), and a cleared slot's eight planes written (32). At 12
    bytes a slot, every slot live, the fleet's two tables need 0.120 ms."""
    from aloam_tpu_torch.ops.gridmap import _EMPTY
    bk = aux.shape[-1] // 5
    live = int((aux.view(aux.shape[:-1] + (5, bk))[..., 1, :]
                != _EMPTY).sum())
    return 4 * (aux.numel() // 5) + 8 * live + 32 * cleared


def library_gather(x, idx):
    """A call of the library's advanced indexing that ``bgather``
    replaces, ``flat[gidx]``, on a flat view and an int64 index built
    beforehand, so that it times the indexing alone."""
    import torch
    b, n = x.shape[:2]
    flat = x.reshape((b * n,) + tuple(x.shape[2:]))
    gidx = (idx.long() + n * torch.arange(b, device=idx.device).reshape(
        (b,) + (1,) * (idx.dim() - 1))).reshape(-1)
    return lambda: flat[gidx]


def bound_of(nbytes: int, flops: int):
    """(bound ms, what bounds it) against the card's published peaks."""
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def record_inputs(names, drive):
    """Run ``drive()`` with each named kernel's wrapper recording its
    inputs, one record per distinct input signature
    (``kernels.record_inputs``), failing unless every one was called.
    Returns {(name, signature): (args, kw)}."""
    import torch
    recorded = kernels.record_inputs(names, drive)
    torch.cuda.synchronize()
    missing = set(names) - {name for name, _ in recorded}
    if missing:
        fail(f"the main path never called {sorted(missing)}")
    return recorded


def fresh_calls(name, fn, args, kw, n: int):
    """A call of ``fn`` on the inputs for ``cuda_ms``, ``n`` times. A
    kernel that updates arguments in place gets a fresh clone of them on
    every call, all made before the clock starts, so that no launch works
    on a table an earlier launch updated."""
    pool = iter([kernels.fresh(name, args) for _ in range(n)])
    return lambda: fn(*next(pool), **kw)


def check_recorded(mods, recorded, results, card):
    """Compare and time kernel and plain version on each recorded input;
    ``results`` keeps per kernel the worst error and the times of its
    largest input."""
    import torch
    for (name, _), (args, kw) in sorted(recorded.items(),
                                        key=lambda kv: str(kv[0])):
        kern, plain = kernels.wrapper(name), kernels.plain(name)
        got = kernels.run(name, kern, args, kw)
        want = kernels.run(name, plain, args, kw)
        torch.cuda.synchronize()
        extra = [a for a in args if isinstance(a, (str, bool, int))]
        err = compare(name, got, want,
                      *[a for a in extra if isinstance(a, str)],
                      inputs=args)
        nbytes, flops = kernel_work(name, args, kw, got)
        bound_ms, bound_by = bound_of(nbytes, flops)
        ms = cuda_ms(fresh_calls(name, kern, args, kw, 21), 20)
        device_ms = cuda_ms(fresh_calls(name, kern, args, kw, 21), 20,
                            queued=True)
        plain_ms = cuda_ms(fresh_calls(name, plain, args, kw, 6), 5)
        library_ms = cuda_ms(library_gather(*args), 20, queued=True) \
            if name == "bgather" else None
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        size = sum(a.numel() for a in args if torch.is_tensor(a))
        library = "" if library_ms is None \
            else f" library flat[gidx] device {library_ms:.4f} ms"
        say(f"[kernel] {name}{extra if extra else ''}: inputs {shapes} "
            f"max_abs_err {err:.3g} kernel {ms:.4f} ms (device "
            f"{device_ms:.4f}) plain {plain_ms:.4f} ms{library} bound "
            f"{bound_ms:.4f} ms ({bound_by}: "
            f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP) ({card})")
        prev = results.get(name)
        if prev is None or size > prev["size"]:
            results[name] = dict(max_abs_err=max(err, prev["max_abs_err"])
                                 if prev else err, ms=ms, device_ms=device_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=library_ms,
                                 size=size)
        else:
            prev["max_abs_err"] = max(err, prev["max_abs_err"])


def check_kernels(pipeline, mods, cfg, frames, device, card):
    """Phase 4: step_b's kernels at the inputs frame 1 of step_b gives
    them, and the device time of a trivial launch beside them. Returns
    {name: dict(max_abs_err, ms, plain_ms, size)}."""
    import torch
    st = pipeline.init_state(cfg, B, device)
    st, _ = pipeline.step_b(st, *frames[0], cfg)
    recorded = record_inputs(
        kernels.STEP_B, lambda: pipeline.step_b(st, *frames[1], cfg))
    del st
    results = {}
    check_recorded(mods, recorded, results, card)
    one = torch.zeros(1, device=device)
    say(f"[kernel] launch floor: a one-element add, device "
        f"{cuda_ms(lambda: one.add_(1), 20, queued=True):.4f} ms (every "
        f"device ms above includes such a launch) ({card})")
    return results


def check_single_kernels(pipeline, mods, cfg_b, map_state, odom_state,
                         cfg_1, single, device, results, card):
    """Phase 7: the single-stream step's kernels at the inputs its frame 1
    gives them (knn_select: the table entry), and the cache entry
    (knn_select_rows) at one B = 16 corner_associations_b and
    surf_associations_b call on ``map_state`` (phase 6's last map) with
    the last frame's handoff clouds, downsampled to the stack caps: that
    call is the association API's path, its launches counted from 0.
    Returns the cache entry's launches in it."""
    import torch
    from aloam_tpu_torch import mapping as mp
    from aloam_tpu_torch.frontend.voxel import voxel_downsample_masked_b

    st = pipeline.init_state(cfg_1, 1, device)
    st, _ = pipeline.step(st, *single[0], cfg_1)
    recorded = record_inputs(
        kernels.STEP, lambda: pipeline.step(st, *single[1], cfg_1))
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

    kernels.reset(("knn_select_rows",))
    recorded.update(record_inputs(("knn_select_rows",), assoc_b))
    rows_launches = kernels.launches("knn_select_rows")
    say(f"[kernel] the B={B} association API launched knn_select_rows "
        f"{rows_launches} times")
    if rows_launches < 1:
        fail("the association API never launched knn_select_rows")
    check_recorded(mods, recorded, results, card)
    return rows_launches


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
                      vox.segmented_prefix_sums_plain(v, h), inputs=(v, h))
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


def assoc_rows(rng, n_rows: int, bw: int):
    """(n_rows, 24 bw) f32 block-planar candidate rows and (n_rows, 3) row
    centres: row r holds 6 to 8 bw points in scattered slots (the rest
    empty at 1e9, the map's sentinel) around its centre, on a plane for
    even r and along a line for odd r; candidate j = block·bw + e has its
    x at block·3bw + e, its y at +bw, its z at +2bw."""
    pts = np.full((n_rows, 8 * bw, 3), 1e9, np.float32)
    centres = rng.uniform(-50, 50, (n_rows, 3)).astype(np.float32)
    for r in range(n_rows):
        cnt = int(rng.integers(6, 8 * bw + 1))
        u, v = np.linalg.qr(rng.normal(size=(3, 3)))[0][:, :2].T
        spread = rng.uniform(-0.8, 0.8, (cnt, 2))
        if r % 2:
            spread[:, 1] = 0.0
        p = centres[r] + spread @ np.stack([u, v]) \
            + rng.normal(0, 0.01, (cnt, 3))
        pts[r, rng.choice(8 * bw, cnt, replace=False)] = p
    rows = pts.reshape(n_rows, 8, bw, 3).transpose(0, 1, 3, 2)
    return rows.reshape(n_rows, 24 * bw).copy(), centres


def assoc_q8(rng, centres, tiles, tq: int, n: int):
    """(cid0 (T,) i32, q8 (n, 8) f32) for tiles [(cid0, locals (tq,),
    poison (tq,))]: each query 0.3 m around its row's centre."""
    cid0 = np.array([t[0] for t in tiles], np.int32)
    q8 = np.zeros((len(tiles) * tq, 8), np.float32)
    for k, (c0, local, poison) in enumerate(tiles):
        rows = slice(k * tq, (k + 1) * tq)
        q8[rows, :3] = centres[c0 + local] + rng.normal(0, 0.3, (tq, 3))
        q8[rows, 3] = poison
        q8[rows, 4] = local
    return cid0, q8[:n]


def check_adversarial_assoc(mods, device, results, card):
    """Phase 4, third part: assoc_cell bit-equal to its plain version, both
    kinds, on a table of plane and line rows: a tile whose 256 queries all
    share one row; a tile with a row per query; all-poisoned tiles; queries
    at local + rem == win - 1 and == win with assoc_cspan 128 (win 136);
    rows of six equal points (a degenerate fit: a zero covariance, so the
    corner eigenvector's norm is <= 1e-8 and the fit falls back to the x
    axis); and n = 589, not a multiple of the 32 queries a block of the
    kernel takes, over tiles of ~4 queries a row."""
    import torch
    mod = mods["assoc_cell"]
    rng = np.random.default_rng(5)
    tq, n_rows = 256, 1024
    ramp = np.arange(tq) * 140 // (tq - 1)
    edge = np.sort(np.concatenate([np.arange(133), np.full(60, 132),
                                   np.full(63, 133)]))
    zero, ones = np.zeros(tq), np.ones(tq)
    typical = [(c0, np.sort(rng.integers(0, 64, tq)), rng.uniform(size=tq)
                < 0.3) for c0 in (100, 300, 500)]
    cases = {
        "one row": ([(10, np.zeros(tq, int), zero)], tq, 0),
        "a row per query": ([(16, np.arange(tq), zero)], tq, 0),
        "all poisoned": ([(40, ramp, ones), (600, ramp, ones)], 2 * tq, 0),
        "window edge": ([(43, edge, zero)], tq, 128),
        "degenerate": ([(800, ramp // 8, zero)], tq, 0),
        "n = 589": (typical, 589, 128),
    }
    worst = 0.0
    for kind, bw in (("surf", 48), ("corner", 32)):
        rows, centres = assoc_rows(rng, n_rows, bw)
        # rows 800-817: six equal points at the centre, the rest empty
        for r in range(800, 818):
            pts = np.full((8 * bw, 3), 1e9, np.float32)
            pts[rng.choice(8 * bw, 6, replace=False)] = centres[r]
            rows[r] = pts.reshape(8, bw, 3).transpose(0, 2, 1).reshape(-1)
        cand = torch.from_numpy(rows).to(device)
        for label, (tiles, n, cspan) in cases.items():
            cid0, q8 = assoc_q8(rng, centres, tiles, tq, n)
            args = (cand, torch.from_numpy(cid0).to(device),
                    torch.from_numpy(q8).to(device), kind, 1.0)
            kw = dict(plane_tol=0.2, eigen_ratio=3.0, half_len=0.1, tq=tq,
                      cspan=cspan)
            got = mod.assoc_cell(*args, **kw)
            want = mod.assoc_cell_plain(*args, **kw)
            worst = max(worst, kernels.absdiff(got, want).max().item())
            if not torch.equal(got, want):
                fail(f"assoc_cell {kind} {label}: kernel differs from its "
                     f"plain version (max abs err "
                     f"{kernels.absdiff(got, want).max().item():.6g})")
            okc = 4 if kind == "surf" else 6
            live = int((want[:, 7 if kind == "corner" else 5] < 1.0).sum())
            say(f"[adversarial] assoc_cell {kind} {label}: {n} queries, "
                f"{live} pass the gate, {int(want[:, okc].sum())} ok: "
                f"bit-equal to plain ({card})")
            if label == "window edge":
                # local 132 (rem 3) is the window's last row, 133 past it
                local, d4 = args[2][:, 4], got[:, okc + 1]
                if not (torch.isinf(d4[local == 133]).all()
                        and (d4[local == 132] < 1.0).any()):
                    fail(f"assoc_cell {kind}: the window edge is misplaced")
            if label == "degenerate" and kind == "corner" and not bool(
                    (got[:, 0] - got[:, 3] > 0.19).all()):
                fail("assoc_cell corner: degenerate fits must fall back to "
                     "the x axis")
    results["assoc_cell"]["max_abs_err"] = max(
        results["assoc_cell"]["max_abs_err"], worst)


def lm_inputs(rng, bsz: int, ne: int, npl: int, live: float = 0.7):
    """(ef (B, 10, Ne), pf (B, 8, Np), pose (B, 8)) f32: edge and plane
    factors of unit scale near a pose a little off the identity, a share
    ``live`` of them live, the masked ones poisoned (inf points on edges,
    NaN on planes), as tests/test_pallas_lm.py makes them."""
    e_p = rng.normal(scale=8.0, size=(bsz, ne, 3))
    e_a = e_p + rng.normal(scale=0.05, size=(bsz, ne, 3))
    dirs = rng.normal(size=(bsz, ne, 3))
    e_b = e_a + 0.4 * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    e_m = rng.random((bsz, ne)) < live
    e_p[~e_m] = np.inf
    p_p = rng.normal(scale=8.0, size=(bsz, npl, 3))
    nrm = rng.normal(size=(bsz, npl, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = -np.sum(nrm * p_p, axis=-1) + rng.normal(scale=0.02, size=(bsz, npl))
    p_m = rng.random((bsz, npl)) < live
    p_p[~p_m] = np.nan
    ef = np.concatenate([e_p, e_a, e_b, e_m[..., None]], -1)
    pf = np.concatenate([p_p, nrm, d[..., None], p_m[..., None]], -1)
    q = np.tile([0.999, 0.02, -0.03, 0.01], (bsz, 1))
    pose = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True),
                           rng.normal(scale=0.1, size=(bsz, 3)),
                           np.zeros((bsz, 1))], 1)
    return (np.ascontiguousarray(ef.transpose(0, 2, 1), np.float32),
            np.ascontiguousarray(pf.transpose(0, 2, 1), np.float32),
            pose.astype(np.float32))


def check_adversarial_lm(mods, device, results, card):
    """Phase 4, fourth part: lm_fused within its tolerance of its plain
    version, counts exact, and bit-equal to itself on a second launch, at
    B = 1, 16 and 32 with the map solve's 3072 + 4096 factors (clusters of
    8, 6 and 3 blocks on 132 SMs); no edges; no planes; factor counts not
    divisible by the cluster (3071 + 4093, and 5 + 7 live factors, fewer
    rows than blocks). In the B = 16 case stream 3 has every factor masked (pose
    unchanged, n_factors 0) and stream 5 one live plane factor at NaN
    (every step non-finite: nonfinite = n_iters, the pose unchanged).
    Then the s channel (lm_fused_s) the same way at the odometry's B = 16
    x (768 + 1536): s ≡ 1, which must also agree with the s-free launch
    on the same factors within the same tolerance (the slerp to s = 1
    normalizes q, so not bit for bit); s ≡ 0 (a zero Jacobian: the pose
    stays); s at 0 and 1 mixed; a pose with qw < 0 (the slerp's sign
    flip); the identity pose (the LERP branch, every stream's first
    odometry frame); random s with the masked rows' s at NaN."""
    import torch
    from aloam_tpu_torch.ops import _build
    mod = mods["lm_fused"]
    rng = np.random.default_rng(11)
    n_iters = 4
    cases = {"B=1": (1, 3072, 4096), "B=16": (16, 3072, 4096),
             "B=32": (32, 3072, 4096), "no edges": (4, 0, 4096),
             "no planes": (4, 3072, 0), "uneven": (3, 3071, 4093),
             "fewer rows than blocks": (2, 5, 7)}
    worst = 0.0
    for label, (bsz, ne, npl) in cases.items():
        ef, pf, pose = lm_inputs(rng, bsz, ne, npl,
                                 1.0 if label.startswith("fewer") else 0.7)
        if label == "B=16":
            ef[3, 9] = 0.0
            pf[3, 7] = 0.0
            pf[5, :3, 0] = np.nan
            pf[5, 7, 0] = 1.0
        ef, pf, pose = (torch.from_numpy(a).to(device) for a in (ef, pf,
                                                                 pose))
        got = mod.lm_fused(ef, pf, pose, n_iters, 0.1)
        again = mod.lm_fused(ef, pf, pose, n_iters, 0.1)
        want = mod.lm_fused_plain(ef, pf, pose, n_iters, 0.1)
        worst = max(worst, compare("lm_fused", got, want))
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            fail(f"lm_fused {label}: two launches on the same inputs differ")
        if label == "B=16" and not (
                got[3, 9] == 0 and torch.equal(got[3, :7], pose[3, :7])
                and got[5, 11] == n_iters
                and torch.equal(got[5, :7], pose[5, :7])):
            fail(f"lm_fused: the all-masked or the NaN stream moved: "
                 f"{got[[3, 5]].tolist()}")
        cluster = mod.launch_plan(bsz, ne, npl, _build.sm_count(device))
        say(f"[adversarial] lm_fused {label}: B={bsz}, {ne} edges + {npl} "
            f"planes, cluster {cluster}: within tolerance of plain, counts "
            f"exact, two launches bit-equal; nonfinite "
            f"{got[:, 11].int().tolist()[:6]} ({card})")
    results["lm_fused"]["max_abs_err"] = max(
        results["lm_fused"]["max_abs_err"], worst)

    ef, pf, pose = lm_inputs(rng, B, 768, 1536)
    live_e, live_p = ef[:, 9] > 0.5, pf[:, 7] > 0.5
    rand_e = rng.uniform(size=live_e.shape).astype(np.float32)
    rand_p = rng.uniform(size=live_p.shape).astype(np.float32)
    ident = pose.copy()
    ident[:, :7] = [1, 0, 0, 0, 0, 0, 0]
    flipped = pose.copy()
    flipped[:, :4] *= -1.0
    s_cases = {
        "s = 1": (np.ones_like(rand_e), np.ones_like(rand_p), pose),
        "s = 0": (np.zeros_like(rand_e), np.zeros_like(rand_p), pose),
        "s at 0 and 1": ((rand_e < 0.5).astype(np.float32),
                         (rand_p < 0.5).astype(np.float32), pose),
        "qw < 0": (rand_e, rand_p, flipped),
        "identity pose": (rand_e, rand_p, ident),
        "masked s NaN": (np.where(live_e, rand_e, np.nan),
                         np.where(live_p, rand_p, np.nan), pose),
    }
    plain_args = [torch.from_numpy(a).to(device) for a in (ef, pf)]
    worst_s = 0.0
    for label, (se, sp, ps) in s_cases.items():
        efs = torch.from_numpy(np.concatenate([ef, se[:, None]], 1)).to(device)
        pfs = torch.from_numpy(np.concatenate([pf, sp[:, None]], 1)).to(device)
        ps = torch.from_numpy(ps).to(device)
        got = mod.lm_fused(efs, pfs, ps, n_iters, 0.1)
        again = mod.lm_fused(efs, pfs, ps, n_iters, 0.1)
        worst_s = max(worst_s, compare(
            "lm_fused_s", got, mod.lm_fused_plain(efs, pfs, ps, n_iters,
                                                  0.1)))
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            fail(f"lm_fused_s {label}: two launches on the same inputs "
                 f"differ")
        if label == "s = 1":
            compare("lm_fused_s", got,
                    mod.lm_fused(*plain_args, ps, n_iters, 0.1))
        if label == "s = 0" and not torch.equal(got[:, :7], ps[:, :7]):
            fail("lm_fused_s: s = 0 moved the pose")
        say(f"[adversarial] lm_fused_s {label}: B={B}, 768 edges + 1536 "
            f"planes, within tolerance of plain"
            f"{' and of the s-free launch' if label == 's = 1' else ''}, "
            f"counts exact, two launches bit-equal; moved "
            f"{float((got[:, 4:7] - ps[:, 4:7]).abs().max()):.3g} m "
            f"({card})")
    # timed at the distorted path's inputs in phase 10
    results["lm_fused_s"] = dict(max_abs_err=worst_s, size=0)


def check_adversarial_select(mods, device, card):
    """Phase 4, fifth part: select_rings labels exact against its plain
    version on rows that press on one rule of the walk each
    (``_torch_scenes.select_case``: ring-like rows, all ties above and
    below the threshold, every point above, every point below, ±inf and
    NaN, one window over the whole row, disabled windows, bcum stepping at
    every column and never, marks that cross into the next region), 64
    rows of the path's width 1856; then the whole-row window and ring-like
    rows at one stream's 2560 (windows up to 425 columns, past the
    kernel's largest register tile), C = 1000 (not a multiple of 32),
    R' = 1 and R' = 4096."""
    import torch
    mod = mods["select_rings"]
    rng = np.random.default_rng(6)
    cases = [(case, 64, 1856) for case in SELECT_CASES] + [
        ("whole_row", 64, 2560), ("ring_rows", 64, 2560),
        ("ring_rows", 256, 1000),
        ("ring_rows", 1, 1856), ("ring_rows", 4096, 1856)]
    for case, rows, c in cases:
        curv, bcum, spep, _ = select_case(rng, case, rows, c)
        args = tuple(torch.from_numpy(a).to(device) for a in (curv, bcum,
                                                              spep))
        args += (6, 2, 20, 4, 5, 0.1)
        got = mod.select_rings(*args)
        compare("select_rings", got, mod.select_rings_plain(*args))
        say(f"[adversarial] select_rings {case}: ({rows}, {c}), "
            f"{int((got > 0).sum())} corner and {int((got < 0).sum())} flat "
            f"labels: exact against plain ({card})")


def check_adversarial_merge(mods, device, card):
    """Phase 4, sixth part: the in-place merge against its plain version,
    each on its own clone of the tables, both tables bit-equal as a whole
    (the rows no used row names included) and the counts equal, at (Bk,
    P) (32, 16), (48, 16), (48, 48) and (128, 128) over B = 2 tables of
    4096 buckets with 1024 rows (``_torch_scenes.merge_case``; P past 32
    takes the kernel's four-word point list, as the single-stream
    ``gridmap.insert``'s default point_cap max(Bk, 32) gives it): random
    tables and points, no row used,
    every point merging, more appends than empty slots in and out of the
    window (evictions in both priority classes), rows of one priority
    (ties), cnt past the point cap."""
    import torch
    mod = mods["merge_tiles"]
    rng = np.random.default_rng(8)
    for bk, cap_p in ((32, 16), (48, 16), (48, 48), (128, 128)):
        for case in MERGE_CASES:
            arrays = merge_case(rng, case, bsz=2, h=4096, cap_c=1024,
                                cap_p=cap_p, bk=bk)
            args = tuple(torch.from_numpy(a).to(device) for a in arrays)
            args += (2.0, 0.4)
            got = kernels.run("merge_tiles", mod.merge_rows, args, {})
            want = kernels.run("merge_tiles", mod.merge_rows_plain, args, {})
            compare("merge_tiles", got, want)
            changed = int((got[0] != args[0]).any(dim=-1).sum())
            say(f"[adversarial] merge_tiles {case} Bk {bk} P {cap_p}: "
                f"{int((args[3] > 0).sum())} used rows, {changed} table rows "
                f"changed, merged / appended / evicted "
                f"{[int(t.sum()) for t in got[2:]]}: tables bit-equal to "
                f"plain, counts equal ({card})")
            if case == "all_unused" and changed:
                fail("merge_tiles: a row with cnt 0 changed the table")
            if case == "evictions" and not int(got[4].sum()):
                fail("merge_tiles: the evictions case evicted nothing")
    check_insert_twin(mods, device, card)


def check_stamp(device, card):
    """The stamp kernel (``ops/stamp.py``) alone, eager and as graph nodes:
    64 stamps on one stream, a ~1 us sleep between each two, must rise
    with their slot, and each, put on the host clock by the offset
    ``spans.enable`` measures, must fall between host readings taken
    before the launches and after a synchronise, within the offset's error
    bound; in a CUDA graph, the same for each of two replays. Prints the
    least step between stamps launched back to back, eager (the host's
    launch rate) and as graph nodes (a stamp node's own cost)."""
    import torch

    from aloam_tpu_torch import spans
    from aloam_tpu_torch.ops import stamp as stamp_op
    n = 64
    spans.enable(host=False, device=True)
    spans.disable()
    off, err = spans.offset(device)

    def launch(buf, sleep=True):
        for i in range(n):
            stamp_op.stamp(buf, i)
            if sleep:
                torch.cuda._sleep(2000)

    def timed(run, buf, tag):
        torch.cuda.synchronize()
        h0 = time.perf_counter_ns()
        run()
        torch.cuda.synchronize()
        h1 = time.perf_counter_ns()
        ts = np.asarray(buf.tolist(), dtype=np.int64)
        if not (np.diff(ts) > 0).all():
            fail(f"[stamp] {tag}: stamps do not rise with their slot: "
                 f"{ts.tolist()}")
        lo, hi = int(ts[0]) + off - h0, h1 - (int(ts[-1]) + off)
        if min(lo, hi) < -err:
            fail(f"[stamp] {tag}: stamps on the host clock {lo} ns after "
                 f"the launch and {hi} ns before the synchronise's end, "
                 f"past the offset's error {err} ns")
        return ts

    buf = torch.zeros(n, dtype=torch.int64, device=device)
    timed(lambda: launch(buf), buf, "eager")
    eager = int(np.diff(timed(lambda: launch(buf, False), buf,
                              "back to back")).min())
    g, gbuf = torch.cuda.CUDAGraph(), torch.zeros_like(buf)
    with torch.cuda.graph(g):
        launch(gbuf)
    first = timed(g.replay, gbuf, "graph replay 1")
    second = timed(g.replay, gbuf, "graph replay 2")
    if second[0] <= first[-1]:
        fail("[stamp] the second replay's stamps are not after the first's")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        launch(gbuf, False)
    nodes = int(np.diff(timed(g.replay, gbuf, "graph back to back")).min())
    say(f"[stamp] {n} stamps rise with their slot and lie inside the host's "
        f"window, eager and in two graph replays; offset error {err} ns; "
        f"least step back to back {eager} ns eager, {nodes} ns as graph "
        f"nodes ({card})")


def gather_shapes(device):
    """The row gathers of a ``hdl64-fleet-b32`` frame (B = 32, n_raw
    131072, 64 rings of 2560 slots, benchmark/configs/hdl64.json), with
    indices of the same pattern as the main path's: (tag, x, idx). The
    registration's stable ring sort and its ring windows, the features'
    per-ring class sort over the 2048 rings, odometry's plane search over
    the strided xyz view of a 4-wide cloud (int32), the knn cache's
    576-byte surf buckets: as ``gridmap.knn_cache_b`` builds it, the
    2x2x2 bucket block (``gridmap._block``) of each of map_cell_cap 1024
    distinct occupied cells in the cache's key order, here a quarter of
    a 32 x 32 x 4 box of cells a stream, then ASSOC_PAD zero cells, so
    that neighbouring cells share buckets as on the map."""
    import torch

    from aloam_tpu_torch.ops.gridmap import ASSOC_PAD, _block
    g = torch.Generator(device=device)
    g.manual_seed(18)
    bsz, n, rings, cap = 32, 131072, 64, 2560
    fused = torch.randn((bsz, n, 4), device=device, generator=g)
    ring = torch.randint(0, rings + 1, (bsz, n), device=device, generator=g)
    order = torch.sort(ring, dim=1, stable=True)[1]
    starts = torch.sort(torch.randint(0, n, (bsz, rings), device=device,
                                      generator=g), dim=1)[0]
    src = (starts[..., None] + torch.arange(cap, device=device)) \
        .clamp_max(n - 1).reshape(bsz, -1)
    cls = torch.randint(0, 4, (bsz * rings, cap), device=device, generator=g)
    by_cls = torch.sort(cls, dim=1, stable=True)[1]
    last = torch.randn((bsz, 40960, 4), device=device, generator=g)
    table = torch.randn((bsz, 16384, 3 * 48), device=device, generator=g)
    box = torch.stack(torch.meshgrid(
        *(torch.arange(k, device=device) for k in (32, 32, 4)),
        indexing="ij"), dim=-1).reshape(-1, 3)      # in the cache's order
    picks = torch.stack([torch.randperm(box.shape[0], device=device,
                                        generator=g)[:1024].sort()[0]
                         for _ in range(bsz)])
    corner = torch.randint(-512, 512, (bsz, 1, 3), device=device,
                           generator=g)
    cells = torch.cat([box[picks] + corner, torch.zeros(
        (bsz, ASSOC_PAD, 3), dtype=box.dtype, device=device)], dim=1)
    hh, _ = _block(cells.to(torch.int32), table.shape[1])
    return [("register.fused", fused, order),
            ("register.grid", fused, src),
            ("features.sorted_f",
             torch.randn((bsz * rings, cap, 4), device=device, generator=g),
             by_cls),
            ("odometry.plane_xyz", last[..., :3],
             torch.randint(0, 40960, (bsz, 1536), device=device, generator=g,
                           dtype=torch.int32)),
            ("knn_cache.cand", table, hh)]


# a child process that gathers row int(argv[1]) of 50 with int32 or
# int64 indices (argv[2]); it prints "launched" after the launch and
# "returned" once the card has finished
GATHER_CHILD = """
import sys
import torch
from aloam_tpu_torch.ops import gather
x = torch.randn((2, 50, 4), device="cuda")
idx = torch.zeros((2, 7), dtype=getattr(torch, sys.argv[2]), device="cuda")
idx[1, 3] = int(sys.argv[1])
out = gather.bgather(x, idx)
print("launched", flush=True)
torch.cuda.synchronize()
print("returned", flush=True)
"""


def check_gather_range(card):
    """An index outside [0, N) is a caller's bug that the row gather must
    not read past its rows for: it traps, which ends the process with a
    CUDA error. Each case runs in a child process of its own (a trap
    leaves the CUDA context unusable): row 49 (the last) must return, N
    (int32) and -1 (int64) must launch and then fail before returning."""
    root = os.path.dirname(os.path.abspath(__file__))
    for row, dtype, ok in (("49", "int32", True), ("50", "int32", False),
                           ("-1", "int64", False)):
        try:
            r = subprocess.run([sys.executable, "-c", GATHER_CHILD, row,
                                dtype], cwd=root, capture_output=True,
                               text=True, timeout=180)
        except subprocess.TimeoutExpired:
            fail(f"[gather] index {row} ({dtype}): the child process hung")
        out = r.stdout.split()
        if ok and (r.returncode != 0 or "returned" not in out):
            fail(f"[gather] index {row} ({dtype}): rc {r.returncode}, "
                 f"{r.stderr[-2000:]}")
        if not ok and (r.returncode == 0 or "launched" not in out
                       or "returned" in out):
            fail(f"[gather] index {row} ({dtype}) of 50 rows did not end "
                 f"the process after its launch: rc {r.returncode}, "
                 f"stdout {out}")
        if not ok:
            say(f"[gather] index {row} ({dtype}) of 50 rows: the launch "
                f"trapped, rc {r.returncode}: "
                f"{r.stderr.strip().splitlines()[-1][:200]} ({card})")


def check_gather(device, card):
    """The row gather (``ops/gather.bgather``, ``csrc/gather.cu``) bit-equal
    to its plain version, ``flat[gidx]``, at the fleet frame's shapes
    (``gather_shapes``) and on small cases (B = 1 and 3, int32 and int64,
    rows of 4 to 960 bytes, strided and unaligned views, an empty index,
    the last row; rows of one byte raise); each fleet shape timed back to
    back and queued beside its byte bound (``gather_bytes``: each
    distinct row read once, the indices read and the output written once)
    and the library's advanced indexing alone on a prebuilt int64 index
    (``library_ms``); then the out-of-range trap
    (``check_gather_range``)."""
    import torch

    from aloam_tpu_torch.ops import gather

    def same(a, b):
        return a.shape == b.shape and a.dtype == b.dtype \
            and a.is_contiguous() and torch.equal(
                a.reshape(-1).view(torch.uint8),
                b.contiguous().reshape(-1).view(torch.uint8))

    g = torch.Generator(device=device)
    g.manual_seed(180)
    small = []
    for bsz in (1, 3):
        cloud = torch.randn((bsz, 50, 4), device=device, generator=g)
        for dt in (torch.int32, torch.int64):
            idx = torch.randint(0, 50, (bsz, 7, 3), device=device,
                                generator=g, dtype=dt)
            small += [(cloud[..., :3], idx), (cloud[..., 1:], idx),
                      (cloud[:, ::2], idx % 25), (cloud, idx[:, :0]),
                      (cloud, torch.full_like(idx, 49)),
                      (cloud.transpose(1, 2), idx % 4),
                      (cloud.double(), idx)]
            small += [(torch.randn((bsz, 50) + row, device=device,
                                   generator=g), idx)
                      for row in ((3,), (4,), (8, 18), (240,))]
    try:
        gather.bgather(cloud[..., 0] > 0, idx)
    except ValueError:
        pass
    else:
        fail("[gather] rows of one byte did not raise")
    for x, idx in small:
        if not same(gather.bgather(x, idx), gather.bgather_plain(x, idx)):
            fail(f"[gather] x {tuple(x.shape)} {x.dtype} strides "
                 f"{x.stride()}, idx {tuple(idx.shape)} {idx.dtype}: not "
                 f"bit-equal to flat[gidx]")
    for tag, x, idx in gather_shapes(device):
        got = gather.bgather(x, idx)
        if not same(got, gather.bgather_plain(x, idx)):
            fail(f"[gather] {tag}: not bit-equal to flat[gidx]")
        nbytes = gather_bytes(x, idx, got)
        bound_ms, bound_by = bound_of(nbytes, 0)
        ms = cuda_ms(lambda: gather.bgather(x, idx), 20)
        device_ms = cuda_ms(lambda: gather.bgather(x, idx), 20, queued=True)
        library_ms = cuda_ms(library_gather(x, idx), 20, queued=True)
        plain_ms = cuda_ms(lambda: gather.bgather_plain(x, idx), 5)
        row = got.numel() // idx.numel() * got.element_size()
        say(f"[gather] {tag}: x {tuple(x.shape)} strides {x.stride()}, idx "
            f"{tuple(idx.shape)} {idx.dtype}, {row}-byte rows bit-equal; "
            f"kernel {ms:.4f} ms (device {device_ms:.4f}) library "
            f"flat[gidx] device {library_ms:.4f} ms plain {plain_ms:.4f} ms "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
            f"each distinct row once) ({card})")
    say(f"[gather] {len(small)} small cases bit-equal ({card})")
    check_gather_range(card)


# the fleet's map tables (benchmark/configs/hdl64.json, hdl32.json):
# (name, H, Bk) of the corner and the surf table
EVICT_TABLES = (("corner", 8192, 32), ("surf", 16384, 48))


def evict_tables(device, seed: int, bsz: int, **kw):
    """The fleet's two map tables for the window pass, planted by
    ``_torch_scenes.evict_table`` (``kw``) around centers within ±300
    cells, with the mapping step's window and local halves (the bench
    config's cells, ``mapping._window_cells`` / ``_local_cells``), on the
    card: (center, window, local, [(name, pts, aux)])."""
    import torch

    from aloam_tpu_torch import mapping
    cfg = bench_cfg()
    window = mapping._window_cells(cfg, device)
    local = mapping._local_cells(cfg, device)
    rng = np.random.default_rng(seed)
    center = rng.integers(-300, 300, (bsz, 3)).astype(np.int32)
    tables = []
    for name, h, bk in EVICT_TABLES:
        pts, aux = evict_table(rng, center, window.cpu().numpy(),
                               local.cpu().numpy(), h, bk, **kw)
        tables.append((name, torch.from_numpy(pts).to(device),
                       torch.from_numpy(aux).to(device)))
    return torch.from_numpy(center).to(device), window, local, tables


def check_evict(device, card):
    """The map window's evict and census (``ops/evict.evict_and_count``,
    ``csrc/evict.cu``) bit-equal to its plain version on planted tables
    (``_torch_scenes.evict_table``: cells out of the window in every
    stream, since no cell's log leaves it; the window's and the local
    box's edges on each axis; empty and full rows; cells at the int32
    extremes), with ``evict`` on and off: both tables bit-equal after the
    call and the counts equal. At the fleet frame's tables (B = 32,
    corner 8192 x 32 and surf 16384 x 48) and at B = 1 of them; on small
    tables whose Bk or address takes the 8- and the 4-byte vectors. Then
    the fleet's two tables timed together, back to back and queued (a
    fresh copy of the tables for every call), beside the bound
    (``evict_bytes``: a slot's cx, a live slot's cy and cz, a cleared
    slot's planes) and the plain version, at five fillings: as planted,
    clearing and counting only (``evict`` off); a fleet map's (35% of the
    rows in use, 80% of their slots live) with none out of the window, as
    on the benchmark's cells, clearing and counting only; every slot
    live."""
    import torch

    from aloam_tpu_torch.ops import evict
    from aloam_tpu_torch.ops.gridmap import _EMPTY

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def like(t):
        """A copy of ``t`` at its address modulo 16 bytes (so a table
        placed off a 16-byte boundary keeps its vector width)."""
        shift = t.data_ptr() % 16 // t.element_size()
        buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
        return buf[shift:].view(t.shape).copy_(t)

    def both(pts, aux, center, window, local, flag):
        """(kernel's, plain's) (pts, aux, counts) on copies of a table."""
        out = []
        for fn in (evict.evict_and_count, evict.evict_and_count_plain):
            p, a = like(pts), like(aux)
            out.append((p, a, fn(p, a, center, window, local, flag)))
        return out

    def held(tag, pts, aux, center, window, local):
        for flag in (True, False):
            (kp, ka, kn), (pp, pa, pn) = both(pts, aux, center, window,
                                              local, flag)
            if not (torch.equal(bits(kp), bits(pp)) and torch.equal(ka, pa)
                    and kn.dtype == pn.dtype == torch.int64
                    and kn.shape == pn.shape and torch.equal(kn, pn)):
                fail(f"[evict] {tag} evict={flag}: the kernel's tables or "
                     f"counts differ from the plain version's "
                     f"(counts {kn.tolist()} / {pn.tolist()})")
            if flag and not (pn[0] > 0).all():
                fail(f"[evict] {tag}: a stream cleared nothing")
            if not flag and not (torch.equal(ka, aux)
                                 and torch.equal(bits(kp), bits(pts))):
                fail(f"[evict] {tag}: evict=False wrote the table")
        width = evict.vector_bytes(aux.shape[-1] // 5, aux.data_ptr())
        say(f"[evict] {tag}: pts {tuple(pts.shape)} aux {tuple(aux.shape)} "
            f"({width}-byte cx vectors) bit-equal with evict on and off, "
            f"counts equal ({card})")

    for bsz in (32, 1):
        center, window, local, tables = evict_tables(device, 210 + bsz, bsz)
        for name, pts, aux in tables:
            held(f"B={bsz} {name}", pts, aux, center, window, local)
        del tables
    g = np.random.default_rng(211)
    for bsz, h, bk, shift in ((3, 64, 5, 0), (2, 64, 6, 0), (3, 64, 32, 1),
                              (2, 64, 48, 2)):
        center = g.integers(-50, 50, (bsz, 3)).astype(np.int32)
        win, loc = np.array([6, 5, 3], np.int32), np.array([2, 2, 1],
                                                           np.int32)
        pts, aux = evict_table(g, center, win, loc, h, bk, 0.6)
        # a table ``shift`` words past a 16-byte boundary
        buf = torch.empty(aux.size + shift, dtype=torch.int32, device=device)
        aux_t = buf[shift:].view(aux.shape).copy_(torch.from_numpy(aux))
        held(f"B={bsz} H={h} Bk={bk} shifted {shift}",
             torch.from_numpy(pts).to(device), aux_t,
             torch.from_numpy(center).to(device),
             torch.from_numpy(win).to(device),
             torch.from_numpy(loc).to(device))

    fillings = (("planted", dict(), True),
                ("planted, count only", dict(), False),
                ("fleet map, none out", dict(rows_used=0.35, fill=0.8,
                                             edges=False), True),
                ("fleet map, count only", dict(rows_used=0.35, fill=0.8,
                                               edges=False), False),
                ("every slot live", dict(fill=1.0), True))
    for tag, kw, flag in fillings:
        center, window, local, tables = evict_tables(device, 212, 32, **kw)

        def calls(fn, n):
            pool = iter([[(p.clone(), a.clone()) for _, p, a in tables]
                         for _ in range(n)])

            def call():
                for p, a in next(pool):
                    fn(p, a, center, window, local, flag)
            return call
        cleared = sum(int(evict.evict_and_count_plain(
            p.clone(), a.clone(), center, window, local, flag)[0].sum())
            for _, p, a in tables)
        nbytes = sum(evict_bytes(a, 0) for _, _, a in tables) \
            + 32 * cleared
        bound_ms, bound_by = bound_of(nbytes, 0)
        ms = cuda_ms(calls(evict.evict_and_count, 11), 10)
        device_ms = cuda_ms(calls(evict.evict_and_count, 11), 10,
                            queued=True)
        plain_ms = cuda_ms(calls(evict.evict_and_count_plain, 4), 3)
        live = sum(int((a.view(a.shape[0], a.shape[1], 5, -1)[:, :, 1]
                        != _EMPTY).sum()) for _, _, a in tables)
        every = bound_of(12 * sum(a.numel() // 5 for _, _, a in tables)
                         + 32 * cleared, 0)[0]
        say(f"[evict] B=32 corner + surf, {tag} (evict={flag}): "
            f"{live} live slots, {cleared} cleared; kernel {ms:.4f} ms "
            f"(device {device_ms:.4f}) plain {plain_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB; "
            f"{every:.4f} ms at 12 bytes a slot) ({card})")
        del tables


def check_insert_twin(mods, device, card):
    """Phase 4, sixth part, last: the single-stream ``gridmap.insert`` at
    JAX's default caps on a table of Bk 48 (the preset's surf buckets),
    so point_cap max(Bk, 32) = 48: two inserts of ~110 points a cell (the
    second merging and evicting) on the card, tables and counts bit-equal
    to the same calls on the CPU (the plain version, which
    tests/test_torch_api.py holds to JAX's insert)."""
    import torch
    from aloam_tpu_torch.ops import gridmap
    from aloam_tpu_torch.utils.batch import drop_stream_axis
    rng = np.random.default_rng(9)
    table, bk, leaf, cell = 256, 48, 0.1, 2.0
    grids = {d: drop_stream_axis(gridmap.empty(1, table, bk, d))
             for d in ("cpu", device)}
    base = rng.uniform(-3, 3, size=(3000, 3)).astype(np.float32)
    before = mods["merge_tiles"].launches
    for step in range(2):
        pts = base + rng.normal(scale=0.02, size=base.shape)
        args = [torch.from_numpy(a) for a in (
            pts.astype(np.float32),
            rng.uniform(0, 16, size=3000).astype(np.float32),
            rng.uniform(size=3000) > 0.05)]
        centre, window = (torch.tensor(v, dtype=torch.int32)
                          for v in ((1, 0, 0), (3, 3, 2)))
        outs = {d: gridmap.insert(grids[d], *(a.to(d) for a in args), leaf,
                                  cell, centre.to(d), window.to(d))
                for d in grids}
        for d, out in outs.items():
            grids[d] = out[0]
        got, want = outs[device], outs["cpu"]
        if not (torch.equal(got[0].pts.cpu(), want[0].pts)
                and torch.equal(got[0].aux.cpu(), want[0].aux)
                and all(int(g) == int(w) for g, w in zip(got[1:], want[1:]))):
            fail(f"gridmap.insert at Bk {bk}: the card's insert {step} "
                 f"differs from the CPU's")
        say(f"[adversarial] gridmap.insert Bk {bk} point_cap 48, insert "
            f"{step}: merged / appended / evicted / dropped "
            f"{[int(t) for t in got[1:]]}: tables bit-equal to the CPU's "
            f"({card})")
    if mods["merge_tiles"].launches - before != 2 or int(got[3]) < 1:
        fail("gridmap.insert at Bk 48: the kernel did not run twice, or "
             "the second insert evicted nothing")


def check_adversarial_knn(mods, device, results, card):
    """Phase 7, second part: both knn entries bit-equal to their plain
    versions on the tables of ``_torch_scenes.knn_case`` at Bk 32 and 48
    (cell 2 m, radius 1 m): random points with Q = 1001 (not a multiple of
    a block's queries), H = 8 (a block's cells share buckets), an empty
    table, fewer than 5 real candidates (ties among the _FAR slots), points
    repeated in a bucket (equal distances), negative coordinates, queries
    on cell boundaries, clusters near ±1e5 m (the 32-bit hash wraps),
    Q = 1. The table entry reads the table; the cache entry gets the same
    blocks as candidate rows, every 7th query gated (five picks of
    candidate 0 at +inf)."""
    import torch
    from aloam_tpu_torch.ops.gridmap import _FAR, block_buckets
    mod = mods["knn_select"]
    rng = np.random.default_rng(9)
    worst = {"knn_select": 0.0, "knn_select_rows": 0.0}
    for bk in (32, 48):
        for case in KNN_CASES:
            table, q = (torch.from_numpy(a).to(device)
                        for a in knn_case(rng, case, bk))
            args = (table, q, 5, 2.0, 1.0)
            got = mod.knn_grid(*args)
            worst["knn_select"] = max(worst["knn_select"], compare(
                "knn_select", got, mod.knn_grid_plain(*args)))
            hh, dup = block_buckets(q, table.shape[0], 2.0, 1.0)
            rows = table[hh.long()].masked_fill_(dup[..., None], _FAR)
            q4 = torch.cat([q, torch.zeros_like(q[:, :1])], 1)
            q4[::7, 3] = 1.0
            rargs = (rows.reshape(q.shape[0], -1),
                     torch.arange(q.shape[0], dtype=torch.int32,
                                  device=device), q4, 5)
            rgot = mod.knn_select(*rargs)
            worst["knn_select_rows"] = max(worst["knn_select_rows"], compare(
                "knn_select_rows", rgot, mod.knn_select_plain(*rargs)))
            say(f"[adversarial] knn {case} Bk {bk}: table "
                f"{tuple(table.shape)}, {q.shape[0]} queries, "
                f"{int(dup.any(1).sum())} with a "
                f"duplicate bucket, {int((got[0][:, 4] < 1.0).sum())} with 5 "
                f"gated neighbours: both entries bit-equal to plain ({card})")
    for name, err in worst.items():
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
    kernels.reset(kernels.FRONT)
    with ring_seg_spy(mods, "front"):
        k_outs, k_ms, _ = run_frames(pipeline.front_step_b, pipeline, cfg,
                                     frames, device)
    launches = {name: kernels.launches(name) for name in kernels.FRONT}
    say(f"[front] kernel launches over {len(frames)} frames: {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the front path was never launched: {launches}")
    with plain_run(kernels.FRONT):
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


def stage_times(step, pipeline, cfg, frames, device, batch):
    """A kernel run of ``step`` with the port's device stages on (each
    frame a ``spans.frame``: every stage between two ``%globaltimer``
    stamps). Returns {span: per-frame ms list}, each span summed over its
    frame, and ``graph``: the first stamp to the last."""
    from aloam_tpu_torch import spans
    st = pipeline.init_state(cfg, batch, device)
    with spans.tracing(host=False, device=True):
        for i, (xyz, mask) in enumerate(frames):
            with spans.frame(device, i):
                st, _ = step(st, xyz, mask, cfg)
        per = spans.frame_ms(spans.drain())
    return {name: [ms.get(name, 0.0) for ms in per] for name in per[0]}


def stage_busy(step, pipeline, cfg, frames, device, batch, staged=True):
    """A kernel run of ``step`` with frames 1.. under torch.profiler:
    with ``staged``, each frame a ``spans.frame`` with the device stages
    on, whose every stage opens a record_function range of its name. Each
    span's device time: that of the operations starting inside the range's
    device-side mirror (its first device operation to its last; one stream
    runs them in order), the device's idle gaps left out, unlike the span
    itself. The mirror misses the kernels launched through ctypes at a
    range's edges, which no aten operation encloses, as the stamps are; so
    every top-level span of every frame must have one. Also the device's
    busy time per frame and the frame's wall time under the profiler.
    Returns ({span: ms per frame}, busy ms per frame, wall ms per frame,
    operations per frame, {device operation: ms per frame}); the stamps are
    left out of the operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aloam_tpu_torch import spans
    n = len(frames) - 1
    st = pipeline.init_state(cfg, batch, device)
    st, _ = step(st, *frames[0], cfg)
    torch.cuda.synchronize()
    with spans.tracing(host=False, device=staged), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, (xyz, mask) in enumerate(frames[1:]):
            with spans.frame(device, i):
                st, _ = step(st, xyz, mask, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    recs = [r for r in spans.drain() if r["clock"] == "device"]
    names = {r["name"] for r in recs}
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {name: [] for name in names}
    ops = []                                   # (start, duration, name)
    for ev in prof.events():
        if ev.device_type != cuda:
            continue
        if ev.name in names:
            ranges[ev.name].append((ev.time_range.start, ev.time_range.end))
        elif "aloam_stamp" not in ev.name:
            ops.append((ev.time_range.start, ev.time_range.elapsed_us(),
                        ev.name))
    for name in {r["name"] for r in recs if r["parent"] is None}:
        want = sum(r["name"] == name for r in recs)
        if len(ranges[name]) != want:
            fail(f"stage_busy: {len(ranges[name])} device ranges of "
                 f"{name} under the profiler for {want} spans")
    ops.sort()
    starts = [o[0] for o in ops]
    before = np.concatenate([[0.0], np.cumsum([o[1] for o in ops])])
    per_stage = {name: sum(before[bisect.bisect_left(starts, e)]
                           - before[bisect.bisect_left(starts, s)]
                           for s, e in ranges[name]) / 1e3 / n
                 for name in dict.fromkeys(r["name"] for r in recs)}
    per_op = {}
    for _, dur, name in ops:
        per_op[name] = per_op.get(name, 0.0) + dur / 1e3 / n
    return per_stage, before[-1] / 1e3 / n, wall, len(ops) / n, per_op


def say_busy(tag, pipeline, cfg, frames, device, batch, card):
    """Print the profiled device busy time by span and by operation;
    returns the busy ms per frame."""
    per_stage, busy, wall, n_ops, per_op = stage_busy(
        pipeline.step_b if batch > 1 else pipeline.step, pipeline, cfg,
        frames, device, batch)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    say(f"[{tag}] device busy ms per frame by span, torch.profiler, mean "
        f"of frames 1-{len(frames) - 1}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_stage.items())
        + f"; the device busy {busy:.3f} of {wall:.2f} ms per frame "
        f"(idle {100 * (1 - busy / wall):.1f}%), {n_ops:.0f} device "
        f"operations per frame besides the stamps ({card})")
    say(f"[{tag}] device ms per frame by operation, the ten largest: "
        + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
    return busy


def say_stages(tag, per_frame, card):
    med = {label: float(np.median(v[1:])) for label, v in per_frame.items()}
    say(f"[{tag}] device ms per frame by span (spans.stage stamps), median of "
        f"frames 1-{len(next(iter(per_frame.values()))) - 1}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items()) + f" ({card})")


def pose_agreement(tag, k_outs, p_outs, k_ms, p_ms, batch,
                   labels=("kernel", "plain")):
    """Map poses of a kernel run and a plain run (or the two runs
    ``labels`` names), frame by frame: within 1e-3 (q) / 5e-3 m (t)
    unless a gate flipped in that stream (from then on), and within
    2.5e-2 always."""
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
        say(f"[{tag}] frame {f}: {labels[0]} {k_ms[f]:.1f} ms {labels[1]} "
            f"{p_ms[f]:.1f} ms; map max |dq| {dq.max():.3g} max |dt| "
            f"{dt.max():.3g} m; "
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
    ``names`` must launch, and the row gather once for every ``bgather``
    call that moved rows) and with every kernel's plain version (none may
    launch). Returns (kernel outputs, kernel ms, plain outputs, plain ms,
    launches, final kernel-run state, the kernel run's peak device memory
    in bytes)."""
    import torch
    gather, moved = mods["bgather"], [0]

    def counted(x, idx, bgather=gather.bgather):
        out = bgather(x, idx)
        moved[0] += out.numel() > 0
        return out
    kernels.reset()
    torch.cuda.reset_peak_memory_stats(device)
    with ring_seg_spy(mods, tag), Patched([(gather, "bgather", counted)]):
        k_outs, k_ms, st = run_frames(step, pipeline, cfg, frames, device,
                                      batch)
    peak = torch.cuda.max_memory_allocated(device)
    launches = kernels.counts()
    say(f"[{tag}] kernel launches over {len(frames)} frames: {launches}")
    if min(launches[n] for n in names) < 1:
        fail(f"a kernel of the {tag} path was never launched: {launches}")
    if launches["bgather"] != moved[0]:
        fail(f"[{tag}] the row gather launched {launches['bgather']} "
             f"times for {moved[0]} bgather calls that moved rows")
    say(f"[{tag}] the row gather: {launches['bgather'] / len(frames):g} "
        f"launches a frame, one for each bgather call that moved rows")
    with plain_run(kernels.KERNELS):
        p_outs, p_ms, _ = run_frames(step, pipeline, cfg, frames, device,
                                     batch)
    if kernels.counts() != launches:
        fail(f"the plain {tag} run launched a kernel")
    return k_outs, k_ms, p_outs, p_ms, launches, st, peak


def run_step(pipeline, mods, cfg, frames, gt, device, card):
    """Phase 6: step_b with the kernels, with the plain versions, and a
    staged kernel run. Returns (launches, the kernel run's final state,
    its per-frame outputs and host ms, the device busy ms per frame)."""
    from aloam_tpu_torch.pipeline import METRIC_NAMES

    k_outs, k_ms, p_outs, p_ms, launches, st, peak = kernel_and_plain(
        "step", pipeline.step_b, pipeline, mods, kernels.STEP_B, cfg, frames,
        device, B)
    pose_agreement("step", k_outs, p_outs, k_ms, p_ms, B)
    sk, sp = float(np.mean(k_ms[1:])), float(np.mean(p_ms[1:]))
    say(f"[step] frames 1-{len(frames) - 1}: kernels {sk:.2f} ms/frame = "
        f"{B * 1e3 / sk:.1f} scans/s; plain {sp:.2f} ms/frame = "
        f"{B * 1e3 / sp:.1f} scans/s; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB (B={B}, {card})")

    say_stages("step", stage_times(pipeline.step_b, pipeline, cfg, frames,
                                   device, B), card)
    busy = say_busy("step", pipeline, cfg, frames, device, B, card)

    col = {n: i for i, n in enumerate(METRIC_NAMES)}
    last = k_outs[-1]["metrics"]
    say("[step] last-frame metrics (stream 0): "
        + json.dumps({n: float(last[0, i]) for n, i in col.items()}))
    if not last[:, col["map_solved"]].all():
        fail("mapping did not solve in every stream")
    ate_check("step", k_outs, gt, B)
    return launches, st, k_outs, k_ms, busy


def run_single(pipeline, mods, cfg, frames, gt, device, card):
    """Phase 8: the single-stream step with the kernels and with the plain
    versions. Returns the launches of the kernel run, its outputs and its
    final map tables (corner, surf)."""
    from aloam_tpu_torch.pipeline import METRIC_NAMES
    k_outs, k_ms, p_outs, p_ms, launches, st, peak = kernel_and_plain(
        "single", pipeline.step, pipeline, mods, kernels.STEP, cfg, frames,
        device, 1)
    pose_agreement("single", k_outs, p_outs, k_ms, p_ms, 1)
    sk, sp = float(np.mean(k_ms[1:])), float(np.mean(p_ms[1:]))
    say(f"[single] frames 1-{len(frames) - 1}: kernels {sk:.2f} ms/scan = "
        f"{1e3 / sk:.1f} scans/s; plain {sp:.2f} ms/scan = "
        f"{1e3 / sp:.1f} scans/s; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB (one HDL-64 stream, PRESETS['HDL-64'], "
        f"{card})")
    say_stages("single", stage_times(pipeline.step, pipeline, cfg, frames,
                                     device, 1), card)
    say_busy("single", pipeline, cfg, frames, device, 1, card)
    last = dict(zip(METRIC_NAMES, k_outs[-1]["metrics"].tolist()))
    say("[single] last-frame metrics: " + json.dumps(last))
    if last["map_solved"] != 1:
        fail("single-stream mapping did not solve")
    ate_check("single", k_outs, gt[None], 1)
    return launches, k_outs, (st.map.corner, st.map.surf)


def run_cli(device, card):
    """Phase 9: the CLI end to end on the card, and a resumed run."""
    from aloam_tpu_torch import cli
    from aloam_tpu_torch import graph as gm
    gm.captures = gm.replays = 0
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
        # make_step_fn: one capture a run, a replay a frame (4 + 2)
        say(f"[cli] through the graphed make_step_fn: {gm.captures} "
            f"captures, {gm.replays} replays")
        if (gm.captures, gm.replays) != (2, 6):
            fail("cli: the runs did not go through one graph each")


def check_distorted_kernel(pipeline, mods, cfg_b, frames, cfg_1, single,
                           device, results, card):
    """Phase 10, first part: lm_fused with the s channel at the inputs
    frame 1 of the distorted step_b (B = 16) and of the distorted step
    (one stream) gives it (their odometry solves), against its plain
    version, two launches bit-equal, and timed beside the s-free launch
    on the same factors (the s channel dropped)."""
    import torch
    mod = mods["lm_fused"]
    with_s = {}
    for tag, step, cfg, data, batch in (
            ("step_b", pipeline.step_b, cfg_b, frames, B),
            ("step", pipeline.step, cfg_1, single, 1)):
        st = pipeline.init_state(cfg, batch, device)
        st, _ = step(st, *data[0], cfg)
        recorded = record_inputs(
            ("lm_fused",), lambda: step(st, *data[1], cfg))
        del st
        got = {("lm_fused_s", sig): v for (_, sig), v in recorded.items()
               if v[0][0].shape[1] == 11}
        if not got:
            fail(f"the distorted {tag} never solved with the s channel")
        with_s.update(got)
    check_recorded(mods, with_s, results, card)
    for args, kw in with_s.values():
        ef, pf = args[0], args[1]
        got = mod.lm_fused(*args, **kw)
        if not torch.equal(got.view(torch.int32),
                           mod.lm_fused(*args, **kw).view(torch.int32)):
            fail(f"lm_fused_s: two launches on the distorted inputs "
                 f"{tuple(ef.shape)} differ")
        rigid = (ef[:, :10].contiguous(), pf[:, :8].contiguous()) + args[2:]

        def launch():
            return mod.lm_fused(*rigid, **kw)
        say(f"[kernel] lm_fused without the s channel on the same factors "
            f"{tuple(ef.shape[::2])} + {tuple(pf.shape[::2])}: kernel "
            f"{cuda_ms(launch, 20):.4f} ms (device "
            f"{cuda_ms(launch, 20, queued=True):.4f}) ({card})")


def distortion_gates(tag, d_outs, r_outs, gt, batch, ate_limit):
    """The physics of tests/test_pipeline.py's distortion tests on a run
    with ``distortion=True`` (d_outs) and one without (r_outs), both with
    the kernels, against the ground truth (S, F + 1, 3) of sweep starts:
    the frame-to-frame translation error from frame 2 on must fall below
    0.75 of the rigid model's in the mean over streams (that test's gate)
    and below the rigid model's on every stream (as the JAX package's
    does on each of these scenes, tests/_torch_distortion_witness.py), and
    every stream's aligned mapped ATE of frames 1.. against sweep ends
    2.. must stay under ``ate_limit``. The rigid model's ATE is printed
    beside it."""
    from aloam_tpu_torch.eval.ate import ate_rmse

    def track(outs, key):
        return np.stack([np.reshape(o[key], (batch, 3)) for o in outs], 1)

    n = len(d_outs)
    gt_d = np.diff(gt[:, 1:1 + n], axis=1)

    def rpe(outs):
        d = np.diff(track(outs, "t_odom"), axis=1)
        return np.linalg.norm(d[:, 2:] - gt_d[:, 2:], axis=-1).mean(axis=1)

    def ate(outs):
        t_map = track(outs, "t_map")
        return np.array([ate_rmse(t_map[b, 1:], gt[b, 2:1 + n], align=True)
                         for b in range(batch)])

    e_dist, e_rigid = rpe(d_outs), rpe(r_outs)
    a_dist, a_rigid = ate(d_outs), ate(r_outs)
    say(f"[{tag}] frame-to-frame translation error, frames 2-{n - 1}, mean "
        f"over {batch} stream(s): distortion {e_dist.mean():.4f} m, rigid "
        f"{e_rigid.mean():.4f} m (ratio {e_dist.mean() / e_rigid.mean():.3f}"
        f", gate 0.75; per stream gate 1, worst "
        f"{(e_dist / e_rigid).max():.3f}); per stream distortion "
        f"{np.round(e_dist, 4).tolist()} rigid "
        f"{np.round(e_rigid, 4).tolist()}")
    say(f"[{tag}] aligned mapped ATE vs sweep ends over frames 1-{n - 1}, "
        f"per stream (gate {ate_limit:g} m each): distortion max "
        f"{a_dist.max():.4f} m (stream {int(a_dist.argmax())}), median "
        f"{np.median(a_dist):.4f} m, {np.round(a_dist, 4).tolist()}; rigid "
        f"max {a_rigid.max():.4f} m, median {np.median(a_rigid):.4f} m, "
        f"{np.round(a_rigid, 4).tolist()}")
    if not e_dist.mean() < 0.75 * e_rigid.mean():
        fail(f"{tag}: the distortion model does not beat the rigid one")
    if not (e_dist < e_rigid).all():
        fail(f"{tag}: the distortion model is worse than the rigid one on "
             f"streams {np.flatnonzero(~(e_dist < e_rigid)).tolist()}")
    if not (a_dist < ate_limit).all():
        fail(f"{tag}: the distorted mapped pose does not track the ground "
             f"truth on streams "
             f"{np.flatnonzero(~(a_dist < ate_limit)).tolist()}")


def run_distortion(pipeline, mods, cfg_b, cfg_1, device, results, card):
    """Phase 10: the distortion path. Returns the distorted step_b's
    launches, and its config, frames and kernel run's outputs."""
    import torch
    dcfg_b, dcfg_1 = (c.replace(distortion=True) for c in (cfg_b, cfg_1))
    t0 = time.perf_counter()
    xyz, mask, gt = make_distorted(
        cfg_b, DIST_CACHE, [DIST_SEED + b for b in range(B)],
        [DIST_SPEED + 0.25 * b for b in range(B)])
    sx, sm, sgt = make_distorted(cfg_1, DIST_SINGLE_CACHE,
                                 [DIST_SINGLE_SEED], [DIST_SPEED])
    frames = [(torch.from_numpy(xyz[f]).to(device),
               torch.from_numpy(mask[f]).to(device)) for f in range(N_FRAMES)]
    single = [(torch.from_numpy(sx[f, 0]).to(device),
               torch.from_numpy(sm[f, 0]).to(device))
              for f in range(N_FRAMES)]
    say(f"[data] distorted: B={B} HDL-64 streams (seeds {DIST_SEED}+b, "
        f"{DIST_SPEED:g}+0.25b m/s) and one stream (seed "
        f"{DIST_SINGLE_SEED}, {DIST_SPEED:g} m/s), accelerating at "
        f"{DIST_ACCEL:g} m/s², yaw rate {DIST_YAW_RATE:g} rad/s, "
        f"{N_FRAMES} frames (not cut), {int(mask.sum(axis=2).mean())} / "
        f"{int(sm.sum(axis=2).mean())} points/scan "
        f"({time.perf_counter() - t0:.1f} s)")
    check_distorted_kernel(pipeline, mods, dcfg_b, frames, dcfg_1, single,
                           device, results, card)
    launches = {}
    for tag, step, cfg, cfg_rigid, data, truth, batch, names, \
            ate_limit in (
                ("dist_step", pipeline.step_b, dcfg_b, cfg_b, frames, gt, B,
                 kernels.STEP_B + ("lm_fused_s",), DIST_ATE_LIMIT_B),
                ("dist_single", pipeline.step, dcfg_1, cfg_1, single, sgt,
                 1, kernels.STEP + ("lm_fused_s",), DIST_ATE_LIMIT_1)):
        k_outs, k_ms, p_outs, p_ms, got, st, peak = kernel_and_plain(
            tag, step, pipeline, mods, names, cfg, data, device, batch)
        del st            # its map tables must not count in the next peak
        launches[tag] = got
        if tag == "dist_step":
            dist = (cfg, data, k_outs)
        pose_agreement(tag, k_outs, p_outs, k_ms, p_ms, batch)
        sk, sp = float(np.mean(k_ms[1:])), float(np.mean(p_ms[1:]))
        say(f"[{tag}] frames 1-{len(data) - 1}: kernels {sk:.2f} ms/frame "
            f"= {batch * 1e3 / sk:.1f} scans/s; plain {sp:.2f} ms/frame = "
            f"{batch * 1e3 / sp:.1f} scans/s; lm_fused_s launches "
            f"{got['lm_fused_s'] / len(data):g} a frame; peak device memory "
            f"{peak / 2 ** 30:.3f} GiB (B={batch}, {card})")
        # odom.assoc / odom.handoff / odom.lm hold the slerp transforms
        say_stages(tag, stage_times(step, pipeline, cfg, data, device,
                                    batch), card)
        say_busy(tag, pipeline, cfg, data, device, batch, card)
        r_outs = run_frames(step, pipeline, cfg_rigid, data, device,
                            batch)[0]
        distortion_gates(tag, k_outs, r_outs, truth, batch, ate_limit)
    return launches["dist_step"], dist

def knn_points(map_state, cfg):
    """(queries (KNN_Q, 3), refs (KNN_M, 3), ref mask (KNN_M,), the number
    of real refs) from phase 6's map: the queries are stream 0's corner
    map points, the refs the surf map points of streams 0, 1, ... in
    turn, up to KNN_M (each stream's map lies in its own world frame,
    all starting at the origin, so they overlap as one denser cloud);
    masked rows pad too few points, repeats too few queries."""
    from aloam_tpu_torch.mapping import extract_map_cloud
    corner, surf = extract_map_cloud(map_state, cfg)
    pts = np.concatenate(surf)[:KNN_M]
    refs = np.zeros((KNN_M, 3), np.float32)
    mask = np.zeros(KNN_M, bool)
    refs[:len(pts)], mask[:len(pts)] = pts, True
    q = np.resize(corner[0].astype(np.float32), (KNN_Q, 3))
    return q, refs, mask, len(pts)


def host_ms(fn, reps: int = 5) -> float:
    """Mean host milliseconds of ``fn`` (synchronized) over ``reps`` calls
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def check_sharded_knn(tag, mesh, q, refs, mask):
    """sharded_knn over ``mesh``'s model group against the dense
    ``neighbors.knn`` on the whole refs (``parallel.dryrun``'s check: d2
    and indices equal). Returns (sharded ms, dense ms)."""
    from aloam_tpu_torch.neighbors import knn
    from aloam_tpu_torch.parallel import dryrun, model_shard, sharded_knn
    try:
        dryrun.check_sharded_knn(mesh, q, refs, mask)
    except RuntimeError as e:
        fail(f"{tag}: {e}")
    f = sharded_knn(mesh, k=5)
    r_loc, m_loc = model_shard(refs, mesh), model_shard(mask, mesh)
    return host_ms(lambda: f(q, r_loc, m_loc)), \
        host_ms(lambda: knn(q, refs, mask, 5))


POSE_KEYS = ("q_odom", "t_odom", "q_map", "t_map", "metrics")


def run_parallel(pipeline, mods, cfg, frames, outs_b, tables_b, ms_b,
                 busy_b, launches_b, knn_pts, device, card):
    """Phase 11: the sharded step and the model-axis kNN.

    (a) One rank, NCCL, a (1, 1) mesh: the captured ``batched_step_fn``
    over phase 6's 16 streams and 8 frames must give phase 6's kernel run
    bit for bit (every output, the final tables ``tables_b``), with one
    capture launching each kernel as one eager frame does and 8 replays;
    so must ``step_b`` with the TableShard of the group of one through a
    ``graph.StepGraph``, its all_reduces in the graph; the captured
    ``sharded_knn`` equal to the dense ``knn`` at Q = 4096, M = 36864 on
    phase 6's map points.
    (b) Two ranks on the one card over gloo (NCCL refuses two ranks on
    one GPU): two worker processes (``parallel_worker``) step 8 streams
    each over a (2, 1) mesh. Each rank's outputs must equal
    ``pipeline.step_b`` on its own 8 streams bit for bit, and rank 0 holds
    its kernels, at the inputs frame 1 gives them, against their plain
    versions and a second launch; the poses are held against phase 6's
    at ``pose_agreement``'s tolerance (a batch of 8 is not a batch of
    16); with the batch-dependent launch plans forced to B = 16's they
    must equal phase 6 bit for bit (and with lm_fused's alone, printed,
    they do not). Then ``sharded_knn`` over a (1, 2)
    mesh, equal to the dense knn. A worker that exits non-zero or
    outlives its time limit fails the run."""
    import functools

    import torch
    from aloam_tpu_torch import graph as gm
    from aloam_tpu_torch.ops import gridmap
    from aloam_tpu_torch.ops.gridmap import TableShard
    from aloam_tpu_torch.parallel import (batched_step_fn, distributed,
                                          make_mesh, sharded_knn)

    q, refs, mask, n_refs = knn_pts
    say(f"[parallel] kNN points from the [step] map: {KNN_Q} queries "
        f"(stream 0's corner map), {n_refs} of {KNN_M} refs real (the surf "
        f"maps of streams 0, 1, ...)")
    # (a) a world of one NCCL rank: the compiled entry points
    distributed.initialize(
        init_method=f"tcp://127.0.0.1:{distributed.free_port()}",
        world_size=1, rank=0, backend="nccl")
    try:
        mesh = make_mesh(1, 1, "cuda")
        f = batched_step_fn(cfg, mesh)
        seen = []
        gm.captures = gm.replays = 0
        with graph_spy(mods, seen):
            outs, ms, st = run_frames(lambda s, x, m, c: f(s, x, m),
                                      pipeline, cfg, frames, device)
        same_tables("[parallel] batched_step_fn", st.map, tables_b)
        del st
        same_frames("[parallel] one rank: batched_step_fn", outs, outs_b)
        if (gm.captures, gm.replays, len(seen)) != (1, N_FRAMES, 1):
            fail(f"[parallel] batched_step_fn: {gm.captures} captures, "
                 f"{gm.replays} replays")
        per_frame = {n: launches_b[n] // N_FRAMES for n in kernels.STEP_B}
        check_capture("[parallel] batched_step_fn", seen[0], per_frame,
                      kernels.STEP_B)
        say(f"[parallel] one NCCL rank, mesh (1, 1): batched_step_fn "
            f"captured once ({seen[0]['nodes']} nodes; the capture "
            f"launched {seen[0]['launches']}) and replayed {gm.replays} "
            f"times over {B} streams x {len(frames)} frames: every output "
            f"and the final tables bit-equal to [step]; "
            f"{np.mean(ms[1:]):.2f} ms/frame = "
            f"{B * 1e3 / np.mean(ms[1:]):.1f} scans/s ({card})")

        # step_b with the one rank's TableShard: its all_reduces over the
        # NCCL group of one go into the graph
        group = mesh.get_group("model")
        fs = gm.StepGraph(
            lambda s, x, m: pipeline.step_b(
                s, x, m, cfg, shard=TableShard(group, 0, 1)),
            functools.partial(pipeline.maps_at, cfg))
        collectives, group_sum = [], gridmap._group_sum

        def counted(t, shard):
            if torch.cuda.is_current_stream_capturing():
                collectives.append(t.numel() * t.element_size())
            return group_sum(t, shard)
        seen.clear()
        gm.captures = gm.replays = 0
        with graph_spy(mods, seen), \
                Patched([(gridmap, "_group_sum", counted)]):
            outs, ms, st = run_frames(lambda s, x, m, c: fs(s, x, m),
                                      pipeline, cfg, frames, device)
        same_tables("[parallel] TableShard(1 rank)", st.map, tables_b)
        del st
        same_frames("[parallel] one rank: TableShard step", outs, outs_b)
        if (gm.captures, gm.replays) != (1, N_FRAMES) or not collectives:
            fail(f"[parallel] TableShard step: {gm.captures} captures, "
                 f"{gm.replays} replays, {len(collectives)} collectives "
                 f"captured")
        check_capture("[parallel] TableShard step", seen[0], per_frame,
                      kernels.STEP_B)
        say(f"[parallel] one NCCL rank: step_b with TableShard(the group "
            f"of one, 0, 1) captured once with {len(collectives)} "
            f"all_reduces in the graph ({sum(collectives) / 1e6:.1f} MB a "
            f"frame; {seen[0]['nodes']} nodes) and replayed {gm.replays} "
            f"times: every output and the final tables bit-equal to "
            f"[step]; {np.mean(ms[1:]):.2f} ms/frame = "
            f"{B * 1e3 / np.mean(ms[1:]):.1f} scans/s ({card})")

        tq, tr, tm = (torch.from_numpy(a).to(device) for a in (q, refs, mask))
        gm.captures = gm.replays = 0
        sk, dk = check_sharded_knn("[parallel] one rank", mesh, tq, tr, tm)
        # check_sharded_knn's own call and its timed function each capture
        if gm.captures != 2:
            fail(f"[parallel] sharded_knn: {gm.captures} captures")
        eager = host_ms(lambda: sharded_knn(mesh, k=5).fn(tq, tr, tm))
        say(f"[parallel] one NCCL rank: sharded_knn (Q={KNN_Q}, M={KNN_M}, "
            f"k=5) captured and equal to the dense knn; {sk:.3f} ms a "
            f"replay, eager {eager:.3f} ms, dense {dk:.3f} ms ({card})")
        del f, fs             # their graphs go before the group
        seen.clear()
    finally:
        distributed.finish()

    # (b) two gloo ranks sharing the card
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "knn.npz"), q=q, refs=refs, mask=mask)
        ranks = run_workers("--parallel-worker", tmp, card, "[parallel]")

    def joined(run):
        return [{k: np.concatenate([rk["outs"][f"{run}.{k}_{fr}"]
                                    for rk in ranks]) for k in POSE_KEYS}
                for fr in range(len(frames))]
    pose_agreement("parallel", joined("sharded"), outs_b, ranks[0]["ms"],
                   ms_b, B, ("rank 0", "[step]"))
    # what moves a rank's 8 streams off the same streams in a batch of 16:
    # the launch plans that depend on the batch. With all of them forced
    # to B = 16's the streams must equal [step] bit for bit; lm_fused's
    # alone does not suffice (the scan's E changes with its row count)
    for run, what in (("lm16", "lm_fused's cluster plan"),
                      ("plans16", "the lm_fused, segmented_prefix_sums and "
                                  "window_mins launch plans")):
        got = joined(run)
        diff = [(fr, k, float(np.abs(got[fr][k] - outs_b[fr][k]).max()))
                for fr in range(len(frames)) for k in POSE_KEYS
                if not np.array_equal(got[fr][k], outs_b[fr][k])]
        line = (f"step_b on each rank's {B // 2} streams with {what} at "
                f"B={B}'s: " + (
                    f"bit-equal to [step] over {len(frames)} frames (poses "
                    f"and metrics)" if not diff else
                    f"differs from [step] from frame {diff[0][0]} "
                    f"({diff[0][1]} by {diff[0][2]:.3g}), max |diff| "
                    f"{max(d for *_, d in diff):.3g}"))
        if run == "plans16" and diff:
            fail(f"[parallel] {line}")
        say(f"[parallel] {line}")
    one = B * 1e3 / float(np.mean(ms_b[1:]))
    ms = [float(np.mean(rk["ms"][1:])) for rk in ranks]
    sps = [rk["local"] * 1e3 / m for rk, m in zip(ranks, ms)]
    busy = sum(rk["busy_ms"] for rk in ranks)
    for r, rk in enumerate(ranks):
        say(f"[parallel] rank {r} (streams {rk['offset']}-"
            f"{rk['offset'] + rk['local'] - 1}): {sps[r]:.1f} scans/s "
            f"({ms[r]:.2f} ms/frame over frames 1-{len(frames) - 1}), peak "
            f"device memory {rk['peak'] / 2 ** 30:.3f} GiB, launches "
            f"{rk['launches']}; its own device busy {rk['busy_ms']:.3f} ms "
            f"per frame under torch.profiler, which stretches its frame to "
            f"{rk['wall_ms']:.2f} ms (idle {100 * (1 - rk['busy_ms'] / ms[r]):.1f}% "
            f"of the {ms[r]:.2f} ms frame without it), {rk['ops']:.0f} device "
            f"operations per frame ({card})")
    say(f"[parallel] two gloo ranks on one card: {sum(sps):.1f} scans/s "
        f"together against {one:.1f} for one process at B={B} ([step]), "
        f"{sum(sps) / one:.3f}x; the card idle about "
        f"{100 * (1 - busy / max(ms)):.1f}% of the longer frame without the "
        f"profiler (both ranks' busy {busy:.3f} ms in {max(ms):.2f} ms) "
        f"against about {100 * (1 - busy_b / float(np.mean(ms_b[1:]))):.1f}% "
        f"for one process ({busy_b:.3f} ms in "
        f"{float(np.mean(ms_b[1:])):.2f} ms) ({card})")
    say(f"[parallel] two gloo ranks: sharded_knn over a (1, 2) mesh equal "
        f"to the dense knn; {ranks[0]['knn_ms']:.3f} ms a call, the local "
        f"search on {KNN_M // 2} refs {ranks[0]['local_knn_ms']:.3f} ms, the "
        f"gloo exchange (two all_gathers of ({KNN_Q}, 5) CUDA tensors) "
        f"{ranks[0]['exchange_ms']:.3f} ms; the dense knn on {KNN_M} refs "
        f"{ranks[0]['dense_ms']:.3f} ms ({card})")


def check_repeatable(mods, recorded, tag):
    """Each recorded input through its kernel twice: the outputs must be
    equal bit for bit (no kernel uses atomics)."""
    import torch

    def bits(t):
        return t.contiguous().view(torch.uint8) if torch.is_tensor(t) else t
    for (name, _), (args, kw) in recorded.items():
        kern = kernels.wrapper(name)
        a, b = (kernels.run(name, kern, args, kw) for _ in range(2))
        a, b = ((x,) if torch.is_tensor(x) else tuple(x) for x in (a, b))
        if not all(torch.equal(bits(x), bits(y)) if torch.is_tensor(x)
                   else x == y for x, y in zip(a, b)):
            fail(f"{tag}: two launches of {name} on the same inputs differ")


def scaled_plan(plan, scale: int):
    """A launch plan taking the plan of a batch ``scale`` times larger."""
    def f(rows, *args):
        return plan(rows * scale, *args)
    return f


def parallel_worker(tmp: str) -> None:
    """One rank of phase 11 (b), run as ``chip_smoke.py --parallel-worker
    <dir>`` with MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK set: this
    rank's 8 streams of the bench scene over a (2, 1) mesh with the
    kernels (8 frames, host ms per frame), the same frames through
    ``pipeline.step_b`` in this process (bit-equal), twice more with the
    batch-dependent launch plans at B = 16's, a torch.profiler run for
    its device busy time; rank 0 holds frame 1's kernel inputs against
    the plain versions and two launches; then sharded_knn over a (1, 2)
    mesh on phase 6's map points. Writes rank<r>.json and rank<r>.npz to
    ``dir``."""
    import torch
    import torch.distributed as dist
    from aloam_tpu_torch import pipeline
    from aloam_tpu_torch.neighbors import knn
    from aloam_tpu_torch.parallel import (batched_step_fn, distributed,
                                          gather_outputs, make_mesh,
                                          model_shard)

    size, rank, device, card = start_worker(tmp)
    try:
        mods = {n: kernels.module(n) for n in kernels.KERNELS}
        cfg = bench_cfg()
        xyz, mask, _ = make_streams(cfg)
        local, off = distributed.process_local_batch(B)
        frames = [(torch.from_numpy(xyz[f, off:off + local]).to(device),
                   torch.from_numpy(mask[f, off:off + local]).to(device))
                  for f in range(N_FRAMES)]
        del xyz, mask
        mesh = make_mesh(size, 1, device.type)
        # the eager sharded step: this phase records kernel inputs and
        # times eager frames (on a (2, 1) mesh, with no collective in the
        # step, batched_step_fn itself would capture)
        f = batched_step_fn(cfg, mesh).step
        kernels.reset()
        torch.cuda.reset_peak_memory_stats(device)
        dist.barrier()
        st = pipeline.init_state(cfg, local, device)
        ms, arrays = [], {}
        for fr, (x, m) in enumerate(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, out = f(st, x, m)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            for k in POSE_KEYS:
                arrays[f"sharded.{k}_{fr}"] = getattr(out, k).cpu().numpy()
        peak = torch.cuda.max_memory_allocated(device)
        launches = {n: kernels.launches(n) for n in kernels.STEP_B}
        if min(launches.values()) < 1:
            fail(f"[parallel] rank {rank}: a kernel was never launched: "
                 f"{launches}")
        # the data group's outputs in global stream order
        g = gather_outputs(out, mesh)
        if not torch.equal(g.t_map[off:off + local], out.t_map) \
                or g.t_map.shape[0] != B:
            fail(f"[parallel] rank {rank}: gather_outputs misplaces streams")
        del st

        # the sharded step is step_b on the rank's streams, bit for bit
        scale = B // local
        for run, swaps in (
                ("step_b", []),
                ("lm16", [(mods["lm_fused"], "launch_plan",
                           scaled_plan(mods["lm_fused"].launch_plan, scale))]),
                ("plans16", [(mods[n], "launch_plan",
                              scaled_plan(mods[n].launch_plan, scale))
                             for n in ("lm_fused", "segmented_prefix_sums",
                                       "window_mins")])):
            with Patched(swaps):
                outs = run_frames(pipeline.step_b, pipeline, cfg, frames,
                                  device, local)[0]
            for fr, o in enumerate(outs):
                for k in POSE_KEYS:
                    arrays[f"{run}.{k}_{fr}"] = o[k]
                    if run == "step_b" and not np.array_equal(
                            o[k], arrays[f"sharded.{k}_{fr}"]):
                        fail(f"[parallel] rank {rank}: batched_step_fn "
                             f"differs from step_b on the same streams at "
                             f"frame {fr} ({k})")
        dist.barrier()
        _, busy, wall, ops, _ = stage_busy(
            lambda s, x, m, c: f(s, x, m), pipeline, cfg, frames, device,
            local, staged=False)
        dist.barrier()
        # rank 0: the kernels at the inputs frame 1 of the sharded step
        # gives them, against their plain versions and a second launch
        if rank == 0:
            st = pipeline.init_state(cfg, local, device)
            st, _ = f(st, *frames[0])
            recorded = record_inputs(kernels.STEP_B,
                                     lambda: f(st, *frames[1]))
            del st
            check_recorded(mods, recorded, {}, card)
            check_repeatable(mods, recorded, "[parallel] rank 0")
            say(f"[parallel] rank 0: {len(recorded)} kernel inputs of the "
                f"sharded step's frame 1 ({local} streams) agree with the "
                f"plain versions; two launches on each bit-equal")

        kmesh = make_mesh(1, size, device.type)
        with np.load(os.path.join(tmp, "knn.npz")) as z:
            q, refs, rmask = (torch.from_numpy(z[k]).to(device)
                              for k in ("q", "refs", "mask"))
        dist.barrier()
        knn_ms, dense_ms = check_sharded_knn(
            f"[parallel] rank {rank}", kmesh, q, refs, rmask)
        r_loc, m_loc = model_shard(refs, kmesh), model_shard(rmask, kmesh)
        d2, idx = knn(q, r_loc, m_loc, 5)
        group = kmesh.get_group("model")

        def exchange():
            for t in (d2, idx):
                dist.all_gather([torch.empty_like(t) for _ in range(size)],
                                t, group=group)
        dist.barrier()
        exchange_ms = host_ms(exchange)
        local_knn_ms = host_ms(lambda: knn(q, r_loc, m_loc, 5))
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(dict(local=local, offset=off, ms=ms, peak=peak,
                           launches=launches, busy_ms=busy, wall_ms=wall,
                           ops=ops, knn_ms=knn_ms, dense_ms=dense_ms,
                           local_knn_ms=local_knn_ms,
                           exchange_ms=exchange_ms), fh)
        say(f"[parallel] rank {rank} of {size} (gloo, {device}): "
            f"{local} streams from {off}, {len(frames)} frames, bit-equal "
            f"to step_b on them in this process, gather_outputs in stream "
            f"order, sharded_knn equal to the dense knn")
    finally:
        distributed.finish()


def start_worker(tmp: str, backend: str = "gloo"):
    """A worker's start: the process group from the environment, the card
    of its LOCAL_RANK, and the card's description from ``tmp``. Returns
    (world size, rank, device, card)."""
    import torch
    from aloam_tpu_torch.parallel import distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(backend=backend)
    size, rank = distributed.world()
    device = torch.device(
        "cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    torch.cuda.set_device(device)
    with open(os.path.join(tmp, "card.txt")) as fh:
        return size, rank, device, fh.read()


def run_workers(flag: str, tmp: str, card: str, tag: str, n: int = 2,
                backend: str = "gloo") -> list:
    """``n`` ranks of this script (``flag <tmp> <backend>``; gloo: all on
    the first card, NCCL: card r for rank r) through
    ``parallel.distributed.spawn``; prints their output lines and returns
    each rank's rank<r>.json with its rank<r>.npz under "outs"."""
    from aloam_tpu_torch.parallel import distributed
    with open(os.path.join(tmp, "card.txt"), "w") as fh:
        fh.write(card)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    try:
        outs = distributed.spawn(
            [sys.executable, os.path.abspath(__file__), flag, tmp, backend],
            n, env, WORKER_TIMEOUT_S)
    except RuntimeError as e:
        fail(f"{tag} worker {e}")
    for out in outs:
        for line in out.splitlines():
            say(line)
    ranks = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            info = json.load(fh)
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            info["outs"] = dict(z)
        ranks.append(info)
    return ranks


def run_tables(outs_b, card, n: int = 2, backend: str = "gloo"):
    """Phase 11 (c): phase 6's 16 streams over a (1, n) mesh of ranks
    (gloo: two on the one card; NCCL: a card each), each holding 1/n of
    every map table (``table_worker``). All ranks' poses and metrics must
    equal each other and, where given, phase 6's ``outs_b`` bit for
    bit."""
    tag = f"[tables {backend} x{n}]"
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_workers("--table-worker", tmp, card, tag, n, backend)
    for fr in range(N_FRAMES):
        for k in POSE_KEYS:
            a = ranks[0]["outs"][f"{k}_{fr}"]
            for b in (rk["outs"][f"{k}_{fr}"] for rk in ranks[1:]):
                if not np.array_equal(a, b):
                    fail(f"{tag} frame {fr} {k}: the model ranks disagree "
                         f"by {np.abs(a - b).max():.3g}")
            if outs_b is not None and not np.array_equal(a, outs_b[fr][k]):
                fail(f"{tag} frame {fr} {k} differs from [step] by "
                     f"{np.abs(a - outs_b[fr][k]).max():.3g}")
    one = B * 1e3 / float(np.mean(ranks[0]["whole_ms"][1:]))
    for r, rk in enumerate(ranks):
        ms = float(np.mean(rk["ms"][1:]))
        say(f"{tag} rank {r}: {B * 1e3 / ms:.1f} scans/s "
            f"({'graphed' if rk['graphs'][0] else 'eager'}, {ms:.2f} ms/frame "
            f"over frames 1-{N_FRAMES - 1}) against {one:.1f} for step_b "
            f"with whole tables on rank 0's card in the same worker; its "
            f"tables {rk['part'] / 2 ** 20:.2f} MiB "
            f"of {rk['whole'] / 2 ** 20:.2f}; the exchanges "
            f"{rk['exchange_ms']:.3f} ms a frame ({rk['exchanges']:.0f} "
            f"collectives, {rk['exchange_bytes'] / 1e6:.1f} MB a frame), "
            f"of a {rk['timed_ms']:.2f} ms frame with them timed; peak "
            f"device memory {rk['peak'] / 2 ** 30:.3f} GiB; launches "
            f"{rk['launches']} ({card})")
    for r, rk in enumerate(ranks):
        if not rk["turns"]["graph"]:
            continue
        rate = {k: ", ".join(f"{B * 1e3 / t:.1f}" for t in v)
                for k, v in rk["turns"].items()}
        say(f"{tag} rank {r}: the captured step ({rk['graphs'][0]} capture, "
            f"{rk['graphs'][1]} replays; the capture launched "
            f"{rk['in_graph']}) bit-equal to its eager body; frames "
            f"1-{N_FRAMES - 1} in turn three times: eager {rate['eager']} "
            f"scans/s, graphed {rate['graph']} scans/s a rank ({card})")
    said = "[step] and step_b" if outs_b is not None else "step_b"
    say(f"{tag} the map tables split over {n} model ranks: {N_FRAMES} "
        f"frames of {B} streams bit-equal to {said} with whole tables on "
        f"every rank (poses and metrics), the gathered tables equal to "
        f"step_b's ({card})")


def table_worker(tmp: str, backend: str) -> None:
    """One rank of phase 11 (c), run as ``chip_smoke.py --table-worker
    <dir> <backend>`` with MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    set: phase 6's 16 streams over a (1, world) mesh, this rank holding
    1/world of every map table, with the kernels (host ms a frame; the
    launch counters must
    rise); the partition assert before and after; rank 0 runs the same
    frames through ``pipeline.step_b`` with the whole tables and compares
    the outputs and the gathered tables bit for bit; a second pass times
    every collective of the step between two synchronizes; both ranks
    drive frame 1 again while rank 0 records its ``merge_rows`` and
    ``assoc_cell`` inputs, which it holds against the plain versions and
    a second launch. Writes rank<r>.json and rank<r>.npz to ``dir``."""
    import torch
    import torch.distributed as dist
    from aloam_tpu_torch import graph as gm
    from aloam_tpu_torch import pipeline
    from aloam_tpu_torch.ops import gridmap
    from aloam_tpu_torch.parallel import (batched_init, batched_step_fn,
                                          distributed, dryrun, gather_tables,
                                          make_mesh)

    size, rank, device, card = start_worker(tmp, backend)
    tag = f"[tables {backend} x{size}]"
    try:
        mods = {n: kernels.module(n) for n in kernels.KERNELS}
        cfg = bench_cfg()
        xyz, mask, _ = make_streams(cfg)
        frames = [(torch.from_numpy(xyz[f]).to(device),
                   torch.from_numpy(mask[f]).to(device))
                  for f in range(N_FRAMES)]
        del xyz, mask
        mesh = make_mesh(1, size, device.type)
        # the compiled sharded step (captured over NCCL, eager over gloo:
        # parallel.graphed) and its eager body
        f = batched_step_fn(cfg, mesh)
        eager = f.step

        def fresh():
            st = batched_init(cfg, B, device, mesh)
            try:
                part, whole = dryrun.check_partition(st, cfg, mesh, B)
            except RuntimeError as e:
                fail(f"{tag} rank {rank}: {e}")
            return st, part, whole

        kernels.reset()
        torch.cuda.reset_peak_memory_stats(device)
        gm.captures = gm.replays = 0
        seen = []
        dist.barrier()
        st, part, whole = fresh()
        ms, arrays = [], {}
        with graph_spy(mods, seen):
            for fr, (x, m) in enumerate(frames):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, out = f(st, x, m)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                for k in POSE_KEYS:
                    arrays[f"{k}_{fr}"] = getattr(out, k).cpu().numpy()
        peak = torch.cuda.max_memory_allocated(device)
        launches = {n: kernels.launches(n) for n in kernels.STEP_B}
        if min(launches.values()) < 1:
            fail(f"{tag} rank {rank}: a kernel was never launched: "
                 f"{launches}")
        graphs = (gm.captures, gm.replays)
        if graphs != ((1, N_FRAMES) if f.capture else (0, 0)):
            fail(f"{tag} rank {rank}: {graphs[0]} captures, {graphs[1]} "
                 f"replays ({backend})")
        in_graph = seen[0]["launches"] if seen else {}
        if f.capture and min(in_graph[n] for n in kernels.STEP_B) < 1:
            fail(f"{tag} rank {rank}: the capture launched {in_graph}")
        try:
            dryrun.check_partition(st, cfg, mesh, B)
        except RuntimeError as e:
            fail(f"{tag} rank {rank} after {len(frames)} frames: {e}")
        tables = gather_tables(st, mesh).map
        own = [t.clone() for t in (*st.map.corner, *st.map.surf)] \
            if f.capture else None
        del st
        whole_ms = []
        if rank == 0:
            outs, whole_ms, st_w = run_frames(pipeline.step_b, pipeline, cfg,
                                              frames, device, B)
            for fr, o in enumerate(outs):
                for k in POSE_KEYS:
                    if not np.array_equal(o[k], arrays[f"{k}_{fr}"]):
                        fail(f"{tag} frame {fr} {k}: the split tables' step "
                             f"differs from step_b with whole tables")
            for kind in ("corner", "surf"):
                for a, b in zip(getattr(tables, kind), getattr(st_w.map,
                                                               kind)):
                    if not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)):
                        fail(f"{tag} the gathered {kind} table differs from "
                             f"step_b's whole table")
            del st_w
        del tables
        dist.barrier()

        # the captured step against its eager body: the first eager pass
        # bit-equal to the graphed one (outputs, this rank's tables), then
        # eager and graphed in turn three times
        turns = {"eager": [], "graph": []}
        for turn in range(3 if f.capture else 0):
            for name, fn in (("eager", eager), ("graph", f)):
                dist.barrier()
                st, _, _ = fresh()
                t_ms = []
                for fr, (x, m) in enumerate(frames):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st, out = fn(st, x, m)
                    torch.cuda.synchronize()
                    t_ms.append((time.perf_counter() - t0) * 1e3)
                    if turn == 0 and name == "eager" and not all(
                            same_bits(getattr(out, k).cpu().numpy(),
                                      arrays[f"{k}_{fr}"])
                            for k in POSE_KEYS):
                        fail(f"{tag} rank {rank} frame {fr}: the captured "
                             f"step differs from its eager body")
                if turn == 0 and name == "eager":
                    if not all(torch.equal(a.view(torch.int32),
                                           b.view(torch.int32))
                               for a, b in zip(
                                   (*st.map.corner, *st.map.surf), own)):
                        fail(f"{tag} rank {rank}: the captured step's table "
                             f"part differs from its eager body's")
                    own = None
                turns[name].append(float(np.mean(t_ms[1:])))
                del st
        if f.capture and gm.captures != 1:
            fail(f"{tag} rank {rank}: {gm.captures} captures after the "
                 f"turns")
        # a graph with NCCL collectives must go before its process group
        # (distributed.finish)
        f = fn = None
        seen.clear()

        # every collective of the step (gridmap._group_sum), timed
        timed = {"ms": 0.0, "n": 0, "bytes": 0}
        group_sum = gridmap._group_sum

        def timed_sum(t, shard):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            group_sum(t, shard)
            torch.cuda.synchronize()
            timed["ms"] += (time.perf_counter() - t0) * 1e3
            timed["n"] += 1
            timed["bytes"] += t.numel() * t.element_size()
            return t
        st, _, _ = fresh()
        with Patched([(gridmap, "_group_sum", timed_sum)]):
            frame_ms = []
            for x, m in frames:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = eager(st, x, m)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
        del st
        n_fr = len(frames)

        # frame 1's inputs on rank 0 of step_b's mapping kernels, whose
        # inputs change with the table partition; both ranks drive the
        # step, which exchanges rows
        st, _, _ = fresh()
        st, _ = eager(st, *frames[0])
        if rank == 0:
            recorded = record_inputs(
                [n for n in kernels.STEP_B if n not in kernels.FRONT],
                lambda: eager(st, *frames[1]))
        else:
            eager(st, *frames[1])
        del st
        if rank == 0:
            check_recorded(mods, recorded, {}, card)
            check_repeatable(mods, recorded, f"{tag} rank 0")
            say(f"{tag} rank 0: {len(recorded)} merge_rows / assoc_cell / "
                f"evict_and_count inputs of the split step's frame 1 agree "
                f"with the plain versions; two launches on each bit-equal")
        dist.barrier()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(dict(ms=ms, whole_ms=whole_ms, peak=peak,
                           launches=launches, graphs=graphs,
                           in_graph=in_graph, turns=turns, part=part,
                           whole=whole, exchange_ms=timed["ms"] / n_fr,
                           exchanges=timed["n"] / n_fr,
                           exchange_bytes=timed["bytes"] / n_fr,
                           timed_ms=float(np.mean(frame_ms[1:]))), fh)
        say(f"{tag} rank {rank} of {size} ({backend}, {device}): {B} "
            f"streams, 1/{size} of every map table, {n_fr} frames; the "
            f"partition holds")
    finally:
        distributed.finish()


def tables_main(n: int) -> None:
    """``chip_smoke.py --tables <n>``: phase 11 (c) alone over NCCL, one
    card a rank, on n cards: the kernels built, the bench streams made,
    then ``run_tables`` over a (1, n) mesh."""
    import torch
    from aloam_tpu_torch.ops import _build
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        fail(f"--tables {n}: needs {n} CUDA cards")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    cards = smi.stdout.strip().splitlines()
    for line in cards:
        say(line)
    _build.build()
    make_streams(bench_cfg())
    run_tables(None, f"{len(cards)} x {cards[0]}", n, "nccl")


# ---- 12. the compiled step: CUDA graphs of step_b and step ---------------

def graph_nodes(g) -> int:
    """Nodes of a captured graph (``graph.StepGraph`` keeps the
    cudaGraph_t), counted by the CUDA driver's cuGraphGetNodes."""
    import ctypes
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        fail(f"cuGraphGetNodes: CUDA driver error {err}")
    return n.value


def pool_mib(g) -> float | None:
    """MiB of the caching allocator's segments in a graph's private pool,
    or None where the allocator's snapshot names no segment of it."""
    import torch
    pool = tuple(g.pool())
    sizes = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
             if tuple(seg.get("segment_pool_id", ())) == pool]
    return sum(sizes) / 2 ** 20 if sizes else None


def graph_spy(mods, seen: list):
    """A with-block in which every capture of ``graph.StepGraph`` appends
    to ``seen`` the kernel launches its body made while the stream was
    capturing, the ``Captured`` record, its node count and its frames."""
    import torch
    from aloam_tpu_torch import graph as gm
    body, capture = gm.StepGraph._body, gm.StepGraph._capture

    def spy_body(self, slot, frame0):
        before = kernels.counts()
        out = body(self, slot, frame0)
        if torch.cuda.is_current_stream_capturing():
            seen.append({"launches": {n: kernels.launches(n) - before[n]
                                      for n in kernels.KERNELS}})
        return out

    def spy_capture(self, slot, frame0, pattern):
        cap = capture(self, slot, frame0, pattern)
        seen[-1].update(captured=cap, nodes=graph_nodes(cap.graph),
                        frames=len(pattern), pool_mib=pool_mib(cap.graph))
        return cap
    return Patched([(gm.StepGraph, "_body", spy_body),
                    (gm.StepGraph, "_capture", spy_capture)])


def stepped(fn, pipeline, cfg, data, device, batch):
    """``fn(state, xyz, mask)`` over the frames from a fresh state: (the
    outputs of every frame, kept on the device, and the final state)."""
    import torch
    st = pipeline.init_state(cfg, batch, device)
    outs = []
    for xyz, mask in data:
        st, out = fn(st, xyz, mask)
        outs.append(out)
    torch.cuda.synchronize()
    return outs, st


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def same_outputs(tag, outs, ref) -> None:
    """Every output of every frame (device SlamOutputs) bit-equal to the
    reference run's (run_frames' host dicts, or SlamOutputs)."""
    for f, (o, r) in enumerate(zip(outs, ref, strict=True)):
        r = r if isinstance(r, dict) else {
            k: v.cpu().numpy() for k, v in r._asdict().items()
            if v is not None}
        for k, want in r.items():
            got = getattr(o, k)
            if got is None or not same_bits(got.cpu().numpy(), want):
                fail(f"[graph] {tag}: frame {f} {k} is not bit-equal to the "
                     f"eager run")


def same_tables(tag, map_state, want) -> None:
    """The map tables of a state bit-equal to ``want`` (corner, surf)."""
    import torch
    for got, ref in zip((*map_state.corner, *map_state.surf),
                        (*want[0], *want[1]), strict=True):
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            fail(f"{tag}: the final map tables are not bit-equal to the "
                 f"eager run's")


def same_frames(tag, outs, ref) -> None:
    """Every output of every frame of two run_frames runs bit-equal."""
    for f, (o, r) in enumerate(zip(outs, ref, strict=True)):
        if o.keys() != r.keys() or not all(same_bits(o[k], r[k]) for k in r):
            fail(f"{tag}: frame {f} is not bit-equal to the eager run")


def check_capture(tag, rec, want, names) -> None:
    """A capture's body launched every kernel of ``names``, each as often
    as one eager frame (``want``), times its frames."""
    got = {n: rec["launches"][n] for n in names}
    per = {n: want[n] * rec["frames"] for n in names}
    if got != per or min(got.values()) < 1:
        fail(f"[graph] {tag}: the capture launched {got}, eager frames "
             f"{per}")


def run_graph(pipeline, mods, cfg, frames, outs_b, tables_b, cfg_1, single,
              outs_1, tables_1, dist, device, card):
    """Phase 12: the compiled step, ``graph.StepGraph`` behind
    ``parallel.batched_step_jit``, ``pipeline.make_step_fn`` and
    ``pipeline.run_sequence(scan=True)``.

    (a) One eager frame of step_b (B = 16) and one of step under
    ``torch.cuda.set_sync_debug_mode("error")``: no host synchronization
    (a capture needs none); their launches a frame. (b) The graphed
    step_b over phase 6's 16 streams and 8 frames: every output of every
    frame and the final tables bit-equal to phase 6's eager kernel run;
    one capture whose body launched each kernel as one eager frame does,
    8 replays. (c) The graphed step over phase 8's frames, bit-equal to
    phase 8; then 4 frames at mapping_skip_frame 2 (two graphs, one a
    gate branch) bit-equal to the eager step at that config. (d)
    ``run_sequence(scan=True)`` over the same 8 frames: one graph of 8
    frames, one replay, bit-equal to (c); its capture and instantiate
    ms, node count and peak memory. (e) The distorted step_b graphed over
    4 of phase 10's frames, bit-equal to phase 10's eager run. ((f), the
    CLI through the graphed step, is phase 9.)"""
    import torch
    from aloam_tpu_torch import graph as gm
    from aloam_tpu_torch import parallel
    t_phase = time.perf_counter()
    dcfg_b, dframes, d_outs = dist

    # (a) no host synchronization on an eager frame
    per_frame, peak_1 = {}, 0
    for tag, step, c, data, batch in (
            ("step_b", pipeline.step_b, cfg, frames, B),
            ("step", pipeline.step, cfg_1, single, 1)):
        st = pipeline.init_state(c, batch, device)
        st, _ = step(st, *data[0], c)
        torch.cuda.synchronize()
        kernels.reset()
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, _ = step(st, *data[1], c)
        except RuntimeError as e:
            fail(f"[graph] an eager frame of {tag} synchronizes with the "
                 f"host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        peak_1 = torch.cuda.max_memory_allocated(device)
        per_frame[tag] = kernels.counts()
        del st
    say(f"[graph] (a) one eager frame of step_b (B={B}) and of step under "
        f"set_sync_debug_mode('error'): no host synchronization; launches "
        f"a frame {per_frame}")

    # (b) the graphed step_b
    seen = []
    gm.captures = gm.replays = 0
    with graph_spy(mods, seen):
        outs, st = stepped(parallel.batched_step_jit(cfg), pipeline, cfg,
                           frames, device, B)
    same_outputs("step_b", outs, outs_b)
    same_tables("[graph] step_b", st.map, tables_b)
    del st
    if (gm.captures, gm.replays, len(seen)) != (1, N_FRAMES, 1):
        fail(f"[graph] step_b: {gm.captures} captures, {gm.replays} replays")
    check_capture("step_b", seen[0], per_frame["step_b"], kernels.STEP_B)
    rec = seen[0]
    say(f"[graph] (b) batched_step_jit over {B} streams x {N_FRAMES} frames: "
        f"one capture ({rec['captured'].capture_ms:.1f} ms, instantiate "
        f"{rec['captured'].instantiate_ms:.1f} ms, {rec['nodes']} nodes, "
        f"pool {rec['pool_mib']} MiB), {gm.replays} replays; outputs of "
        f"every frame and the final tables bit-equal to [step]; the capture "
        f"launched {rec['launches']}")

    # (c) the graphed step, then two gate branches
    seen.clear()
    gm.captures = gm.replays = 0
    with graph_spy(mods, seen):
        outs_c, st_c = stepped(pipeline.make_step_fn(cfg_1), pipeline,
                               cfg_1, single, device, 1)
    same_outputs("step", outs_c, outs_1)
    same_tables("[graph] step", st_c.map, tables_1)
    check_capture("step", seen[0], per_frame["step"], kernels.STEP)
    rec = seen[0]
    c2 = cfg_1.replace(mapping_skip_frame=2)
    want2 = run_frames(pipeline.step, pipeline, c2, single[:4], device, 1)
    fn2 = pipeline.make_step_fn(c2)
    outs2, st2 = stepped(fn2, pipeline, c2, single[:4], device, 1)
    same_outputs("step at mapping_skip_frame 2", outs2, want2[0])
    same_tables("[graph] step at mapping_skip_frame 2", st2.map,
                (want2[2].map.corner, want2[2].map.surf))
    n_graphs = [len(slot.graphs) for slot in fn2.slots.values()]
    if n_graphs != [2]:
        fail(f"[graph] step at mapping_skip_frame 2: graphs {n_graphs}")
    del want2, st2
    say(f"[graph] (c) make_step_fn over one stream x {N_FRAMES} frames: one "
        f"capture ({rec['captured'].capture_ms:.1f} ms, instantiate "
        f"{rec['captured'].instantiate_ms:.1f} ms, {rec['nodes']} nodes, "
        f"pool {rec['pool_mib']} MiB), bit-equal to [single]; "
        f"mapping_skip_frame 2 over 4 frames: two graphs (map, skip), "
        f"bit-equal to the eager step")

    # (d) one graph of the whole sequence
    seen.clear()
    xs = torch.stack([x for x, _ in single])
    ms_ = torch.stack([m for _, m in single])
    gm.captures = gm.replays = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    with graph_spy(mods, seen):
        st_d, outs_d = pipeline.run_sequence(
            pipeline.init_state(cfg_1, 1, device), xs, ms_, cfg_1, scan=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    if (gm.captures, gm.replays) != (1, 1):
        fail(f"[graph] run_sequence(scan=True): {gm.captures} captures, "
             f"{gm.replays} replays")
    same_outputs("run_sequence(scan=True)", [
        pipeline.SlamOutputs(*(None if o is None else o[f] for o in outs_d))
        for f in range(N_FRAMES)], outs_c)
    same_tables("[graph] run_sequence(scan=True)", st_d.map,
                (st_c.map.corner, st_c.map.surf))
    check_capture("run_sequence(scan=True)", seen[0], per_frame["step"],
                  kernels.STEP)
    rec = seen[0]
    del st_d, st_c, outs_c
    say(f"[graph] (d) run_sequence(scan=True) over {N_FRAMES} frames: one "
        f"graph of {rec['frames']} frames, one replay, bit-equal to (c); "
        f"capture {rec['captured'].capture_ms:.1f} ms, instantiate "
        f"{rec['captured'].instantiate_ms:.1f} ms, {rec['nodes']} nodes, "
        f"pool {rec['pool_mib']} MiB; peak device memory of the call "
        f"{peak / 2 ** 30:.3f} GiB above its start (one eager frame of "
        f"step: {peak_1 / 2 ** 30:.3f} GiB in all) ({card})")

    # (e) the distorted step_b
    seen.clear()
    with graph_spy(mods, seen):
        outs_e, st_e = stepped(parallel.batched_step_jit(dcfg_b), pipeline,
                               dcfg_b, dframes[:4], device, B)
    del st_e
    same_outputs("distorted step_b", outs_e, d_outs[:4])
    if seen[0]["launches"]["lm_fused_s"] < 1:
        fail("[graph] the distorted step_b's capture never launched "
             "lm_fused_s")
    say(f"[graph] (e) batched_step_jit at distortion=True over {B} streams x "
        f"4 frames: bit-equal to [dist_step]; the capture launched "
        f"{seen[0]['launches']} ({seen[0]['nodes']} nodes)")

    say(f"[graph] phase 12 took {time.perf_counter() - t_phase:.1f} s")


def run_module(module: str, args: list, env: dict, timeout: float) -> str:
    """``python -m module args`` from the repository root with ``env``: its
    standard output. A non-zero exit, or a run past ``timeout`` seconds
    (the child is killed then), fails the run."""
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        p = subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                           env=env, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired as e:
        out = e.stdout or b""          # bytes, even with text=True
        out = out.decode(errors="replace") if isinstance(out, bytes) else out
        fail(f"{module} still running after {timeout:g} s\n{out[-2000:]}")
    if p.returncode:
        fail(f"{module} exited {p.returncode}\n{p.stdout[-2000:]}\n"
             f"{p.stderr[-4000:]}")
    return p.stdout


def check_preset_rung(pipeline, mods, cfg, frames, gt, device, results,
                      card):
    """Phase 13, first part: the bench's preset rung in this process,
    ``step_b`` at ``PRESETS["HDL-64"]``'s caps (the bench's
    map_query_chunk) over phase 3's B = 16 streams, padded to the preset's
    n_raw. Its launches are counted from 0 over the frames (each of
    step_b's eight kernels must launch), its kernels held against their
    plain versions at the inputs its frame 1 gives them, as phase 4 holds
    them at the bench config, and its ATE as phase 6's. Returns the
    launches."""
    import torch
    from aloam_tpu_torch.config import PRESETS
    pcfg = PRESETS["HDL-64"].replace(map_query_chunk=cfg.map_query_chunk)
    pad = pcfg.n_raw - cfg.n_raw
    pframes = [(torch.cat([x, x.new_zeros(B, pad, 3)], 1),
                torch.cat([m, m.new_zeros(B, pad)], 1)) for x, m in frames]
    t0 = time.perf_counter()
    kernels.reset()
    st = pipeline.init_state(pcfg, B, device)
    st, out = pipeline.step_b(st, *pframes[0], pcfg)
    outs, box = [to_host(out)], {}

    def frame1():
        box["st"], box["out"] = pipeline.step_b(st, *pframes[1], pcfg)

    recorded = record_inputs(kernels.STEP_B, frame1)
    st, outs = box["st"], outs + [to_host(box["out"])]
    for xyz, mask in pframes[2:]:
        st, out = pipeline.step_b(st, xyz, mask, pcfg)
        outs.append(to_host(out))
    launches = {n: kernels.launches(n) for n in kernels.STEP_B}
    say(f"[preset] step_b at PRESETS['HDL-64'] (ring_cap {pcfg.ring_cap}, "
        f"n_raw {pcfg.n_raw}, less_flat_cap {pcfg.less_flat_cap}, "
        f"assoc_cspan {pcfg.assoc_cspan}), B={B}: kernel launches over "
        f"{len(pframes)} frames: {launches} "
        f"({time.perf_counter() - t0:.1f} s)")
    if min(launches.values()) < 1:
        fail(f"a kernel of the preset rung was never launched: {launches}")
    del st
    ate_check("preset", outs, gt, B)
    check_recorded(mods, recorded, results, card)
    return launches


def run_bench(kind: str, card: str) -> dict:
    """Phase 13, second part: the port's bench, ``python -m
    aloam_tpu_torch.bench``, at ``BENCH_ENV`` after its scenes are made;
    its line held to ``BENCH_KEYS`` exactly, a positive rate, ATEs under
    0.5 m (a broken path, as phase 6) and phase 1's device name; each of
    its three runs (one stream, B = 16, the preset rung) must launch
    every kernel of its path. Returns the launches summed over them."""
    t0 = time.perf_counter()
    env = dict(os.environ, **BENCH_ENV)
    run_module("aloam_tpu_torch.pregen_streams", [], env, PREGEN_TIMEOUT_S)
    say(f"[bench] scenes ready ({time.perf_counter() - t0:.1f} s)")
    lines = run_module("aloam_tpu_torch.bench", [], env,
                       BENCH_TIMEOUT_S).strip().splitlines()
    launches, runs = dict.fromkeys(kernels.KERNELS, 0), 0
    for line in lines[:-1]:
        say(line)
        if " kernel launches {" not in line:
            continue
        counts = json.loads(line.split(" kernel launches ", 1)[1])
        need = kernels.STEP if "one stream" in line else kernels.STEP_B
        if min(counts[n] for n in need) < 1:
            fail(f"bench: a kernel of its path was never launched: {line}")
        runs += 1
        for n, c in counts.items():
            launches[n] += c
    if runs != 3:
        fail(f"bench: {runs} runs reported their launches, not 3")
    r = json.loads(lines[-1])
    if set(r) != BENCH_KEYS:
        fail(f"bench: keys {sorted(set(r) ^ BENCH_KEYS)} differ from "
             f"bench.py's")
    ates = {k: r[k] for k in ("ate_rmse_m", "ate_batched_max_m",
                              "ate_batched_med_m", "ate_preset_max_m")}
    if not r["value"] > 0 or max(ates.values()) >= 0.5:
        fail(f"bench: value {r['value']}, ATE {ates}")
    if r["device_kind"] != kind:
        fail(f"bench: device_kind {r['device_kind']!r}, phase 1 {kind!r}")
    say(f"[bench] {json.dumps(r)}")
    say(f"[bench] phase 13 took {time.perf_counter() - t0:.1f} s ({card})")
    return launches


def drift_kernels(pipeline, mods, cfg, frames, device, results, card):
    """Phase 14 (b): each path's kernels against their plain versions at
    the inputs frame 1 of the drift scene gives them (16 rings, ring_cap
    512: launch plans no other phase reaches), as phase 4 does."""
    for tag, step, names, batched in (
            ("step", pipeline.step, kernels.STEP, False),
            ("step_b", pipeline.step_b, kernels.STEP_B, True)):
        data = [(x[None], m[None]) if batched else (x, m)
                for x, m in frames[:2]]
        st = pipeline.init_state(cfg, 1, device)
        st, _ = step(st, *data[0], cfg)
        recorded = record_inputs(names,
                                 lambda: step(st, *data[1], cfg))
        del st
        say(f"[drift] (b) {tag}'s kernels at the drift scene's frame-1 "
            f"inputs:")
        check_recorded(mods, recorded, results, card)


def drift_graph_equal(pipeline, cfg, frames, device) -> None:
    """Phase 14 (c): the graphed step and step_b (B = 1) over ``frames``
    (the first DRIFT_EQUAL_FRAMES), bit-equal to the eager ones."""
    from aloam_tpu_torch import parallel
    batched = [(x[None], m[None]) for x, m in frames]
    for tag, eager, fn, data in (
            ("step", pipeline.step, pipeline.make_step_fn(cfg), frames),
            ("step_b", pipeline.step_b, parallel.batched_step_jit(cfg),
             batched)):
        want, _, st = run_frames(eager, pipeline, cfg, data, device, 1)
        outs, st_g = stepped(fn, pipeline, cfg, data, device, 1)
        same_outputs(f"drift {tag}", outs, want)
        same_tables(f"[drift] {tag}", st_g.map, (st.map.corner, st.map.surf))
        del st, st_g
    say(f"[drift] (c) make_step_fn and batched_step_jit (B = 1) over frames "
        f"0-{DRIFT_EQUAL_FRAMES - 1}: every output and the final tables "
        f"bit-equal to the eager step and step_b")


def drift_path(mods, tag, names, scans, traj, ref, device, card):
    """Phase 14 (d) / (e): one path graphed over the whole scene, its
    launch counters set to 0 just before and read just after (each must
    rise), its figures printed and held to ``drift.gates``. Returns the
    launches."""
    import torch
    from aloam_tpu_torch import drift
    from aloam_tpu_torch import graph as gm
    batched = tag == "step_b"
    seen = []
    kernels.reset()
    gm.captures = gm.replays = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with graph_spy(mods, seen):
        res = drift.run(drift.DRIFT_CFG, scans, device, batched=batched)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    launches = kernels.counts()
    if min(launches[n] for n in names) < 1:
        fail(f"[drift] a kernel of the {tag} path was never launched: "
             f"{launches}")
    if (gm.captures, gm.replays, len(seen)) != (1, len(scans), 1):
        fail(f"[drift] {tag}: {gm.captures} captures, {gm.replays} replays")
    on_card = {n: seen[0]["launches"][n] * gm.replays for n in names}
    s = drift.summary(res, traj, ref, batched)
    say(f"[drift] {tag}: {s['n_frames']} frames graphed in {secs:.1f} s (the "
        f"scans' upload and the capture included; one capture, "
        f"{gm.replays} replays); counted launches (warm-up and capture) "
        f"{ {n: launches[n] for n in names} }, on the card through the "
        f"replays {on_card}; peak device memory {peak / 2 ** 30:.3f} GiB "
        f"(the {len(scans)} padded scans on the card included) ({card})")
    say(f"[drift] {tag}: over {s['n_frames']} frames drift "
        f"{s['run_drift_pct']} % ({s['run_segments']} segments), ATE "
        f"{s['run_ate_m']} m, odometry drift {s['odom_drift_pct']} %, "
        f"map_solved {s['map_solved']}; JAX on the CPU (reference file): "
        f"drift {s['jax_drift_pct']} %, ATE {s['jax_ate_m']} m, largest "
        f"gap to its mapped position {s['max_engine_jax_gap_m']} m")
    say(f"[drift] {tag}: over the first {s['oracle_frames']} frames drift "
        f"{s['engine_drift_pct']} % against the f64 oracle's "
        f"{s['oracle_drift_pct']} %: ratio {s['engine_over_oracle']} (limit "
        f"{drift.oracle_limit(s['jax_over_oracle'])}; JAX's own "
        f"{s['jax_over_oracle']}); ATE {s['engine_ate_m']} m, oracle "
        f"{s['oracle_ate_m']} m")
    for i, end in enumerate(s["blocks"]):
        lo = res["blocks"][i]["frames"][0]
        corner, surf = s["occupancy"][i]
        ms = s["ms_per_scan"][i]
        say(f"[drift] {tag} frames {lo}-{end - 1}: occupancy corner "
            f"{corner:.4f} surf {surf:.4f}, map_overflow "
            f"{s['map_overflow'][i]:.0f}, map_evicted "
            f"{s['map_evicted'][i]:.0f}, largest gap to JAX "
            f"{s['jax_gap_m'][i]:.4f} m, graphed "
            + ("not measured" if ms is None else f"{ms:.3f} ms/scan")
            + f" ({card})")
    say(f"[drift] {tag} " + json.dumps(s))
    fails = drift.gates(s)
    if fails:
        fail(f"[drift] {tag}: " + "; ".join(fails))
    return {n: launches[n] for n in kernels.KERNELS}


def run_drift(pipeline, mods, device, results, card) -> dict:
    """Phase 14: the long-horizon run (``aloam_tpu_torch.drift``). (a) The
    500-frame drift scene, rendered or read from ``.bench_cache/``;
    (b) each path's kernels at its frame-1 inputs; (c) graphed against
    eager over the first frames; (d) ``make_step_fn`` and (e)
    ``batched_step_jit`` at B = 1 over all 500 frames, held to
    tests/test_long_drift.py's gates and to the reference trajectories of
    JAX and the f64 oracle (``tests/_torch_drift_ref.npz``). Returns the
    launches of each path."""
    from aloam_tpu_torch import drift
    t_phase = time.perf_counter()
    cfg = drift.DRIFT_CFG
    traj, scans = drift.render_scene(drift.N_FRAMES)
    frames = drift.device_frames(cfg, scans[:DRIFT_EQUAL_FRAMES], device)
    say(f"[drift] (a) the drift scene: {len(scans)} frames, VLP-16 at 256 "
        f"azimuth steps, {np.mean([len(s) for s in scans]):.0f} points a "
        f"scan, {drift.SPEED * 0.1:g} m a frame; n_raw {cfg.n_raw}, "
        f"ring_cap {cfg.ring_cap}, tables {cfg.map_table_corner} x "
        f"{cfg.map_bucket_corner} / {cfg.map_table_surf} x "
        f"{cfg.map_bucket_surf} ({time.perf_counter() - t_phase:.1f} s)")
    with np.load(drift.REF) as z:
        ref = dict(z)
    drift_kernels(pipeline, mods, cfg, frames, device, results, card)
    drift_graph_equal(pipeline, cfg, frames, device)
    del frames
    by_path = {f"drift_{tag}": drift_path(mods, tag, names, scans, traj,
                                          ref, device, card)
               for tag, names in (("step", kernels.STEP),
                                  ("step_b", kernels.STEP_B))}
    took = time.perf_counter() - t_phase
    say(f"[drift] phase 14 took {took:.1f} s ({card})")
    return by_path


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
    mods = {n: kernels.module(n) for n in kernels.KERNELS}
    results = check_kernels(pipeline, mods, cfg, frames, device, card)
    check_adversarial(mods, device, results, card)
    check_adversarial_assoc(mods, device, results, card)
    check_adversarial_lm(mods, device, results, card)
    check_adversarial_select(mods, device, card)
    check_adversarial_merge(mods, device, card)
    check_stamp(device, card)
    check_gather(device, card)
    check_evict(device, card)
    run_front(pipeline, mods, cfg, frames[:N_FRONT], device, card)
    launches, st_b, outs_b, ms_b, busy_b = run_step(pipeline, mods, cfg, frames, gt,
                                            device, card)
    knn_pts = knn_points(st_b.map, cfg)
    tables_b = (st_b.map.corner, st_b.map.surf)

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
    launches["knn_select_rows"] = check_single_kernels(
        pipeline, mods, cfg, st_b.map, st_b.odom, cfg_1, single, device,
        results, card)
    del st_b
    check_adversarial_knn(mods, device, results, card)
    single_launches, outs_1, tables_1 = run_single(
        pipeline, mods, cfg_1, single, sgt, device, card)
    launches["knn_select"] = single_launches["knn_select"]
    run_cli(device, card)

    # ---- 10. the distortion path ------------------------------------------
    dist_launches, dist = run_distortion(pipeline, mods, cfg, cfg_1, device,
                                         results, card)
    launches["lm_fused_s"] = dist_launches["lm_fused_s"]

    # ---- 11. streams and the kNN split over torch.distributed ranks -------
    run_parallel(pipeline, mods, cfg, frames, outs_b, tables_b, ms_b,
                 busy_b, launches, knn_pts, device, card)
    run_tables(outs_b, card)

    # ---- 12. the compiled step: CUDA graphs -------------------------------
    run_graph(pipeline, mods, cfg, frames, outs_b, tables_b, cfg_1, single,
              outs_1, tables_1, dist, device, card)

    # ---- 13. the preset rung, the port's bench ----------------------------
    by_path = {"preset_rung": check_preset_rung(
        pipeline, mods, cfg, frames, gt, device, results, card),
        "bench": run_bench(kind, card)}

    # ---- 14. the long-horizon run -----------------------------------------
    by_path.update(run_drift(pipeline, mods, device, results, card))

    entries = [dict(name=name, route="cuda", source=spec.source,
                    replaces=spec.replaces, launches=launches[name],
                    max_abs_err=results[name]["max_abs_err"],
                    ms=results[name]["ms"],
                    device_ms=results[name]["device_ms"],
                    plain_ms=results[name]["plain_ms"],
                    bound_ms=results[name]["bound_ms"],
                    bound_by=results[name]["bound_by"],
                    # the library's flat[gidx] for the row gather; no one
                    # PyTorch call computes any of the other functions
                    library_ms=results[name].get("library_ms"),
                    launches_by_path={p: n.get(name, 0)
                                      for p, n in by_path.items()})
               for name, spec in kernels.KERNELS.items()]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--table-worker"]:
        table_worker(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--tables"]:
        tables_main(int(sys.argv[2]))
    else:
        main()
