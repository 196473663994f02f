"""Benchmark of the port: the whole SLAM step (registration, odometry,
mapping) on synthetic HDL-64 scans, one CUDA card. Prints ONE JSON line,
with the keys of the JAX package's ``bench.py`` (its ``BENCH_r05.json``
record) but ``step_gflops`` and ``mfu_pct``:

    python -m aloam_tpu_torch.pregen_streams   # the scenes, once
    python -m aloam_tpu_torch.bench

The headline, ``value``, is aggregate scans/s over B independent streams
stepped by the captured ``parallel.batched_step_jit`` (``pipeline.step_b``
as a CUDA graph); ``ms_per_scan_single`` is one stream through the
captured ``pipeline.make_step_fn``. Mirrors ``bench.py`` function by
function and imports nothing of it; its ``BENCH_STAGES`` stage times are
left out: the port's spans (``spans.py``) time each stage inside the
compiled step.

``vs_baseline`` is relative to the reference's real-time design point of
10 scans/s (scanPeriod 0.1 s, scanRegistration.cpp:60), ``vs_target`` to
500 scans/s per card (BASELINE.md). The step runs no model, so there are
no FLOPs and no MFU.

Env knobs, with bench.py's defaults: BENCH_BATCH (streams, default 32,
with 16 on the ladder too; 0 = one stream only), BENCH_FRAMES (timed
frames of the one stream, 16), BENCH_BATCH_FRAMES (timed frames of the
batched streams, 32), BENCH_AZIMUTH (azimuth steps a ring, 1800),
BENCH_BLOCKS (timed blocks, 3),
BENCH_PRESET_RUNG=0 (skips the run at the untrimmed HDL-64 preset caps),
BENCH_QCHUNK (``map_query_chunk``, 2048).

Before any number is printed every CUDA kernel runs on the card against
its plain PyTorch version (:func:`verify_kernels`), and before each
batched run the step's kernels do so again at the inputs that run gives
them (:func:`verify_rung`); a disagreement, or a failure of any run other
than an out-of-memory one, fails the run.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from aloam_tpu_torch import graph, parallel, pipeline
from aloam_tpu_torch.config import PRESETS
from aloam_tpu_torch.eval import ate_rmse
from aloam_tpu_torch.io import synthetic as syn
from aloam_tpu_torch.ops import (assoc, insert, kernels, knn, lm, odom,
                                 select, voxel)

_AZ = int(os.environ.get("BENCH_AZIMUTH", "1800"))
_N_BLOCKS = int(os.environ.get("BENCH_BLOCKS", "3"))
# the scene cache (gitignored), shared with chip_smoke.py's own files
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_cache")


def _cached_sequence(n_frames, seed, speed):
    """(xyz (F, n_raw, 3), mask (F, n_raw), gt (F, 3)) of one synthetic
    HDL-64 stream padded to the preset's n_raw: raytraced on the host
    (~0.3 s a frame), so cached on disk by shape, seed and speed, written
    to a temporary file first so that a reader never sees half of one."""
    cfg = PRESETS["HDL-64"]
    path = os.path.join(CACHE_DIR, f"torch_bench_hdl64_a{_AZ}_f{n_frames}_"
                        f"s{seed}_v{speed:g}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["xyz"], z["mask"], z["gt"]
    scans, traj = syn.make_sequence(n_frames, scan_lines=64, n_azimuth=_AZ,
                                    seed=seed, speed=speed)
    xyz = np.zeros((n_frames, cfg.n_raw, 3), np.float32)
    mask = np.zeros((n_frames, cfg.n_raw), bool)
    for i, s in enumerate(scans):
        xyz[i], mask[i] = syn.pad_scan(s, cfg.n_raw)
    gt = (traj.trans - traj.trans[0]).astype(np.float32)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp.npz"
    np.savez(tmp, xyz=xyz, mask=mask, gt=gt)
    os.replace(tmp, path)
    return xyz, mask, gt


def batched_bench_cfg(base=None):
    """The batched bench config: ``PRESETS["HDL-64"]`` sized to the bench
    scene's sensor. The synthetic HDL-64 fires exactly BENCH_AZIMUTH steps
    a ring, so ring_cap = BENCH_AZIMUTH + 56 and n_raw = 64 · BENCH_AZIMUTH
    rounded up to 512 never overflow; less_flat_cap 36864 holds the scene's
    measured occupancy (30536 at B = 16) with a margin; assoc_cspan 128
    clips the association's per-tile cell window (spills counted in
    overflow); map_query_chunk from BENCH_QCHUNK. The preset keeps its
    caps for real KITTI scans (the preset rung)."""
    base = base if base is not None else PRESETS["HDL-64"]
    return base.replace(
        map_query_chunk=int(os.environ.get("BENCH_QCHUNK", "2048")),
        ring_cap=_AZ + 56, n_raw=-(-64 * _AZ // 512) * 512,
        less_flat_cap=36864, assoc_cspan=128)


def _stream_speed(b: int) -> float:
    """Stream b's speed, at most 8.94 m/s (0.9 m a frame at 10 Hz against
    the 1.0 m map NN gate): 5 + 0.25 b for b < 16, then blocks of 16 with
    offsets between the rungs' speeds (the offsets repeat with period 48;
    the worlds stay distinct by seed)."""
    if b < 16:
        return 5.0 + 0.25 * b
    blk, off = divmod(b - 16, 16)
    extra = (0.125, 0.0625, 0.1875)[blk % 3]
    return 5.0 + 0.25 * off + extra


def load_streams(cfg, batch, n_frames):
    """``batch`` cached streams (seed 100 + b) fitted to ``cfg``: (xyz (F,
    B, n_raw, 3), mask (F, B, n_raw), gt (B, F, 3)). The cached scans are
    padded to the preset's n_raw with the points at the head, so a smaller
    capacity loses nothing (checked)."""
    streams = [_cached_sequence(n_frames, 100 + b, _stream_speed(b))
               for b in range(batch)]
    xyz = np.stack([s[0] for s in streams], axis=1)
    mask = np.stack([s[1] for s in streams], axis=1)
    gt = np.stack([s[2] for s in streams])
    if xyz.shape[2] != cfg.n_raw:
        if mask[:, :, cfg.n_raw:].any():
            raise ValueError(f"a scan holds more than n_raw {cfg.n_raw}")
        xyz, mask = xyz[:, :, :cfg.n_raw], mask[:, :, :cfg.n_raw]
    return xyz, mask, gt


def ladder(batch: int) -> list:
    """The batch sizes the bench measures, largest first: BENCH_BATCH and
    16, none above BENCH_BATCH. Where 32 tops it, B = 64 is probed too
    (:func:`main`)."""
    return sorted({batch, 16} & set(range(1, batch + 1)), reverse=True)


def _blocks(n: int, n_blocks: int = _N_BLOCKS) -> list:
    """(start, stop) of each timed block over n frames: n // n_blocks
    frames a block (at least 1), the remainder folded into the last."""
    per_block = max(1, n // n_blocks)
    out, i = [], 0
    while i < n:
        stop = i + per_block if i + 2 * per_block <= n else n
        out.append((i, stop))
        i = stop
    return out


def _time_blocks(step, state, dev_frames, n_blocks=_N_BLOCKS):
    """Run ``step`` over frames already on the device in timed blocks
    (:func:`_blocks`): one synchronize before the first block, none
    between the frames of a block, and each block ends by reading its
    last ``t_map`` to the host. Returns (seconds a frame of each block,
    the stacked t_map trajectory, the final state); the callers take the
    median block. Every graph must be captured before: a capture inside
    a timed block raises."""
    if dev_frames[0][0].is_cuda:
        torch.cuda.synchronize()
    captures = graph.captures
    outs, secs = [], []
    for lo, hi in _blocks(len(dev_frames), n_blocks):
        t0 = time.perf_counter()
        for xyz, mask in dev_frames[lo:hi]:
            state, out = step(state, xyz, mask)
            outs.append(out.t_map)
        out.t_map.cpu()
        secs.append((time.perf_counter() - t0) / (hi - lo))
    if graph.captures != captures:
        raise RuntimeError(f"{graph.captures - captures} graphs captured "
                           f"inside the timed blocks")
    est = np.stack([t.cpu().numpy() for t in outs])
    return secs, est, state


def _on(device, arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _say_graphs(tag: str, captures0: int, replays0: int,
                launches0: dict) -> None:
    """One line of a run: its graph captures and replays, and its kernel
    launches (JSON, from ``launches0``) outside the replays."""
    now = kernels.counts()
    print(f"[bench] {tag}: {graph.captures - captures0} graph captures, "
          f"all in warm-up, {graph.replays - replays0} replays; kernel "
          f"launches " + json.dumps({k: now[k] - launches0[k] for k in now}),
          flush=True)


def bench_single(cfg, n_frames, device):
    """ms a scan and ATE of one stream through ``pipeline.make_step_fn``:
    4 warm-up frames of seed 7 (they take the capture), then ``n_frames``
    of seed 42 at 10 m/s from a fresh state."""
    warm_xyz, warm_mask, _ = _cached_sequence(4, 7, 10.0)
    xyz, mask, gt = _cached_sequence(n_frames, 42, 10.0)
    c0, r0, k0 = graph.captures, graph.replays, kernels.counts()
    step = pipeline.make_step_fn(cfg)
    state = pipeline.init_state(cfg, 1, device)
    for x, m in zip(_on(device, warm_xyz), _on(device, warm_mask)):
        state, out = step(state, x, m)
    out.t_map.cpu()
    dev = list(zip(_on(device, xyz), _on(device, mask)))
    secs, est, _ = _time_blocks(step, pipeline.init_state(cfg, 1, device),
                                dev)
    _say_graphs("one stream", c0, r0, k0)
    ate = ate_rmse(est, gt[:, :3], align=False)
    return float(np.median(secs)), float(ate)


def run_batched(cfg, batch, n_frames, device):
    """B distinct streams (worlds, seeds, speeds) through the donated
    ``parallel.batched_step_jit``: on a card, :func:`verify_rung` on the
    warm-up frames first; 2 warm-up frames (the capture), then
    ``n_frames`` timed on the same state. Returns (seconds a frame of each
    block, the mapped positions (B, n_frames, 3) and the ground truth of
    the same frames, both from each stream's frame 0)."""
    xyz, mask, gt = load_streams(cfg, batch, n_frames + 2)
    tag = f"B={batch} ring_cap {cfg.ring_cap}"
    if torch.device(device).type == "cuda":
        errs = verify_rung(cfg, batch, xyz, mask, device)
        print(f"[bench] {tag}: step_b's kernels agree with their plain "
              f"versions at its frame-1 inputs: " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
    c0, r0, k0 = graph.captures, graph.replays, kernels.counts()
    step = parallel.batched_step_jit(cfg, donate=True)
    state = parallel.batched_init(cfg, batch, device)
    for f in range(2):
        state, out = step(state, *_on(device, (xyz[f], mask[f])))
    out.t_map.cpu()
    dev = [tuple(_on(device, (xyz[2 + f], mask[2 + f])))
           for f in range(n_frames)]
    secs, est, state = _time_blocks(step, state, dev)
    _say_graphs(tag, c0, r0, k0)
    # est is absolute from the stream's frame 0 (the warm-up frames ran on
    # the same state): the matching absolute GT rows
    return secs, np.moveaxis(est, 0, 1), gt[:, 2:2 + n_frames]


def bench_batched(cfg, batch, n_frames, device):
    """:func:`run_batched`'s (median scans/s over the blocks, their
    spread, max and median per-stream ATE, None: no FLOPs)."""
    secs, est, gt = run_batched(cfg, batch, n_frames, device)
    rates = sorted(batch / s for s in secs)
    ates = [float(ate_rmse(est[b], gt[b], align=False))
            for b in range(batch)]
    return (float(np.median(rates)), rates[-1] - rates[0],
            max(ates), float(np.median(ates)), None)


# --- the kernels on the card against their plain versions ------------------

def verify_rung(cfg, batch, xyz, mask, device) -> dict:
    """Each kernel ``step_b`` launches (``kernels.STEP_B``) against its
    plain version at the inputs frame 1 of a rung gives them (its first
    two frames, from a fresh state; one check per kernel and input
    shape), within its ``ops/kernels.py`` bound: each batch size and cap
    set gives the kernels launch plans that :func:`verify_kernels`'
    shapes do not reach. A kernel updating tables in place gets its own
    copy of them on each side. Raises on a disagreement; returns each
    kernel's max abs error."""
    state = pipeline.init_state(cfg, batch, device)
    state, _ = pipeline.step_b(state, *_on(device, (xyz[0], mask[0])), cfg)
    recorded = kernels.record_inputs(
        kernels.STEP_B,
        lambda: pipeline.step_b(state, *_on(device, (xyz[1], mask[1])), cfg))
    del state
    errs = dict.fromkeys(kernels.STEP_B, 0.0)
    for (name, _), (args, kw) in recorded.items():
        kind = next((a for a in args if isinstance(a, str)), None)
        errs[name] = max(errs[name], _check(
            name, kernels.run(name, kernels.wrapper(name), args, kw),
            kernels.run(name, kernels.plain(name), args, kw), kind,
            inputs=args))
    if len({name for name, _ in recorded}) != len(kernels.STEP_B):
        raise RuntimeError(f"step_b ran only {sorted(recorded)}")
    return errs


def _check(name, got, want, kind=None, inputs=None) -> float:
    ok, err = kernels.agree(name, got, want, kind, inputs)
    if not ok:
        raise RuntimeError(f"{name}{'' if kind is None else ' ' + kind}: "
                           f"the kernel disagrees with its plain version "
                           f"(max abs err {err:.6g})")
    return err


def _knn_rows(rng, n, bw):
    """(rows (n, 24 bw) f32 block-planar candidate rows uniform in ±5 m, a
    tenth of the slots empty at 1e9, q (n, 4) [x, y, z, poison] with
    every 13th query gated)."""
    rows = rng.uniform(-5, 5, size=(n, 8, 3, bw)).astype(np.float32)
    far = rng.uniform(size=(n, 8, 1, bw)) < 0.1
    rows = np.where(far, np.float32(1e9), rows).reshape(n, 24 * bw)
    q = rng.uniform(-5, 5, size=(n, 4)).astype(np.float32)
    q[:, 3] = 0.0
    q[::13, 3] = 1.0
    return rows, q


def _merge_inputs(rng, bsz, h, cap_c, cap_p, bk, cell, leaf):
    """merge_rows' arguments: tables (B, H, ·) with 60% of the slots live,
    the first rows of each stream used (cnt ≥ 1, then 0), a third of the
    points on a voxel their bucket already holds (they merge)."""
    from aloam_tpu_torch.ops.gridmap import _EMPTY, _mix
    from aloam_tpu_torch.ops.insert import _pack_aux
    pts = rng.uniform(-20, 20, size=(bsz, h, 3, bk)).astype(np.float32)
    occ = rng.uniform(size=(bsz, h, 1, bk)) < 0.6
    t = torch.from_numpy
    cells = torch.where(t(occ), t(np.floor(pts / cell).astype(np.int32)),
                        _EMPTY)
    vox = torch.where(t(occ[:, :, 0]), _mix(*t(np.floor(pts / leaf).astype(
        np.int32)).unbind(2)), 0)
    pts = np.where(occ, pts, np.float32(1e9))
    inten = t(rng.uniform(0, 64, size=(bsz, h, bk)).astype(np.float32))
    aux = _pack_aux(inten, *cells.unbind(2), vox)
    slot_h = np.stack([rng.choice(h, cap_c, replace=False)
                       for _ in range(bsz)]).astype(np.int32)
    used = np.arange(cap_c)[None] < rng.integers(cap_c // 2, cap_c,
                                                 size=(bsz, 1))
    cnt = np.where(used, rng.integers(1, cap_p + 4, size=(bsz, cap_c)), 0)
    pp = rng.uniform(-20, 20, size=(3, bsz, cap_c, cap_p)).astype(np.float32)
    pvox = _mix(*t(np.floor(pp / leaf).astype(np.int32)))
    own = np.take_along_axis(vox.numpy(), slot_h[..., None], axis=1)
    which = rng.integers(0, bk, size=(bsz, cap_c, cap_p))
    copy = t(rng.uniform(size=(bsz, cap_c, cap_p)) < 0.3)
    pvox = torch.where(copy, t(np.take_along_axis(own, which, axis=2)), pvox)
    ppi = rng.uniform(0, 64, size=(bsz, cap_c, cap_p)).astype(np.float32)
    center = rng.integers(-4, 4, size=(bsz, 3)).astype(np.int32)
    return (t(pts.reshape(bsz, h, 3 * bk)), aux, t(slot_h),
            t(cnt.astype(np.int32)), *map(t, pp), t(ppi), pvox, t(center),
            t(np.array([5, 5, 3], np.int32)))


def _lm_inputs(rng, bsz, ne, npl):
    """(ef (B, 10, Ne), pf (B, 8, Np), pose (B, 8)): unit-scale edge and
    plane factors near a pose off the identity, 70% live, the masked ones
    poisoned (inf edge points, NaN plane points)."""
    e_p = rng.normal(scale=8.0, size=(bsz, ne, 3))
    e_a = e_p + rng.normal(scale=0.05, size=(bsz, ne, 3))
    dirs = rng.normal(size=(bsz, ne, 3))
    e_b = e_a + 0.4 * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    e_m = rng.random((bsz, ne)) < 0.7
    e_p[~e_m] = np.inf
    p_p = rng.normal(scale=8.0, size=(bsz, npl, 3))
    nrm = rng.normal(size=(bsz, npl, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = -np.sum(nrm * p_p, axis=-1) + rng.normal(scale=0.02, size=(bsz, npl))
    p_m = rng.random((bsz, npl)) < 0.7
    p_p[~p_m] = np.nan
    ef = np.concatenate([e_p, e_a, e_b, e_m[..., None]], -1)
    pf = np.concatenate([p_p, nrm, d[..., None], p_m[..., None]], -1)
    q = np.tile([0.999, 0.02, -0.03, 0.01], (bsz, 1))
    pose = np.concatenate([q / np.linalg.norm(q, axis=1, keepdims=True),
                           rng.normal(scale=0.1, size=(bsz, 3)),
                           np.zeros((bsz, 1))], 1)
    return (torch.from_numpy(np.ascontiguousarray(
                ef.transpose(0, 2, 1), np.float32)),
            torch.from_numpy(np.ascontiguousarray(
                pf.transpose(0, 2, 1), np.float32)),
            torch.from_numpy(pose.astype(np.float32)))


def _ring_segmented(rng, bsz, n_rings, seg, qn):
    """A ring-segmented reference (B, 4, n_rings·seg) [x | y | z | ring],
    ring r near z = 3r with a random fill of its seg rows (the rest
    poisoned at 1e9), and qn queries sorted by z over the rings: each
    query's ring window (±2.5 rings) misses most rows, so the ring_seg
    path skips."""
    m = n_rings * seg
    ring = np.repeat(np.arange(n_rings), seg)[None].repeat(bsz, 0)
    fill = rng.integers(seg // 2, seg, size=(bsz, n_rings))
    live = (np.arange(seg)[None, None] < fill[..., None]).reshape(bsz, m)
    ref = np.stack([rng.uniform(-10, 10, size=(bsz, m)),
                    rng.uniform(-10, 10, size=(bsz, m)),
                    3.0 * ring + rng.uniform(-0.5, 0.5, size=(bsz, m)),
                    ring], axis=1)
    ref = np.where(live[:, None], ref, 1e9).astype(np.float32)
    qz = np.sort(rng.uniform(0, 3.0 * (n_rings - 1), size=(bsz, qn)), axis=1)
    sel = np.stack([rng.uniform(-10, 10, size=(bsz, qn)),
                    rng.uniform(-10, 10, size=(bsz, qn)), qz],
                   axis=-1).astype(np.float32)
    return torch.from_numpy(sel), torch.from_numpy(ref)


def verify_kernels(device) -> dict:
    """Each CUDA kernel on the card against its plain PyTorch version, on
    seeded inputs at bench.py's shapes, within ``ops/kernels.py``'s
    bounds: knn_select's cache entry (n 512, bw 48) and its table entry;
    assoc_cell (2 tiles of 256, both kinds); merge_tiles (the in-place
    ``merge_rows``, B 2 × 64 rows, both tables as a whole); the seg scan
    (16 × 6400, across tiles); window_mins (want_same both ways; random
    clouds, and a ring-segmented one with and without ``ring_seg``, the
    two equal); lm_fused (B 3); select_rings (64 rings of 1856). Raises on
    any disagreement. Returns each kernel's max abs error."""
    rng = np.random.default_rng(7)
    errs = {}

    def on(*xs):
        return [x.to(device) for x in xs]

    # --- knn_select: the cache entry, then the table entry ---------------
    rows, q = _knn_rows(rng, 512, 48)
    rows, q = on(torch.from_numpy(rows), torch.from_numpy(q))
    row = torch.arange(512, dtype=torch.int32, device=device)
    err = _check("knn_select_rows", knn.knn_select(rows, row, q, 5),
                 knn.knn_select_plain(rows, row, q, 5))
    table = rng.uniform(-12, 12, size=(1024, 3, 48)).astype(np.float32)
    table[rng.uniform(size=(1024, 1, 48)).repeat(3, 1) < 0.3] = 1e9
    table, qg = on(torch.from_numpy(table.reshape(1024, 144)),
                   torch.from_numpy(rng.uniform(-10, 10, size=(700, 3))
                                    .astype(np.float32)))
    errs["knn_select"] = max(err, _check(
        "knn_select", knn.knn_grid(table, qg, 5, 2.0, 1.0),
        knn.knn_grid_plain(table, qg, 5, 2.0, 1.0)))

    # --- assoc_cell: the fused 5-NN and fit over cell-sorted queries ------
    tq, bwa, n_cells = 256, 48, 96
    nq = 2 * tq
    pad_rows = n_cells + tq + 8
    cand = rng.uniform(-1.0, 1.0, size=(pad_rows, 8, 3, bwa))
    far = rng.uniform(size=(pad_rows, 8, 1, bwa)) < 0.1
    cand = np.where(far, 1e9, cand).astype(np.float32).reshape(pad_rows, -1)
    cid = np.sort(rng.integers(0, n_cells, size=nq)).astype(np.int32)
    cid0 = cid[::tq].copy()
    q8 = np.zeros((nq, 8), np.float32)
    q8[:, :3] = rng.uniform(-0.8, 0.8, size=(nq, 3))
    q8[:, 4] = cid - np.repeat(cid0, tq)
    args = on(*map(torch.from_numpy, (cand, cid0, q8)))
    errs["assoc_cell"] = max(_check(
        "assoc_cell", assoc.assoc_cell(*args, kind, 1.0),
        assoc.assoc_cell_plain(*args, kind, 1.0), kind)
        for kind in ("surf", "corner"))

    # --- merge_tiles: in place, so each side gets its own tables ---------
    margs = on(*_merge_inputs(rng, 2, 256, 64, 16, 48, 2.0, 0.4))
    mine = [a.clone() for a in margs[:2]]
    stats = insert.merge_rows(*mine, *margs[2:], 2.0, 0.4)
    ref = [a.clone() for a in margs[:2]]
    ref_stats = insert.merge_rows_plain(*ref, *margs[2:], 2.0, 0.4)
    errs["merge_tiles"] = _check("merge_tiles", (*mine, *stats),
                                 (*ref, *ref_stats))

    # --- segmented_prefix_sums: rows longer than a tile -------------------
    # reals in ±20 m, whose sums cancel: the bound scales with the sums of
    # their magnitudes
    heads = rng.uniform(size=(16, 6400)) < 0.2
    heads[:, 0] = True
    chans = rng.uniform(-20, 20, size=(5, 16, 6400)).astype(np.float32)
    chans[-1] = 1.0                   # the count channel, held exact
    vals, hd = on(torch.from_numpy(chans), torch.from_numpy(heads))
    errs["segmented_prefix_sums"] = _check(
        "segmented_prefix_sums", voxel.segmented_prefix_sums(vals, hd),
        voxel.segmented_prefix_sums_plain(vals, hd), inputs=(vals, hd))

    # --- window_mins: random clouds, then a ring-segmented one ------------
    sel = rng.uniform(-10, 10, size=(2, 256, 3)).astype(np.float32)
    ref_c = rng.uniform(-10, 10, size=(2, 3, 2048))
    ring = np.sort(rng.integers(0, 16, size=(2, 1, 2048)), axis=2)
    live = rng.uniform(size=(2, 1, 2048)) > 0.1
    ref_p = np.where(live, np.concatenate([ref_c, ring], 1), 1e9)
    sel, ref_p = on(torch.from_numpy(sel),
                    torch.from_numpy(ref_p.astype(np.float32)))
    seg_sel, seg_ref = on(*_ring_segmented(rng, 2, 16, 128, 256))
    err = 0.0
    for want_same in (False, True):
        err = max(err, _check(
            "window_mins", odom.window_mins(sel, ref_p, 2.5, want_same),
            odom.window_mins_plain(sel, ref_p, 2.5, want_same)))
        skip = odom.window_mins(seg_sel, seg_ref, 2.5, want_same, 128)
        err = max(err, _check(
            "window_mins", skip,
            odom.window_mins_plain(seg_sel, seg_ref, 2.5, want_same, 128)))
        _check("window_mins", skip,
               odom.window_mins(seg_sel, seg_ref, 2.5, want_same, 0))
    # every neighbour on a real ring, the queries over more rings than one
    # window spans: each tile's windows leave rows out
    rings_nn = seg_ref[:, 3].gather(1, skip[1].long())
    if not bool((rings_nn < 16).all()
                and (rings_nn.amax(1) - rings_nn.amin(1) > 5).all()):
        raise RuntimeError("window_mins: the ring-segmented check has "
                           "no row that ring_seg skips")
    errs["window_mins"] = err

    # --- lm_fused ---------------------------------------------------------
    ef, pf, pose = on(*_lm_inputs(rng, 3, 256, 384))
    errs["lm_fused"] = _check("lm_fused", lm.lm_fused(ef, pf, pose, 4, 0.1),
                              lm.lm_fused_plain(ef, pf, pose, 4, 0.1))

    # --- select_rings: 64 rings of the bench's ring_cap --------------------
    from aloam_tpu_torch.frontend.features import _select_args
    cfg = batched_bench_cfg()
    r, c = 64, cfg.ring_cap
    pts = np.cumsum(rng.normal(scale=0.1, size=(r, c, 3)), axis=1)
    curv = rng.exponential(0.1, size=(r, c))
    cnt = rng.integers(c // 2, c + 1, size=r)
    sargs = _select_args(*(torch.from_numpy(a).to(device) for a in (
        pts.astype(np.float32), curv.astype(np.float32),
        cnt.astype(np.int32))), cfg)
    consts = (cfg.n_regions, cfg.max_sharp, cfg.max_less_sharp,
              cfg.max_flat, cfg.nms_window, cfg.curvature_threshold)
    errs["select_rings"] = _check(
        "select_rings", select.select_rings(*sargs, *consts),
        select.select_rings_plain(*sargs, *consts))
    return errs


def main(device="cuda"):
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the bench runs on the card")
        torch.backends.cuda.matmul.allow_tf32 = False
        errs = verify_kernels(device)
        print("[bench] kernels agree with their plain versions: "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()),
              flush=True)
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    cfg = PRESETS["HDL-64"]

    n_single = int(os.environ.get("BENCH_FRAMES", "16"))
    ms_single, ate_single = bench_single(cfg, n_single, device)

    result = {
        "metric": "scans_per_sec_hdl64_odom_map",
        "unit": "scans/sec/chip",
        "device_kind": kind,
        "ms_per_scan_single": round(1e3 * ms_single, 2),
        "ate_rmse_m": round(ate_single, 4),
        "frames": n_single,
    }

    if batch > 0:
        bcfg = batched_bench_cfg(cfg)
        n_b = int(os.environ.get("BENCH_BATCH_FRAMES", "32"))
        # measure every size of the ladder and report the best; a size
        # the card has no memory for is recorded, any other failure raises
        sizes = ladder(batch)
        fell_back, per_batch = [], {}
        best = None

        def run_size(bi):
            nonlocal best
            try:
                sps, spread, ate_b, ate_med, _ = bench_batched(
                    bcfg, bi, n_b, device)
            except torch.cuda.OutOfMemoryError as e:
                fell_back.append(f"B={bi}: {type(e).__name__}")
                torch.cuda.empty_cache()
                return
            per_batch[str(bi)] = round(sps, 2)
            if best is None or sps > best[0]:
                best = (sps, spread, ate_b, ate_med, bi)

        for bi in sizes:
            run_size(bi)
        # near-linear scaling 16 -> 32 means latency still dominates: probe
        # 64 too (only from the default 32-topped ladder)
        if (sizes[:1] == [32]
                and per_batch.get("32", 0) > 1.7 * per_batch.get("16", 1e9)):
            run_size(64)
        if best is None:
            raise RuntimeError(f"every batch size failed: {fell_back}")
        sps, spread, ate_b, ate_med, batch = best
        result.update(value=round(sps, 2), batch=batch,
                      blocks=_N_BLOCKS, spread_sps=round(spread, 2),
                      ate_batched_max_m=round(ate_b, 4),
                      ate_batched_med_m=round(ate_med, 4),
                      batch_frames=n_b, batch_ladder=per_batch)
        result["bench_caps"] = {"ring_cap": bcfg.ring_cap,
                                "n_raw": bcfg.n_raw,
                                "less_flat_cap": bcfg.less_flat_cap}
        if fell_back:
            result["batch_fallback"] = fell_back
        # the same run at the untrimmed preset caps a real-KITTI user gets
        if os.environ.get("BENCH_PRESET_RUNG", "1") != "0":
            pcfg = cfg.replace(map_query_chunk=bcfg.map_query_chunk)
            try:
                sps_p, _, ate_p, _, _ = bench_batched(pcfg, batch, n_b,
                                                      device)
                result["value_preset"] = round(sps_p, 2)
                result["ate_preset_max_m"] = round(ate_p, 4)
                result["preset_caps"] = {"ring_cap": pcfg.ring_cap,
                                         "n_raw": pcfg.n_raw,
                                         "less_flat_cap":
                                             pcfg.less_flat_cap}
            except torch.cuda.OutOfMemoryError as e:
                result["value_preset_error"] = type(e).__name__
    else:
        result.update(value=round(1.0 / ms_single, 2), batch=0)

    result["vs_baseline"] = round(result["value"] / 10.0, 2)
    result["vs_target"] = round(result["value"] / 500.0, 3)

    print(json.dumps(result))


if __name__ == "__main__":
    main()
