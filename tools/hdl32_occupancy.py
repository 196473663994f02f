"""How full the port's fixed-size buffers run on HDL-32E scans, so that a
deployment can size its capacities from its own sensor.

    python tools/hdl32_occupancy.py --seed 8200000001 --seeds 3
    python tools/hdl32_occupancy.py --seed 8200000001 --seeds 3 \
        --config benchmark/configs/hdl32.json

Run from the repository root on a machine with a CUDA card. For each seed
it renders the ``fleet-b32`` traffic's pool of logs with the benchmark's
generator (``benchmark.render.render_pool``) for a Velodyne HDL-32E (32
rings, 2172 steps a turn, 0.01 m range noise, 5% dropout) at a width that
holds every ray a turn fires, and steps each log once from a fresh state
through ``parallel.batched_step_jit`` at ``PRESETS["HDL-32"]`` (or at the
``aloam`` fields of ``--config``, and ``--set key=value`` over either),
the first ``n_raw`` returns of each scan as the benchmark hands them over.
Beside every step it recomputes, with no capacity in the way, what each
buffer would have had to hold:

* ``returns``: returns a scan, against ``n_raw``;
* ``ring_points``: points a ring, against ``ring_cap``;
* ``less_flat_ring`` / ``less_flat``: the less-flat cloud a ring and a
  scan, against ``less_flat_cap // scan_lines`` and ``less_flat_cap``;
* ``corner_stack`` / ``surf_stack``: the mapping input stacks after their
  voxel downsample, against ``corner_stack_cap`` / ``surf_stack_cap``;
* ``corner_cells`` / ``surf_cells``: distinct knn base cells of a stack at
  the mapping's initial pose, against ``map_cell_cap``;
* ``*_insert_buckets`` / ``*_insert_points``: buckets an insert touches and
  voxel means one bucket takes in it, against ``map_insert_cell_cap`` /
  ``map_insert_point_cap``;
* ``*_bucket_fill``: live entries of the fullest bucket of the map tables
  after the step, against ``map_bucket_*`` (it cannot pass the cap: a full
  bucket evicts, which ``map_evicted`` counts);
* ``*_bucket_demand``: what the fullest bucket would hold if none evicted,
  the distinct voxels inserted into one bucket since the log began (a log
  of 200 frames never leaves the rolling window, so nothing is cleared);
* ``*_buckets_used``: buckets holding an entry, against the table's rows;

and the largest value, over streams and frames, of every column of the
step's metrics vector (``frontend_overflow``, ``map_overflow``,
``map_evicted``, ``map_cache_crossed`` ... : zero where no capacity cut),
and the largest and the median stream's unaligned ATE of the mapped
positions against the log's ground truth (m): what the capacities cost.
It prints one JSON line a seed and a last one with the maxima over all
seeds beside the capacities, the card's name and power limit. It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENSOR = {"scan_lines": 32, "azimuth": 2172, "noise": 0.01, "dropout": 0.05}
CAPS = {
    "returns": "n_raw", "ring_points": "ring_cap",
    "less_flat": "less_flat_cap", "corner_stack": "corner_stack_cap",
    "surf_stack": "surf_stack_cap", "corner_cells": "map_cell_cap",
    "surf_cells": "map_cell_cap",
    "corner_insert_buckets": "map_insert_cell_cap",
    "surf_insert_buckets": "map_insert_cell_cap",
    "corner_insert_points": "map_insert_point_cap",
    "surf_insert_points": "map_insert_point_cap",
    "corner_bucket_fill": "map_bucket_corner",
    "surf_bucket_fill": "map_bucket_surf",
}


def _distinct(key, valid):
    """Distinct values of ``key`` (B, N) among ``valid`` a stream, and the
    longest run of one value: (count (B,), most (B,))."""
    import torch
    big = torch.iinfo(key.dtype).max
    k = torch.sort(torch.where(valid, key, big), dim=1).values
    live = k != big
    head = live.clone()
    head[:, 1:] &= k[:, 1:] != k[:, :-1]
    n = key.shape[1]
    iota = torch.arange(n, device=key.device).expand_as(k)
    start = torch.where(head, iota, -1).cummax(dim=1).values
    run = torch.where(live, iota - start + 1, 0)
    return head.sum(dim=1), run.amax(dim=1)


def frame_demand(cfg, x, m, state0, state1):
    """What the buffers had to hold for one frame: the scans (x, m) and the
    states before (``state0``'s map correction, cloned) and after the
    step. Returns ({name: (B,) tensor}, {class: the (stream, bucket,
    voxel) keys of its insert, (N,) int64})."""
    import torch

    from aloam_tpu_torch import geometry as geo
    from aloam_tpu_torch.frontend.features import extract_features_b
    from aloam_tpu_torch.frontend.registration import register_scan_b
    from aloam_tpu_torch.frontend.voxel import (voxel_downsample_masked_b,
                                                voxel_segment_tails)
    from aloam_tpu_torch.ops import gridmap

    out, keys = {}, {}
    rc, curv, _ = register_scan_b(x, m, cfg)
    r, c = rc.xyz.shape[1:3]
    out["ring_points"] = rc.cnt.amax(dim=1)
    feats = extract_features_b(rc, curv, cfg.replace(less_flat_cap=r * c))
    lf = feats.less_flat.mask.view(-1, r, c).sum(dim=2)
    out["less_flat_ring"] = lf.amax(dim=1)
    out["less_flat"] = lf.sum(dim=1)

    q_corr, t_corr = state0
    odom, mp = state1.odom, state1.map
    q_guess = geo.qmul(q_corr, odom.q_w)
    t_guess = geo.qrot(q_corr, odom.t_w) + t_corr
    for kind, cloud, leaf, table in (
            ("corner", odom.corner_last, cfg.line_resolution, mp.corner),
            ("surf", odom.surf_last, cfg.plane_resolution, mp.surf)):
        vals = torch.cat([cloud.xyz, cloud.intensity[..., None]], dim=-1)
        ds, dm, _ = voxel_downsample_masked_b(vals, cloud.mask, leaf,
                                              cloud.mask.shape[1])
        out[f"{kind}_stack"] = dm.sum(dim=1)
        # knn base cells of every stack row, padding too, as the cache
        # groups them (gridmap.knn_cache_b)
        sel = geo.qrot(q_guess[:, None], ds[..., :3]) + t_guess[:, None]
        qc = gridmap._cells_of(sel - cfg.knn_radius, cfg.knn_cell)
        rel = (qc - qc.amin(dim=1, keepdim=True)).clamp(0, 1023)
        key = (rel[..., 0] << 20) | (rel[..., 1] << 10) | rel[..., 2]
        out[f"{kind}_cells"] = _distinct(key, torch.ones_like(dm))[0]
        # the insert at the refined pose (gridmap.insert_vds_b): voxel
        # means on the map-anchored grid, bucketed by the mean's cell
        world = geo.qrot(mp.q_w[:, None], ds[..., :3]) + mp.t_w[:, None]
        sums, cnts, tail = voxel_segment_tails(
            torch.cat([world, ds[..., 3:]], dim=-1), dm, leaf)
        den = cnts.clamp_min(1.0)
        mean = torch.stack([sums[i] / den for i in range(3)], dim=-1)
        h = gridmap._hash(gridmap._cells_of(mean, cfg.knn_cell),
                          table.aux.shape[1])
        n_b, most = _distinct(h, tail)
        out[f"{kind}_insert_buckets"] = n_b
        out[f"{kind}_insert_points"] = most
        sb = (torch.arange(h.shape[0], device=h.device)[:, None]
              * table.aux.shape[1] + h).long()
        vox = gridmap._vox_id(mean, leaf).long() & 0xFFFFFFFF
        keys[kind] = ((sb << 32) | vox)[tail]
        live = table._auxv()[..., 1, :] != gridmap._EMPTY      # (B, H, Bk)
        out[f"{kind}_bucket_fill"] = live.sum(dim=2).amax(dim=1)
        out[f"{kind}_buckets_used"] = live.any(dim=2).sum(dim=1)
    return out, keys


def run_seed(cfg, sensor, traffic, seed, device, frames):
    """Maxima over one seed's logs and frames: (demand, metric columns,
    [the largest, the median stream's ATE])."""
    import numpy as np
    import torch

    from aloam_tpu_torch import parallel, pipeline
    from benchmark.render import render_pool

    lines, az = sensor["scan_lines"], sensor["azimuth"]
    # every ray of a turn, and no less than the step takes
    width = max(-(-lines * az // 8192) * 8192, cfg.n_raw)
    tr = dict(traffic, frames=frames)
    xyz, mask, gt = render_pool(sensor, tr, width, seed, device)
    b = traffic["streams"]
    xyz, mask, gt = xyz[:b], mask[:b], gt[:b]
    t_map = []
    step = parallel.batched_step_jit(cfg, donate=True)
    state = parallel.batched_init(cfg, b, device)
    most, cols = {}, {}
    seen = {k: torch.empty(0, dtype=torch.int64, device=device)
            for k in ("corner", "surf")}
    for f in range(frames):
        full = mask[:, f]
        x = xyz[:, f, :cfg.n_raw].contiguous()
        m = full[:, :cfg.n_raw].contiguous()
        corr = (state.map.q_wmap_wodom.clone(),
                state.map.t_wmap_wodom.clone())
        state, out = step(state, x, m)
        t_map.append(out.t_map.double().cpu())
        got, keys = frame_demand(cfg, x, m, corr, state)
        got["returns"] = full.sum(dim=1)
        for kind, k in keys.items():
            seen[kind] = torch.unique(torch.cat([seen[kind], k]))
            _, per = torch.unique_consecutive(seen[kind] >> 32,
                                              return_counts=True)
            got[f"{kind}_bucket_demand"] = per.amax()
        for k, v in got.items():
            most[k] = max(most.get(k, 0), int(v.max()))
        met = out.metrics.amax(dim=0).tolist()
        for k, v in zip(pipeline.METRIC_NAMES, met):
            cols[k] = max(cols.get(k, float("-inf")), v)
        if f:               # frame 0 has no map to solve against
            solved = out.metrics[:, pipeline.METRIC_NAMES.index(
                "map_solved")]
            cols["map_solved_min"] = min(cols.get("map_solved_min", 1.0),
                                         float(solved.min()))
    # each stream's unaligned ATE (m): its mapped positions against the
    # ground truth of its log, as benchmark.run.ate takes it
    err = (torch.stack(t_map, 1).numpy() - gt) ** 2
    ate = np.sqrt(err.sum(-1).mean(-1))
    return most, cols, [float(ate.max()), float(np.median(ate))]


def card_name(device) -> str | None:
    import torch
    if device.type != "cuda":
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else torch.cuda.get_device_name(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=3,
                    help="seeds from --seed on")
    ap.add_argument("--config", help="a benchmark configuration file: its "
                    "sensor, log_frames and aloam fields in place of the "
                    "HDL-32E and PRESETS['HDL-32']")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="an aloam field over the "
                    "configuration's")
    ap.add_argument("--frames", type=int, help="frames a log (default 200, "
                    "or the configuration's log_frames)")
    ap.add_argument("--streams", type=int,
                    help="streams (and logs) in place of the traffic's")
    ap.add_argument("--azimuth", type=int,
                    help="steps a turn in place of the sensor's")
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script at a tiny size")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import dataclasses

    import torch

    from aloam_tpu_torch.config import PRESETS, AloamConfig

    device = torch.device(args.device)
    if args.config:
        with open(os.path.join(ROOT, args.config)) as fh:
            conf = json.load(fh)
        sensor, fields = conf["sensor"], conf["aloam"]
        frames = args.frames or conf["log_frames"]
    else:
        sensor = SENSOR
        fields = dataclasses.asdict(PRESETS["HDL-32"])
        frames = args.frames or 200
    fields = dict(fields, **{k: json.loads(v) for k, v in
                             (s.split("=", 1) for s in args.set)})
    cfg = AloamConfig(**fields)
    sensor = dict(sensor, **({"azimuth": args.azimuth}
                             if args.azimuth else {}))
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "fleet-b32.json")) as fh:
        traffic = json.load(fh)
    if args.streams:
        traffic.update(streams=args.streams, pool=args.streams)
    most, cols, ates = {}, {}, []
    for seed in range(args.seed, args.seed + args.seeds):
        m, c, ate = run_seed(cfg, sensor, traffic, seed, device, frames)
        print(json.dumps({"seed": seed, "max": m, "columns": c,
                          "ate_m": ate}), flush=True)
        ates.append(ate)
        for k, v in m.items():
            most[k] = max(most.get(k, 0), v)
        for k, v in c.items():
            cols[k] = min(cols.get(k, 1.0), v) if k == "map_solved_min" \
                else max(cols.get(k, float("-inf")), v)
    caps = {k: getattr(cfg, v) for k, v in CAPS.items()}
    caps["less_flat_ring"] = cfg.less_flat_cap // cfg.scan_lines
    caps["corner_bucket_demand"] = cfg.map_bucket_corner
    caps["surf_bucket_demand"] = cfg.map_bucket_surf
    caps["corner_buckets_used"] = cfg.map_table_corner
    caps["surf_buckets_used"] = cfg.map_table_surf
    print(json.dumps({"card": card_name(device), "torch": torch.__version__,
                      "sensor": sensor, "traffic": "fleet-b32",
                      "streams": traffic["streams"], "frames": frames,
                      "seeds": [args.seed, args.seed + args.seeds - 1],
                      "max": most, "ate_m": ates,
                      "cap": {k: caps[k] for k in most},
                      "columns": cols}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
