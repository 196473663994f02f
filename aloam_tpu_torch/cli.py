"""Command-line pipeline runner of the port, the launch-file equivalent
(port of ``aloam_tpu/cli.py``).

Plays a KITTI sequence or a synthetic sequence through the single-stream
step (``pipeline.step``) on one device, logging per-frame metrics (JSONL)
and writing the trajectory (TUM format and npz), the evaluation against
the ground truth, and optional checkpoints, map clouds and PNGs. It takes
the JAX package's flags plus ``--device``: ``cuda`` (the default) runs the
CUDA kernels and fails without a card; ``cpu`` runs their plain versions.

Examples:
    python -m aloam_tpu_torch.cli --preset HDL-64 --synthetic --frames 100 \
        --out /tmp/run1
    python -m aloam_tpu_torch.cli --device cpu --preset VLP-16 --synthetic \
        --frames 3 --out /tmp/run_cpu
"""

from __future__ import annotations

import argparse
import itertools
import json
import os


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, choices and defaults (``aloam_tpu/cli.py``), so
    a command line moves between the two packages unchanged, plus
    ``--device``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="HDL-64",
                   choices=["VLP-16", "HDL-32", "HDL-64"])
    p.add_argument("--kitti", help="KITTI dataset folder (kittiHelper layout)")
    p.add_argument("--sequence", default="00")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic street-canyon sequence instead of KITTI")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--speed", type=float, default=10.0,
                   help="synthetic vehicle speed [m/s]")
    p.add_argument("--out", default="out_run", help="output directory")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save the SLAM state every K frames")
    p.add_argument("--resume", help="checkpoint .npz to resume from")
    p.add_argument("--plots", action="store_true",
                   help="write trajectory/map PNGs at the end")
    p.add_argument("--mapping-skip-frame", type=int, default=None)
    p.add_argument("--skip-first", type=int, default=0,
                   help="discard the first N scans (the reference's "
                        "systemDelay, scanRegistration.cpp:62)")
    p.add_argument("--surround-every", type=int, default=0, metavar="K",
                   help="write the local-neighborhood map cloud every K "
                        "frames (the /laser_cloud_surround 5-frame cadence, "
                        "laserMapping.cpp:806-821)")
    p.add_argument("--map-every", type=int, default=0, metavar="K",
                   help="write the full map cloud every K frames (the "
                        "/laser_cloud_map 20-frame cadence, "
                        "laserMapping.cpp:823-836)")
    p.add_argument("--dump-rings", type=int, default=None, metavar="FRAME",
                   help="write per-ring debug clouds of the given frame to "
                        "rings_FRAME.npz (the PUB_EACH_LINE channel, "
                        "scanRegistration.cpp:444-454)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels; needs a card) or "
                        "cpu (their plain versions)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from aloam_tpu_torch.config import PRESETS
    from aloam_tpu_torch.eval.ate import ate_rmse, kitti_drift, rpe, rpe_rot
    from aloam_tpu_torch.io import synthetic as syn
    from aloam_tpu_torch.utils.tictoc import TicToc
    from aloam_tpu_torch import mapping as mp
    from aloam_tpu_torch import pipeline
    from aloam_tpu_torch.utils import checkpoint as ckpt

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    os.makedirs(args.out, exist_ok=True)

    cfg = PRESETS[args.preset]
    if args.mapping_skip_frame is not None:
        cfg = cfg.replace(mapping_skip_frame=args.mapping_skip_frame)

    # ---- data source -----------------------------------------------------
    gt_t = gt_q = None
    if args.synthetic or not args.kitti:
        scans, traj = syn.make_sequence(
            args.frames, scan_lines=cfg.scan_lines, seed=7, speed=args.speed)
        frames = ((syn.pad_scan(s, cfg.n_raw) + (float(i) * 0.1,))
                  for i, s in enumerate(scans))
        # --skip-first drops leading scans: drop the matching GT rows so
        # estimated frame i compares against gt frame i+skip, re-anchored
        gt_t = traj.trans[args.skip_first:] - traj.trans[args.skip_first]
        gt_q = traj.quats[args.skip_first:]
    else:
        from aloam_tpu_torch.io import kitti, native_loader
        times_path, gt_path, velo_dir = kitti.sequence_paths(args.kitti,
                                                             args.sequence)
        if gt_path and os.path.exists(gt_path):
            gt_q, gt_t = kitti.load_gt_poses(gt_path)
            gt_q = gt_q[args.skip_first:]
            gt_t = gt_t[args.skip_first:] - gt_t[args.skip_first]
        if native_loader.available():
            times = np.atleast_1d(np.loadtxt(times_path))
            paths = [os.path.join(velo_dir, f"{i:06d}.bin")
                     for i in range(len(times))]
            pf = native_loader.Prefetcher(paths, cfg.n_raw, depth=4,
                                          n_threads=2)
            frames = ((xyz, mask, float(times[i]))
                      for i, (xyz, mask, _refl) in enumerate(pf))
            print("using native C++ prefetcher")
        else:
            frames = ((f.xyz, f.mask, f.timestamp) for f in
                      kitti.iter_sequence(args.kitti, args.sequence,
                                          cfg.n_raw))

    def to_dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    # ---- pipeline --------------------------------------------------------
    step = pipeline.make_step_fn(cfg)
    state = pipeline.init_state(cfg, 1, device)
    if args.resume:
        state = ckpt.load(args.resume, state)
        print(f"resumed from {args.resume}")

    metrics_path = os.path.join(args.out, "metrics.jsonl")
    traj_odom, traj_map, traj_hf, stamps = [], [], [], []
    t_all = TicToc()
    frames = itertools.islice(frames, args.skip_first, None)
    with open(metrics_path, "w") as mf:
        for i, (xyz, mask, ts) in enumerate(frames):
            if i >= args.frames:
                break
            t_frame = TicToc()
            xyz_d, mask_d = to_dev(xyz, np.float32), to_dev(mask, bool)
            if args.dump_rings == i:
                from aloam_tpu_torch.frontend import register_scan_b
                rc, curv, _ = register_scan_b(xyz_d[None], mask_d[None], cfg)
                rpath = os.path.join(args.out, f"rings_{i:06d}.npz")
                np.savez(rpath, xyz=rc.xyz[0].cpu().numpy(),
                         intensity=rc.intensity[0].cpu().numpy(),
                         cnt=rc.cnt[0].cpu().numpy(),
                         curvature=curv[0].cpu().numpy())
                print(f"per-ring debug clouds -> {rpath} "
                      f"({int(rc.cnt.sum())} points, "
                      f"{rc.xyz.shape[1]} rings)")
            state, out = step(state, xyz_d, mask_d)
            # one transfer per frame (it waits for the device)
            packed = torch.cat([out.t_odom, out.t_map, out.q_map, out.t_hf,
                                out.metrics]).cpu().numpy()
            wall = t_frame.toc()
            traj_odom.append(packed[0:3])
            traj_map.append(packed[3:10])
            traj_hf.append(packed[10:13])
            m = dict(zip(pipeline.METRIC_NAMES, packed[13:].tolist()))
            stamps.append(ts)
            rec = {"frame": i, "t": ts, "wall_ms": round(wall, 2)}
            rec.update(m)
            mf.write(json.dumps(rec) + "\n")
            if (m["corner_corr"] + m["plane_corr"]) < 10 and i > 0:
                print(f"frame {i}: less correspondence! "
                      f"({int(m['corner_corr'])}+{int(m['plane_corr'])})")
            if args.surround_every and (i + 1) % args.surround_every == 0:
                c_sur, s_sur = (c[0] for c in
                                mp.extract_surround(state.map, cfg))
                spath = os.path.join(args.out, f"surround_{i + 1:06d}.npz")
                np.savez(spath, corner=c_sur, surf=s_sur)
                print(f"surround ({len(c_sur)}+{len(s_sur)} pts) -> {spath}")
            if args.map_every and (i + 1) % args.map_every == 0:
                c_map, s_map = (c[0] for c in
                                mp.extract_map_cloud(state.map, cfg))
                mpath = os.path.join(args.out, f"map_{i + 1:06d}.npz")
                np.savez(mpath, corner=c_map, surf=s_map)
                print(f"map ({len(c_map)}+{len(s_map)} pts) -> {mpath}")
            if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
                path = os.path.join(args.out, f"state_{i + 1:06d}.npz")
                ckpt.save(path, state)
                print(f"checkpoint -> {path}")

    n = len(traj_map)
    total_ms = t_all.toc()
    walls = []
    with open(metrics_path) as mf2:
        for line in mf2:
            walls.append(json.loads(line)["wall_ms"])
    steady = float(np.median(walls)) if walls else 0.0
    print(f"{n} frames in {total_ms / 1e3:.1f}s on {device} "
          f"(median {steady:.0f} ms/scan = {1e3 / max(steady, 1e-9):.1f} "
          f"scans/s; the first frame includes one-time set-up)")

    # ---- outputs ---------------------------------------------------------
    tm = np.stack(traj_map)
    np.savez(os.path.join(args.out, "trajectory.npz"),
             t_map=tm[:, :3], q_map=tm[:, 3:],
             t_odom=np.stack(traj_odom), t_hf=np.stack(traj_hf),
             stamps=np.asarray(stamps))
    # TUM format: t x y z qx qy qz qw
    with open(os.path.join(args.out, "trajectory_tum.txt"), "w") as f:
        for ts, row in zip(stamps, tm):
            t, q = row[:3], row[3:]
            f.write(f"{ts} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n")

    if gt_t is not None and n > 1:
        summary = {
            "frames": n,
            "median_wall_ms": steady,
            "ate_rmse_m": ate_rmse(tm[:, :3], gt_t[:n], align=False),
        }
        # KITTI-convention RPE/drift (start-pose-anchored relative motion)
        # when GT orientations exist; world increments otherwise
        have_q = gt_q is not None and len(gt_q) >= n
        eq, gq = (tm[:, 3:7], gt_q[:n]) if have_q else (None, None)
        summary["rpe_trans_m"] = rpe(tm[:, :3], gt_t[:n],
                                     est_q=eq, gt_q=gq)[0]
        if have_q:
            summary["rpe_rot_deg"] = rpe_rot(tm[:, 3:7], gt_q[:n])[0]
        drift, n_seg = kitti_drift(tm[:, :3], gt_t[:n], est_q=eq, gt_q=gq)
        if n_seg:
            # KITTI convention: mean translational drift over 100-800 m
            # segments (needs a few hundred meters of trajectory)
            summary["kitti_drift_pct"] = drift
            summary["kitti_drift_segments"] = n_seg
        with open(os.path.join(args.out, "eval.json"), "w") as f:
            json.dump(summary, f, indent=1)
        msg = (f"ATE RMSE {summary['ate_rmse_m']:.4f} m   "
               f"RPE {summary['rpe_trans_m']:.4f} m")
        if "rpe_rot_deg" in summary:
            msg += f"   RPEr {summary['rpe_rot_deg']:.3f} deg"
        if "kitti_drift_pct" in summary:
            msg += (f"   drift {summary['kitti_drift_pct']:.3f}% "
                    f"({summary['kitti_drift_segments']} segs)")
        print(msg)

    if args.plots:
        from aloam_tpu_torch.eval import viz
        paths = {"mapped": tm[:, :3], "odometry": np.stack(traj_odom)}
        if gt_t is not None:
            paths["ground truth"] = gt_t[:n]
        viz.plot_trajectories(paths, os.path.join(args.out, "trajectory.png"))
        corner, surf = (c[0] for c in mp.extract_map_cloud(state.map, cfg))
        if surf.shape[0]:
            viz.plot_map_cloud(np.concatenate([corner, surf]),
                               os.path.join(args.out, "map.png"))
        print(f"plots -> {args.out}")


if __name__ == "__main__":
    main()
