"""The reference trajectories of the 500-frame drift scene
(tests/test_long_drift.py), saved as data for the port's long-horizon run:
``tests/_torch_drift_ref.npz``, which ``aloam_tpu_torch.drift`` and
chip_smoke.py's [drift] phase read on a machine that has no JAX.

Here, on the CPU (imports JAX, the JAX package and tests.oracle)::

    JAX_PLATFORMS=cpu python tests/_torch_drift_witness.py oracle
    JAX_PLATFORMS=cpu python tests/_torch_drift_witness.py jax

``oracle`` copies the tracked 80-frame resume checkpoint of the f64
oracle (tests/_cache/oracle_drift-scene-v1:200:...npz.ckpt) to a
temporary directory and resumes ``tests.oracle.pipeline.run_pipeline``
from the copy to N_ORACLE (200) frames, with the kwargs of
tests/test_long_drift.py's oracle run (~10 s a frame). The tracked file
is only read: the caching wrapper ``tests.oracle.cache.oracle_trajectory``
deletes it when it finishes, so it is never called here. It saves
``oracle_t_odom``, ``oracle_t_map`` and ``oracle_q_map`` (f64).

``jax`` steps the scene through the JAX package's ``make_step_fn`` and
its ``batched_step_jit`` at B = 1 (the ``step_b`` path) over N_FRAMES
(500) frames (~4 min each), saving per frame ``{jax,jaxb}_t_map``,
``_q_map``, ``_t_odom``, ``_q_odom`` and ``_metrics`` (the packed
vector, in ``pipeline.METRIC_NAMES``' order).

Each subcommand merges its keys into ``--out`` and leaves the others.

On the card (imports only the port)::

    python tests/_torch_drift_witness.py port [--batched] [--frames N]

(``--device cpu`` runs the same on the kernels' plain versions.)

steps the port (``aloam_tpu_torch.drift.run``) and prints frame by frame
its distance to the ground truth, to JAX's mapped position and to the
oracle's, and both packages' mapping factor counts; then per 100 frames
the mean factor-count difference and the largest odometry gap, and each
one's ATE.
"""

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REF = os.path.join(REPO, "tests", "_torch_drift_ref.npz")
CKPT = os.path.join(
    REPO, "tests", "_cache",
    "oracle_drift-scene-v1:200:8.0_973c2b9d02be12c6.npz.ckpt")


def save(out, arrays):
    """Merge ``arrays`` into the npz at ``out`` (written atomically)."""
    old = dict(np.load(out)) if os.path.exists(out) else {}
    old.update(arrays)
    tmp = out + ".tmp.npz"
    np.savez(tmp, **old)
    os.replace(tmp, out)
    print(f"saved {sorted(arrays)} into {out}", flush=True)


def oracle(out):
    from tests.oracle.pipeline import run_pipeline
    from tests.test_long_drift import DRIFT_CFG, N_ORACLE, _render_scene
    _, scans = _render_scene(N_ORACLE)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "oracle.ckpt")
        shutil.copyfile(CKPT, ck)
        t_odom, t_map, q_map = run_pipeline(
            scans, checkpoint_path=ck, scan_lines=16,
            line_res=DRIFT_CFG.line_resolution,
            plane_res=DRIFT_CFG.plane_resolution,
            min_range=DRIFT_CFG.minimum_range)
    save(out, {"oracle_t_odom": t_odom, "oracle_t_map": t_map,
               "oracle_q_map": q_map})


def jax_run(out, frames):
    import jax.numpy as jnp
    from aloam_tpu import pipeline
    from aloam_tpu.io import synthetic as syn
    from aloam_tpu.parallel import batched_init, batched_step_jit
    from tests.test_long_drift import DRIFT_CFG, _render_scene
    cfg = DRIFT_CFG
    names = list(pipeline.METRIC_NAMES)
    _, scans = _render_scene(frames)
    paths = {"jax": (pipeline.make_step_fn(cfg), pipeline.init_state(cfg),
                     False),
             "jaxb": (batched_step_jit(cfg), batched_init(cfg, 1), True)}
    arrays = {}
    for name, (step, state, batched) in paths.items():
        rows = {k: [] for k in ("t_map", "q_map", "t_odom", "q_odom",
                                "metrics")}
        for scan in scans:
            xyz, mask = syn.pad_scan(scan, cfg.n_raw)
            xyz, mask = jnp.asarray(xyz), jnp.asarray(mask)
            if batched:
                xyz, mask = xyz[None], mask[None]
            state, o = step(state, xyz, mask)
            for k in ("t_map", "q_map", "t_odom", "q_odom"):
                v = np.asarray(getattr(o, k))
                rows[k].append(v[0] if batched else v)
            rows["metrics"].append(np.asarray(o.metrics).reshape(-1))
        arrays.update({f"{name}_{k}": np.stack(v) for k, v in rows.items()})
        solved = arrays[f"{name}_metrics"][:, names.index("map_solved")]
        print(f"{name}: {len(scans)} frames, map_solved "
              f"{int(solved.sum())}", flush=True)
    save(out, arrays)


def port(ref, frames, batched, device):
    from aloam_tpu_torch import drift
    from aloam_tpu_torch.eval import ate_rmse
    z = np.load(ref)
    traj, scans = drift.render_scene(frames)
    res = drift.run(drift.DRIFT_CFG, scans, device, batched=batched)
    gt = drift.ground_truth(traj, frames)[0]
    est = res["t_map"]
    pre = "jaxb_" if batched else "jax_"
    jax_t = z[pre + "t_map"][:frames]
    n_o = min(frames, len(z["oracle_t_map"]))
    # the mapping factor counts, port and JAX: where the two part
    cols = [drift.pipeline.METRIC_NAMES.index(n)
            for n in ("map_corner_factors", "map_surf_factors")]
    fac_p = res["metrics"][:, cols].astype(int)
    fac_j = z[pre + "metrics"][:frames, cols].astype(int)
    print("frame  |gt - port|  |jax - port|  corner port/jax  surf "
          "port/jax  |oracle - port|  (m)")
    for f in range(frames):
        o = (f"{np.linalg.norm(z['oracle_t_map'][f] - est[f]):15.4f}"
             if f < n_o else "")
        print(f"{f:5d}  {np.linalg.norm(gt[f] - est[f]):11.4f}  "
              f"{np.linalg.norm(jax_t[f] - est[f]):12.4f}  "
              f"{fac_p[f, 0]:6d}/{fac_j[f, 0]:<6d}  "
              f"{fac_p[f, 1]:6d}/{fac_j[f, 1]:<6d}{o}")
    diff = np.abs(fac_p - fac_j)
    for lo in range(0, frames, drift.BLOCK):
        blk = slice(lo, min(lo + drift.BLOCK, frames))
        odom = np.abs(res["t_odom"][blk] - z[pre + "t_odom"][blk]).max()
        print(f"frames {lo}-{blk.stop - 1}: mean |port - jax| factors "
              f"corner {diff[blk, 0].mean():.1f} of "
              f"{fac_j[blk, 0].mean():.1f}, surf {diff[blk, 1].mean():.1f} "
              f"of {fac_j[blk, 1].mean():.1f}; frames differing "
              f"{int((diff[blk] > 0).any(axis=1).sum())}; largest "
              f"|t_odom gap| {odom:.4g} m")
    print(f"ATE over {frames} frames: port "
          f"{ate_rmse(est, gt, align=False):.4f} m, JAX on the CPU "
          f"{ate_rmse(jax_t, gt, align=False):.4f} m; over {n_o}: oracle "
          f"{ate_rmse(z['oracle_t_map'][:n_o], gt[:n_o], align=False):.4f}"
          f" m, port {ate_rmse(est[:n_o], gt[:n_o], align=False):.4f} m")


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    o = sub.add_parser("oracle")
    o.add_argument("--out", default=REF)
    j = sub.add_parser("jax")
    j.add_argument("--out", default=REF)
    j.add_argument("--frames", type=int, default=500)
    p = sub.add_parser("port")
    p.add_argument("--ref", default=REF)
    p.add_argument("--frames", type=int, default=500)
    p.add_argument("--batched", action="store_true")
    p.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.mode == "oracle":
        oracle(args.out)
    elif args.mode == "jax":
        jax_run(args.out, args.frames)
    else:
        port(args.ref, args.frames, args.batched, args.device)


if __name__ == "__main__":
    main()
