"""What the JAX package itself scores on chip_smoke.py's distorted streams:
the witness behind the per-stream limits of chip_smoke.distortion_gates.

For each of chip_smoke.py's distorted scenes (the B = 16 streams, seed
DIST_SEED + b at DIST_SPEED + 0.25 b m/s, and the one stream, seed
DIST_SINGLE_SEED), this runs the JAX package's single-stream step with and
without ``distortion`` over chip_smoke.N_FRAMES frames, at
tests/test_pipeline.py's config and scene size (64 lines, 900 azimuth
steps: the size the JAX tests run on the CPU), and prints per stream the
frame-to-frame translation error from frame 2 on and the aligned mapped
ATE against the sweep ends, computed as chip_smoke.distortion_gates does.
On the CPU, ~20 s a stream:

    JAX_PLATFORMS=cpu python tests/_torch_distortion_witness.py [LO:HI [N]]

LO:HI picks streams by position (the B streams first, then the one); N
sets the number of frames (tests/test_pipeline.py's own test runs
N_DIST = 7: ``16:17 7`` scores that test's scene as it does).
"""

import os
import sys
import time

import jax.numpy as jnp
import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]
import chip_smoke as cs  # noqa: E402
from test_pipeline import CFG  # noqa: E402

from aloam_tpu import pipeline  # noqa: E402
from aloam_tpu.eval import ate_rmse  # noqa: E402
from aloam_tpu.io import synthetic as syn  # noqa: E402


def run(cfg, step, scans):
    st = pipeline.init_state(cfg)
    t_odom, t_map = [], []
    for scan in scans:
        xyz, mask = syn.pad_scan(scan, cfg.n_raw)
        st, out = step(st, jnp.asarray(xyz), jnp.asarray(mask))
        t_odom.append(np.asarray(out.t_odom))
        t_map.append(np.asarray(out.t_map))
    return np.stack(t_odom), np.stack(t_map)


def main():
    n = int(sys.argv[2]) if len(sys.argv) > 2 else cs.N_FRAMES
    streams = [(cs.DIST_SEED + b, cs.DIST_SPEED + 0.25 * b)
               for b in range(cs.B)]
    streams.append((cs.DIST_SINGLE_SEED, cs.DIST_SPEED))
    lo, hi = 0, len(streams)
    if len(sys.argv) > 1:
        lo, hi = map(int, sys.argv[1].split(":"))
    cfgs = {m: CFG.replace(distortion=m) for m in (True, False)}
    steps = {m: pipeline.make_step_fn(c, donate=False)
             for m, c in cfgs.items()}
    for seed, speed in streams[lo:hi]:
        t0 = time.perf_counter()
        scans, traj = syn.make_distorted_sequence(
            n, scan_lines=64, n_azimuth=900, seed=seed, speed=speed,
            yaw_rate=cs.DIST_YAW_RATE, accel=cs.DIST_ACCEL)
        gt_d = np.diff(traj.trans[1:1 + n], axis=0)
        res = {}
        for m in (True, False):
            t_odom, t_map = run(cfgs[m], steps[m], scans)
            d = np.diff(t_odom, axis=0)
            res[m] = (np.linalg.norm(d[2:] - gt_d[2:], axis=1).mean(),
                      ate_rmse(t_map[1:], traj.trans[2:1 + n], align=True))
        print(f"seed {seed} speed {speed:g} m/s: distortion rpe "
              f"{res[True][0]:.4f} m, ate {res[True][1]:.4f} m; rigid rpe "
              f"{res[False][0]:.4f} m, ate {res[False][1]:.4f} m "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
