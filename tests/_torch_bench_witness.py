"""Per-stream mapped trajectories of the port's bench streams, and JAX's
run of one such stream on the CPU, frame by frame: the witness for a
stream whose ATE misses ``BENCH_r05.json``'s gate.

On the card (imports only the port)::

    python tests/_torch_bench_witness.py port --batch 16 32 \\
        --out bench_streams.npz

runs ``aloam_tpu_torch.bench.run_batched`` at each B over
BENCH_BATCH_FRAMES (32) timed frames at ``batched_bench_cfg()``, as the
bench does, and saves each stream's mapped positions, ground truth and
ATE; it prints each B's worst streams.

Here, on the CPU (imports JAX and the JAX package's ``bench.py``)::

    JAX_PLATFORMS=cpu python tests/_torch_bench_witness.py jax \\
        --port bench_streams.npz --batch 16 --stream 7

steps stream b alone (seed 100 + b, ``bench._stream_speed(b)``) through
the JAX package's jitted ``step_b`` at its ``batched_bench_cfg()`` over
the same frames (2 warm-up frames, then the timed ones), and prints per
frame the ground truth's distance to each package's position and the
two packages' distance to each other, then both ATEs. The JAX step runs
on the CPU with its XLA paths, where a stream does not depend on B.
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def port(batches, out):
    import torch
    from aloam_tpu_torch import bench
    from aloam_tpu_torch.eval import ate_rmse
    torch.backends.cuda.matmul.allow_tf32 = False
    n = int(os.environ.get("BENCH_BATCH_FRAMES", "32"))
    arrays = {}
    for b in batches:
        _, est, gt = bench.run_batched(bench.batched_bench_cfg(), b, n,
                                       torch.device("cuda"))
        ates = np.array([ate_rmse(est[s], gt[s], align=False)
                         for s in range(b)])
        arrays.update({f"est_b{b}": est, f"gt_b{b}": gt, f"ate_b{b}": ates})
        worst = np.argsort(ates)[::-1][:4]
        print(f"B={b}: ATE max {ates.max():.4f} median "
              f"{np.median(ates):.4f}; worst streams "
              + ", ".join(f"{s} ({ates[s]:.4f})" for s in worst),
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **arrays)


def jax_run(port_npz, batch, stream):
    import jax.numpy as jnp
    import bench
    from aloam_tpu.eval import ate_rmse
    from aloam_tpu.parallel import batched_init, batched_step_jit
    z = np.load(port_npz)
    est_p, gt_p = z[f"est_b{batch}"][stream], z[f"gt_b{batch}"][stream]
    n = est_p.shape[0]
    cfg = bench.batched_bench_cfg()
    xyz, mask, gt = bench._cached_sequence(n + 2, 100 + stream,
                                           bench._stream_speed(stream))
    xyz, mask = xyz[:, :cfg.n_raw], mask[:, :cfg.n_raw]
    step = batched_step_jit(cfg, donate=True)
    state = batched_init(cfg, 1)
    est_j = []
    for f in range(n + 2):
        state, out = step(state, jnp.asarray(xyz[f][None]),
                          jnp.asarray(mask[f][None]))
        est_j.append(np.asarray(out.t_map)[0])
    est_j = np.stack(est_j)[2:]
    if not np.array_equal(gt[2:2 + n], gt_p):
        raise SystemExit("the scenes differ: not the same stream")
    print("frame  |gt - port|  |gt - jax|  |port - jax|  (m)")
    for f in range(n):
        print(f"{f + 2:5d}  {np.linalg.norm(gt_p[f] - est_p[f]):10.4f}  "
              f"{np.linalg.norm(gt_p[f] - est_j[f]):10.4f}  "
              f"{np.linalg.norm(est_p[f] - est_j[f]):11.4f}")
    print(f"stream {stream} at B={batch}: ATE port "
          f"{ate_rmse(est_p, gt_p, align=False):.4f} m, JAX on the CPU "
          f"{ate_rmse(est_j, gt_p, align=False):.4f} m")


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("port")
    p.add_argument("--batch", type=int, nargs="+", default=[16])
    p.add_argument("--out", default="bench_streams.npz")
    j = sub.add_parser("jax")
    j.add_argument("--port", default="bench_streams.npz")
    j.add_argument("--batch", type=int, default=16)
    j.add_argument("--stream", type=int, required=True)
    args = ap.parse_args()
    if args.mode == "port":
        port(args.batch, args.out)
    else:
        jax_run(args.port, args.batch, args.stream)


if __name__ == "__main__":
    main()
