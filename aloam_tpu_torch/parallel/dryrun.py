"""The multi-rank dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``).

:func:`dryrun_multichip` starts ``n_ranks`` processes; each runs
:func:`run_rank`, which steps its own streams over a ("data" = n_ranks,
"model" = 1) mesh, holds the gathered trajectories against the unsharded
step on rank 0, and then runs ``sharded_knn`` over a (1, n_ranks) mesh of
the same ranks against the dense ``knn``. Rank 0 prints three OK lines:
the trajectory match, the sharded kNN, and the dry run.

The JAX dry run also asserts that the map tables are partitioned over
"model" and prints a line for it; that check waits for the model-axis
table partition (ROADMAP queue 1), since the port's sharded step runs
only with n_model = 1. Unlike the JAX dry run, which steps one stream a
device, each rank steps two streams.

    python -m aloam_tpu_torch.parallel.dryrun --ranks 4 --device cpu
    torchrun --nproc-per-node 4 -m aloam_tpu_torch.parallel.dryrun --device cpu

Run alone, the module starts the ranks itself; under ``torchrun`` (or any
launcher that exports ``RANK``) it is one of them. On the card each rank
needs its own GPU (NCCL); the CPU ranks talk through gloo.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.io import synthetic as syn
from aloam_tpu_torch.neighbors import knn
from aloam_tpu_torch.parallel import distributed
from aloam_tpu_torch.parallel.sharding import (
    batched_init, batched_step_fn, batched_step_jit, gather_outputs,
    make_mesh, model_shard, sharded_knn)

N_FRAMES = 3
STREAMS_PER_RANK = 2
# the JAX dry run's bound: a placement or offset bug moves a stream by
# decimetres; the same program on other stream counts rounds otherwise
# only where the lm_fused cluster plan changes with B
TRAJ_ATOL = 1.5e-2


def dryrun_cfg() -> AloamConfig:
    """HDL-64-like shapes at the JAX dry run's reduced capacities."""
    return AloamConfig(
        scan_lines=64, minimum_range=0.3,
        line_resolution=0.2, plane_resolution=0.4,
        n_raw=16384, ring_cap=320, less_flat_cap=8192,
        map_table_corner=2048, map_table_surf=4096,
        corner_stack_cap=512, surf_stack_cap=2048)


def dryrun_streams(cfg: AloamConfig, ids, device):
    """(F, len(ids), n_raw, 3) xyz and (F, len(ids), n_raw) mask of the
    DISTINCT streams ``ids`` (seed 30 + b, 1 + 0.5 b m/s, 64 lines, 256
    azimuth steps)."""
    xyz = np.zeros((N_FRAMES, len(ids), cfg.n_raw, 3), np.float32)
    mask = np.zeros((N_FRAMES, len(ids), cfg.n_raw), bool)
    for i, b in enumerate(ids):
        scans, _ = syn.make_sequence(N_FRAMES, scan_lines=64, n_azimuth=256,
                                     seed=30 + b, speed=1.0 + 0.5 * b)
        for f, s in enumerate(scans):
            xyz[f, i], mask[f, i] = syn.pad_scan(s, cfg.n_raw)
    return torch.from_numpy(xyz).to(device), torch.from_numpy(mask).to(device)


def _trajectory(step, cfg, batch, xyz, mask, device, mesh=None):
    """t_map (B, F, 3) of ``step`` over the frames from fresh streams;
    with a mesh, gathered over its data group."""
    st = batched_init(cfg, batch, device)
    traj = []
    for f in range(N_FRAMES):
        st, outs = step(st, xyz[f], mask[f])
        traj.append((outs if mesh is None
                     else gather_outputs(outs, mesh)).t_map)
    return torch.stack(traj, dim=1).cpu().numpy()


def check_sharded_knn(mesh, q, refs, mask, k: int = 5) -> None:
    """``sharded_knn`` over ``mesh``'s model group, each rank passing its
    ``model_shard`` of the refs, against the dense ``knn`` on all of them:
    raises ``RuntimeError`` unless d2 and indices are equal."""
    d2, idx = sharded_knn(mesh, k)(q, model_shard(refs, mesh),
                                   model_shard(mask, mesh))
    dd, di = knn(q, refs, mask, k)
    if not (torch.equal(idx, di) and torch.equal(d2, dd)):
        raise RuntimeError(
            f"sharded_knn differs from the dense knn: {int((idx != di).sum())}"
            f" of {idx.numel()} indices, {int((d2 != dd).sum())} distances")


def run_rank(device_type: str) -> None:
    """One rank's part of the dry run; needs the process group
    (``distributed.initialize``)."""
    size, rank = distributed.world()
    device = torch.device("cpu") if device_type == "cpu" \
        else torch.device("cuda", torch.cuda.current_device())
    cfg = dryrun_cfg()
    batch = STREAMS_PER_RANK * size
    local, off = distributed.process_local_batch(batch)

    mesh = make_mesh(size, 1, device_type)
    xyz, mask = dryrun_streams(cfg, range(off, off + local), device)
    sharded = _trajectory(batched_step_fn(cfg, mesh), cfg, local, xyz, mask,
                          device, mesh)
    if sharded.shape != (batch, N_FRAMES, 3):
        raise RuntimeError(f"gathered t_map {sharded.shape}")
    if rank == 0:
        xyz, mask = dryrun_streams(cfg, range(batch), device)
        unsharded = _trajectory(batched_step_jit(cfg, donate=False), cfg,
                                batch, xyz, mask, device)
        err = float(np.abs(sharded - unsharded).max())
        if not err <= TRAJ_ATOL:
            raise RuntimeError(f"sharded trajectories differ from the "
                               f"unsharded step by {err:.3e} m")
        print(f"trajectory match OK: frames={N_FRAMES}, streams={batch}, "
              f"max |sharded - unsharded| = {err:.2e} m", flush=True)

    # the reference points split over "model", merged by an all_gather
    kmesh = make_mesh(1, size, device_type)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(128, 3)).astype(np.float32))
    ref = torch.from_numpy(rng.normal(size=(1024, 3)).astype(np.float32))
    check_sharded_knn(kmesh, q.to(device), ref.to(device),
                      torch.ones(1024, dtype=torch.bool, device=device))
    if rank == 0:
        print(f"sharded knn OK: mesh=(1 data x {size} model), Q=128, "
              f"M=1024, k=5, equal to the dense knn", flush=True)
        print(f"dryrun_multichip OK: mesh=({size} data x 1 model), "
              f"batch={batch}", flush=True)


def dryrun_multichip(n_ranks: int, device: str = "cuda",
                     timeout: float = 600.0) -> str:
    """Run the dry run over ``n_ranks`` processes on this host (gloo on
    the CPU, NCCL with one card a rank). Raises ``RuntimeError`` if a rank
    exits non-zero or is still running after ``timeout`` seconds; returns
    rank 0's output, which it also prints."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"dryrun_multichip: device {device!r}")
    if device == "cuda" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip: {n_ranks} NCCL ranks need "
                         f"{n_ranks} cards, {torch.cuda.device_count()} "
                         f"found")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    try:
        out = distributed.spawn(
            [sys.executable, "-m", "aloam_tpu_torch.parallel.dryrun",
             "--device", device], n_ranks, env, timeout, cwd=root)[0]
    except RuntimeError as e:
        raise RuntimeError(f"dryrun_multichip: {e}") from None
    print(out, end="", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2,
                    help="processes to start (ignored under a launcher)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if "RANK" not in os.environ:
        dryrun_multichip(args.ranks, args.device)
        return
    distributed.initialize(backend="gloo" if args.device == "cpu"
                           else "nccl")
    try:
        run_rank(args.device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
