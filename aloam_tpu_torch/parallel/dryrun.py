"""The multi-rank dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``).

:func:`dryrun_multichip` starts ``n_ranks`` processes; each runs
:func:`run_rank` on the JAX dry run's mesh: ("data" = n_ranks / 2,
"model" = 2) when n_ranks is even and at least 4, else (n_ranks, 1).
Each model group steps its own two streams, with each rank holding its
part of their map tables. Every rank asserts that its table leaves are
its part, (B / n_data, H / n_model, ·), and that the parts' bytes times
the ranks make the whole; rank 0 holds the gathered trajectories against
the unsharded step. Then ``sharded_knn`` runs over a (1, n_ranks) mesh of
the same ranks against the dense ``knn``. Both run through the compiled
entry points: over NCCL the sharded step and ``sharded_knn`` are
captured into CUDA graphs, collectives included, and replayed
(``parallel.graphed``); over gloo they run eagerly. Rank 0 prints five
OK lines: the table partition, the trajectory match, the sharded kNN,
the graphs it captured and replayed (``graph.captures``,
``graph.replays``), and the dry run. Unlike the JAX dry run, which steps
one stream a data rank, each model group steps two streams.

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

from aloam_tpu_torch import graph
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.io import synthetic as syn
from aloam_tpu_torch.neighbors import knn
from aloam_tpu_torch.parallel import distributed
from aloam_tpu_torch.parallel.sharding import (
    batched_init, batched_step_fn, batched_step_jit, gather_outputs,
    make_mesh, model_shard, sharded_knn)

N_FRAMES = 3
STREAMS_PER_GROUP = 2   # streams each model group steps
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
    """t_map (B, F, 3) of ``step`` over the frames from fresh streams (with
    a mesh: this rank's part of their tables, the trajectories gathered
    over its data group), and the final state."""
    st = batched_init(cfg, batch, device, mesh)
    traj = []
    for f in range(N_FRAMES):
        st, outs = step(st, xyz[f], mask[f])
        traj.append((outs if mesh is None
                     else gather_outputs(outs, mesh)).t_map)
    return torch.stack(traj, dim=1).cpu().numpy(), st


def check_partition(state, cfg: AloamConfig, mesh, batch: int) -> tuple:
    """The JAX dry run's partition assert on this rank: every map table
    leaf is (batch / n_data, H / n_model, ·), and the bytes of one rank's
    parts times the ranks equal the whole tables'. Raises
    ``RuntimeError``; returns (this rank's bytes, the whole's)."""
    n_data, n_model = mesh.size(0), mesh.size(1)
    part = whole = 0
    for kind, g, h in (("corner", state.map.corner, cfg.map_table_corner),
                       ("surf", state.map.surf, cfg.map_table_surf)):
        for leaf in g:
            want = (batch // n_data, h // n_model, leaf.shape[-1])
            if tuple(leaf.shape) != want:
                raise RuntimeError(
                    f"{kind} table NOT partitioned: this rank's part "
                    f"{tuple(leaf.shape)}, expected {want} on a ({n_data} "
                    f"data x {n_model} model) mesh")
            part += leaf.nbytes
            whole += batch * h * leaf.shape[-1] * leaf.element_size()
    if part * n_data * n_model != whole:
        raise RuntimeError(f"table bytes {part} a rank x {n_data * n_model} "
                           f"ranks != {whole}")
    return part, whole


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
    n_model = 2 if size % 2 == 0 and size >= 4 else 1
    n_data = size // n_model
    batch = STREAMS_PER_GROUP * n_data
    mesh = make_mesh(n_data, n_model, device_type)
    off = mesh.get_local_rank("data") * STREAMS_PER_GROUP

    xyz, mask = dryrun_streams(cfg, range(off, off + STREAMS_PER_GROUP),
                               device)
    sharded, st = _trajectory(batched_step_fn(cfg, mesh), cfg,
                              STREAMS_PER_GROUP, xyz, mask, device, mesh)
    if sharded.shape != (batch, N_FRAMES, 3):
        raise RuntimeError(f"gathered t_map {sharded.shape}")
    part, whole = check_partition(st, cfg, mesh, batch)
    if rank == 0:
        print(f"map tables partitioned OK: {part / 2 ** 20:.2f} MiB per "
              f"device (= {whole / 2 ** 20:.2f} MiB total / {size} devices)",
              flush=True)
        xyz, mask = dryrun_streams(cfg, range(batch), device)
        unsharded, _ = _trajectory(batched_step_jit(cfg, donate=False), cfg,
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
    # on the card each compiled entry point captured: the sharded step
    # (one graph of its one gate branch) and sharded_knn, and on rank 0
    # the unsharded step
    want = (3 if rank == 0 else 2) if device.type == "cuda" else 0
    if graph.captures != want:
        raise RuntimeError(f"{graph.captures} graphs captured, expected "
                           f"{want} on {device}")
    if rank == 0:
        print(f"sharded knn OK: mesh=(1 data x {size} model), Q=128, "
              f"M=1024, k=5, equal to the dense knn", flush=True)
        print(f"graphs OK: captures={graph.captures} "
              f"replays={graph.replays} ({'captured' if want else 'eager'}"
              f" on {device.type})", flush=True)
        print(f"dryrun_multichip OK: mesh=({n_data} data x {n_model} "
              f"model), batch={batch}", flush=True)


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
        run_rank(args.device)      # its graphs are freed as it returns
    finally:
        distributed.finish()


if __name__ == "__main__":
    main()
