"""Multi-process runtime (port of ``aloam_tpu/parallel/distributed.py``).

The reference's only "distributed backend" is ROS TCP pub/sub on one
machine. Here every process calls :func:`initialize`, which brings up
``torch.distributed`` from the variables ``torchrun`` exports
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), builds one
("data", "model") mesh over all ranks (:func:`global_mesh`) and steps its
own streams (``sharding.batched_step_fn``).

Axis placement: the "data" axis (streams) carries no collective on the
hot path, since each stream's SLAM state is private, so it is the axis to
stretch across hosts. The "model" axis splits the map tables inside
``sharding.batched_step_fn`` (an exchange of knn cache rows every cache
build) and the reference points of ``sharding.sharded_knn``;
:func:`global_mesh` puts it fastest-varying, so a model group is adjacent
ranks (the same host under ``torchrun``).

The backend is NCCL, one card a rank, unless the caller names another:
the CPU tests, and ranks that share one card (NCCL refuses two ranks on
one GPU), pass ``backend="gloo"``.

Single-process use is a no-op: :func:`initialize` skips when the world
size is 1 and no address is set. Run ``python -m
aloam_tpu_torch.parallel.distributed [--device cpu]`` (alone, or under
``torchrun``) for the self-test.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# how long a rank waits for its peers, at the rendezvous and in each
# collective, before it raises
TIMEOUT = datetime.timedelta(minutes=5)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> None:
    """Bring up the default process group (no-op single-process; a second
    call does nothing).

    Arguments default to the variables ``torchrun`` exports:
    ``init_method`` to ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``),
    ``world_size`` to ``WORLD_SIZE`` (1), ``rank`` to ``RANK`` (0).
    ``backend`` defaults to ``nccl``; with it each rank takes the card
    ``LOCAL_RANK`` (else its rank) modulo the cards it sees."""
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None \
            and "MASTER_ADDR" not in os.environ:
        return                       # single-process: nothing to initialize
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: the nccl backend needs a CUDA "
                               "card; CPU ranks pass backend='gloo'")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)


def finish() -> None:
    """The end of a rank, called from the ``finally`` of its main: destroy
    the default process group; while an exception is propagating, print
    it and leave the process at once instead. A CUDA graph that captured
    NCCL collectives must be freed before its group is destroyed: with
    one alive, ``destroy_process_group`` hangs (two or more ranks; torch
    2.11, NCCL 2.28), and a failing rank's traceback keeps its graphs
    alive."""
    exc = sys.exc_info()[1]
    if exc is None:
        dist.destroy_process_group()
        return
    if not isinstance(exc, SystemExit):
        traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(exc.code if isinstance(exc, SystemExit)
             and isinstance(exc.code, int) else 1)


def world() -> tuple[int, int]:
    """(world size, rank): (1, 0) when no process group is up."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def global_mesh(n_model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over all ranks, "model" varying fastest:
    rank r sits at (r // n_model, r % n_model). Needs the process group
    (:func:`initialize`)."""
    size, _ = world()
    if size % n_model:
        raise ValueError(f"global_mesh: {size} ranks do not split into "
                         f"model groups of {n_model}")
    mesh = torch.arange(size).reshape(size // n_model, n_model)
    return DeviceMesh(device_type, mesh, mesh_dim_names=("data", "model"))


def process_local_batch(total_batch: int) -> tuple[int, int]:
    """(local_batch, offset) of this rank's streams: each rank loads and
    steps only its own ``total_batch / world`` streams, from stream
    ``rank · local_batch`` on."""
    size, rank = world()
    if total_batch % size:
        raise ValueError(f"process_local_batch: {total_batch} streams do "
                         f"not split over {size} ranks")
    local = total_batch // size
    return local, rank * local


def free_port() -> int:
    """A TCP port on the loopback interface that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv: list[str], n: int, env: dict | None = None,
          timeout: float = 600.0, cwd: str | None = None) -> list[str]:
    """Run ``argv`` as ranks 0 .. n-1 of a world of ``n`` on this host and
    return their standard outputs in rank order. Each process gets
    ``env`` (default: this process's environment) with MASTER_ADDR
    127.0.0.1, a free MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK.
    Raises ``RuntimeError``, with the rank's output tails, once a rank
    exits non-zero or when any is still running ``timeout`` seconds after
    the start; the other ranks are killed then, and no process outlives
    the call."""
    env = dict(os.environ if env is None else env, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(n))
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(n)]
    procs = []
    try:
        for r, (out, err) in enumerate(logs):
            procs.append(subprocess.Popen(
                argv, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=cwd,
                stdout=out, stderr=err, text=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) \
                and all(p.poll() in (None, 0) for p in procs) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        killed = [p.poll() is None for p in procs]
        for p, kill in zip(procs, killed):
            if kill:
                p.kill()
            p.wait()
    texts = []
    for out, err in logs:
        texts.append([f.seek(0) or f.read() for f in (out, err)])
        out.close()
        err.close()
    # a rank that failed on its own first, else one that was still running
    bad = sorted((kill, r) for r, (p, kill) in enumerate(zip(procs, killed))
                 if p.returncode != 0)
    if bad:
        kill, r = bad[0]
        out, err = texts[r]
        why = (f"was still running after {timeout:g} s" if kill
               else f"exited {procs[r].returncode}")
        raise RuntimeError(f"rank {r} of {n} ({' '.join(argv[1:])}) {why}"
                           f"\n{out[-2000:]}\n{err[-4000:]}")
    return [out for out, _ in texts]


def _selftest(device: str) -> None:
    """Initialize (from the environment; a process run alone forms a world
    of one), build the global mesh and run two sharded steps of the tiny
    config on this rank's streams, the second from the state the first
    returned (on the card: one capture, two replays)."""
    from aloam_tpu_torch import graph
    from aloam_tpu_torch.config import AloamConfig
    from aloam_tpu_torch.io import synthetic as syn
    from aloam_tpu_torch.parallel import sharding

    backend = "gloo" if device == "cpu" else "nccl"
    if "RANK" in os.environ:
        initialize(backend=backend)
    else:
        initialize(init_method=f"tcp://127.0.0.1:{free_port()}",
                   world_size=1, rank=0, backend=backend)
    try:
        dev = torch.device(device) if device == "cpu" \
            else torch.device("cuda", torch.cuda.current_device())
        mesh = global_mesh(1, dev.type)
        cfg = AloamConfig(
            scan_lines=16, minimum_range=0.3,
            line_resolution=0.2, plane_resolution=0.4,
            n_raw=4096, ring_cap=256, less_flat_cap=2048,
            map_table_corner=1024, map_table_surf=2048,
            corner_stack_cap=256, surf_stack_cap=1024)
        batch = mesh.size(0)
        local, off = process_local_batch(batch)
        scans, _ = syn.make_sequence(1, scan_lines=16, n_azimuth=256, seed=0)
        xyz1, mask1 = syn.pad_scan(scans[0], cfg.n_raw)
        xyz = torch.from_numpy(xyz1).to(dev).expand(local, -1, -1)
        mask = torch.from_numpy(mask1).to(dev).expand(local, -1)
        step = sharding.batched_step_fn(cfg, mesh)
        st = sharding.batched_init(cfg, local, dev)
        for _ in range(2):
            st, outs = step(st, xyz.contiguous(), mask.contiguous())
        del step              # its graphs go before the group (finish)
        t_map = sharding.gather_outputs(outs, mesh).t_map
        if not bool(torch.isfinite(t_map).all()):
            raise RuntimeError(f"selftest: non-finite t_map {t_map}")
        print(f"distributed selftest OK: processes={world()[0]} "
              f"mesh=({mesh.size(0)} data x {mesh.size(1)} model) "
              f"local_batch={local}@{off} device={dev} "
              f"captures={graph.captures} replays={graph.replays}",
              flush=True)
    finally:
        finish()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=_selftest.__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    _selftest(ap.parse_args().device)
