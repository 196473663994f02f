"""Worker process for tests/test_torch_parallel.py: one rank of the
port's multi-process runtime over gloo.

Run as ``python tests/_torch_mp_worker.py <mode> <dir>`` with
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set, as
``torchrun`` sets them; ``distributed.initialize()`` reads them. Modes:

* ``knn``: ``sharded_knn`` over a (1, world) mesh on every case of
  ``<dir>/knn_in.npz`` (query ``q<i>``, refs ``r<i>``, mask ``m<i>``);
  writes ``knn_out_<rank>.npz`` (``d<i>``, ``i<i>``, and ``refused``,
  the error ``batched_step_fn`` raises on that mesh for a corner table
  of world / 2 rows, which the model ranks do not divide).
* ``step``: ``batched_step_fn`` over a (world, 1) mesh on this rank's
  streams of ``<dir>/step_in.npz`` (xyz (F, B, n, 3), mask (F, B, n)) at
  the tiny config; writes the gathered outputs of every frame to
  ``step_out_<rank>.npz``.
* ``table``: ``batched_step_fn`` over a (world / 2, 2) mesh, each model
  rank holding half of its data group's map tables, on the data group's
  streams of ``<dir>/step_in.npz``, each frame from the state the
  function returned, then the same frames through its eager body
  (``.step``) from a fresh state; writes to ``table_out_<rank>.npz`` the
  data group's outputs of every frame of both runs (not gathered; the
  eager body's as ``eager_<name>_<f>``), ``captured`` (whether the
  function would capture on a card: not on gloo), ``eager_tables_equal``
  (the two runs' table parts bit for bit), the shapes of the rank's
  table leaves, the whole tables (``gather_tables``) after the last
  frame, and ``round_trip``: whether ``shard_tables`` of them gives the
  rank's own part back.
* ``mp``: an ``all_reduce`` of rank + 1 over the "data" axis, then one
  sharded step on this rank's own stream; prints ``MP_OK <rank> <sum>``.

It imports torch, numpy and the port, never ``jax`` or ``aloam_tpu``:
it proves that the port runs without them.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from aloam_tpu_torch.config import AloamConfig  # noqa: E402
from aloam_tpu_torch.io import synthetic as syn  # noqa: E402
from aloam_tpu_torch.parallel import (  # noqa: E402
    batched_init, batched_step_fn, distributed, gather_outputs,
    gather_tables, make_mesh, model_shard, shard_tables, sharded_knn)

OUTPUTS = ("q_odom", "t_odom", "q_map", "t_map", "q_hf", "t_hf", "metrics")
# tests/test_sharding.py's tiny config
CFG = AloamConfig(
    scan_lines=16, minimum_range=0.3,
    line_resolution=0.2, plane_resolution=0.4,
    n_raw=4096, ring_cap=256, less_flat_cap=2048,
    map_table_corner=1024, map_table_surf=2048,
    corner_stack_cap=256, surf_stack_cap=1024,
)


def run_knn(d: str, size: int, rank: int) -> None:
    mesh = make_mesh(1, size, "cpu")
    out = {}
    try:
        batched_step_fn(CFG.replace(map_table_corner=size // 2), mesh)
    except ValueError as e:       # the table does not split over "model"
        out["refused"] = np.array(str(e))
    knn = sharded_knn(mesh, k=5)
    with np.load(os.path.join(d, "knn_in.npz")) as z:
        for i in range(len(z.files) // 3):
            q, r, m = (torch.from_numpy(z[f"{c}{i}"]) for c in "qrm")
            d2, idx = knn(q, model_shard(r, mesh), model_shard(m, mesh))
            out[f"d{i}"], out[f"i{i}"] = d2.numpy(), idx.numpy()
    np.savez(os.path.join(d, f"knn_out_{rank}.npz"), **out)


def run_step(d: str, size: int, rank: int) -> None:
    mesh = make_mesh(size, 1, "cpu")
    with np.load(os.path.join(d, "step_in.npz")) as z:
        xyz, mask = z["xyz"], z["mask"]
    local, off = distributed.process_local_batch(xyz.shape[1])
    step = batched_step_fn(CFG, mesh)
    st = batched_init(CFG, local, "cpu")
    out = {}
    for f in range(xyz.shape[0]):
        st, o = step(st, torch.from_numpy(xyz[f, off:off + local]),
                     torch.from_numpy(mask[f, off:off + local]))
        g = gather_outputs(o, mesh)
        for name in OUTPUTS:
            out[f"{name}_{f}"] = getattr(g, name).numpy()
    np.savez(os.path.join(d, f"step_out_{rank}.npz"), **out)


def run_table(d: str, size: int, rank: int) -> None:
    mesh = make_mesh(size // 2, 2, "cpu")
    with np.load(os.path.join(d, "step_in.npz")) as z:
        xyz, mask = z["xyz"], z["mask"]
    local = xyz.shape[1] // mesh.size(0)
    off = mesh.get_local_rank("data") * local
    step = batched_step_fn(CFG, mesh)
    out, states = {"captured": np.array(step.capture)}, {}
    for run, fn in (("", step), ("eager_", step.step)):
        st = batched_init(CFG, local, "cpu", mesh)
        for f in range(xyz.shape[0]):
            st, o = fn(st, torch.from_numpy(xyz[f, off:off + local]),
                       torch.from_numpy(mask[f, off:off + local]))
            for name in OUTPUTS:
                out[f"{run}{name}_{f}"] = getattr(o, name).numpy()
        states[run] = st
    st, eager = states[""], states["eager_"]
    out["eager_tables_equal"] = np.array(all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip((*st.map.corner, *st.map.surf),
                        (*eager.map.corner, *eager.map.surf))))
    whole = gather_tables(st, mesh)
    back = shard_tables(whole, mesh).map
    out["round_trip"] = np.array(all(
        torch.equal(a, b)
        for g, h in ((st.map.corner, back.corner), (st.map.surf, back.surf))
        for a, b in zip(g, h)))
    whole = whole.map
    for kind in ("corner", "surf"):
        for leaf in ("pts", "aux"):
            out[f"shape_{kind}_{leaf}"] = np.array(
                getattr(getattr(st.map, kind), leaf).shape)
            out[f"{kind}_{leaf}"] = getattr(getattr(whole, kind),
                                            leaf).numpy()
    np.savez(os.path.join(d, f"table_out_{rank}.npz"), **out)


def run_mp(size: int, rank: int) -> None:
    mesh = distributed.global_mesh(1, "cpu")
    if mesh.size(0) != size:
        raise RuntimeError(f"mesh {mesh.mesh.tolist()} for {size} ranks")
    local, off = distributed.process_local_batch(size)
    if (local, off) != (1, rank):
        raise RuntimeError(f"process_local_batch: {(local, off)}")
    v = torch.full((128,), float(rank + 1))
    dist.all_reduce(v, group=mesh.get_group("data"))
    if not bool((v == v[0]).all()):
        raise RuntimeError(f"all_reduce: {v}")
    scans, _ = syn.make_sequence(1, scan_lines=16, n_azimuth=256,
                                 seed=10 + rank)
    xyz, mask = (torch.from_numpy(a)[None]
                 for a in syn.pad_scan(scans[0], CFG.n_raw))
    _, outs = batched_step_fn(CFG, mesh)(batched_init(CFG, 1, "cpu"), xyz,
                                         mask)
    t_map = gather_outputs(outs, mesh).t_map
    if t_map.shape != (size, 3) or not bool(torch.isfinite(t_map).all()):
        raise RuntimeError(f"t_map {t_map}")
    print(f"MP_OK {rank} {float(v[0])}", flush=True)


def main() -> None:
    mode, d = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    distributed.initialize(backend="gloo")
    size, rank = distributed.world()
    try:
        if mode == "knn":
            run_knn(d, size, rank)
        elif mode == "step":
            run_step(d, size, rank)
        elif mode == "table":
            run_table(d, size, rank)
        elif mode == "mp":
            run_mp(size, rank)
        else:
            raise ValueError(f"mode {mode!r}")
    finally:
        distributed.finish()


if __name__ == "__main__":
    main()
