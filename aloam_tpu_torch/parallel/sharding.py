"""Multi-rank scaling: streams split across ranks, and the sharded
neighbour search (port of ``aloam_tpu/parallel/sharding.py``).

The reference's only concurrency is three OS processes on one machine
(SURVEY.md §2.4). The port scales over ``torch.distributed`` ranks on a
("data", "model") ``DeviceMesh``:

* **Streams over "data".** Each rank steps its own ``B / n_data``
  streams with ``pipeline.step_b``: every stream's state (pose, last
  features, map tables) is private, so no collective runs on the hot
  path. :func:`gather_outputs` collects the per-stream outputs in global
  stream order for logging and tests.
* **The reference points over "model"** in :func:`sharded_knn`: each
  rank takes the local top-k of its slice of the refs, and the partial
  results merge after an ``all_gather`` over the model group.

The JAX package also partitions the map tables' hash-bucket axis over
"model" inside its sharded step, leaving GSPMD to derive the collectives.
PyTorch has no compiler to derive them: every table access (the bucket
row gathers, the kernels that read and write the table in place, the
evict clear) would need its own row exchange over the model group. That
is not ported yet (ROADMAP queue 1, "the model-axis table partition"), so
:func:`batched_step_fn` refuses a mesh with n_model > 1.
``pin_table_layouts``, an XLA layout knob, has no counterpart.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aloam_tpu_torch import pipeline
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.neighbors import knn, smallest_k
from aloam_tpu_torch.parallel.distributed import world


def make_mesh(n_data: int, n_model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the first n_data·n_model ranks,
    "model" varying fastest. Every rank of the world calls it (it creates
    the mesh's process groups)."""
    n = n_data * n_model
    size, _ = world()
    if size < n:
        raise ValueError(f"make_mesh: need {n} ranks, have {size}")
    return DeviceMesh(device_type, torch.arange(n).reshape(n_data, n_model),
                      mesh_dim_names=("data", "model"))


def batched_init(cfg: AloamConfig, batch: int, device) -> pipeline.SlamState:
    """The SLAM state of ``batch`` fresh streams (``pipeline.init_state``)."""
    return pipeline.init_state(cfg, batch, device)


def _clone_tables(state: pipeline.SlamState) -> pipeline.SlamState:
    m = state.map
    return state._replace(map=m._replace(
        corner=m.corner._replace(pts=m.corner.pts.clone(),
                                 aux=m.corner.aux.clone()),
        surf=m.surf._replace(pts=m.surf.pts.clone(),
                             aux=m.surf.aux.clone())))


def batched_step_jit(cfg: AloamConfig, donate: bool = True):
    """``pipeline.step_b`` with the config bound: f(state, xyz (B, n_raw,
    3), mask (B, n_raw)) -> (state, SlamOutputs), on one device with no
    mesh. PyTorch runs eagerly, so nothing is compiled; the name is the
    JAX package's. ``step_b`` updates the map tables in place, which
    consumes the state passed in as JAX's donated state is consumed; with
    ``donate=False`` the step works on clones of the tables and the
    caller's state stays usable, as JAX's undonated input does."""
    def f(state, xyz, mask):
        if not donate:
            state = _clone_tables(state)
        return pipeline.step_b(state, xyz, mask, cfg)
    return f


def batched_step_fn(cfg: AloamConfig, mesh: DeviceMesh):
    """The batched step of one rank of the mesh's "data" axis: f(state,
    xyz, mask) -> (state, SlamOutputs), where ``state``, ``xyz`` (B_local,
    n_raw, 3) and ``mask`` (B_local, n_raw) are this rank's ``B /
    n_data`` streams (``distributed.process_local_batch``) and the
    outputs are too (:func:`gather_outputs` assembles the global ones).
    The ranks exchange nothing: every stream's state is private. The map
    tables update in place, as in ``pipeline.step_b``.

    Raises ``ValueError`` for n_model > 1 (the table partition, module
    docstring) and on a rank outside the mesh."""
    if mesh.size(1) > 1:
        raise ValueError(
            "batched_step_fn: n_model > 1 would partition the map tables' "
            "hash-bucket axis over the model group, which the port does not "
            "do yet (ROADMAP queue 1, 'the model-axis table partition'); use "
            "an (n_data, 1) mesh")
    if mesh.get_coordinate() is None:
        raise ValueError(f"batched_step_fn: rank {dist.get_rank()} is not "
                         f"in the mesh {mesh.mesh.tolist()}")

    def f(state, xyz, mask):
        if not xyz.shape[0] == mask.shape[0] == state.odom.q_w.shape[0]:
            raise ValueError(
                f"batched_step_fn: {xyz.shape[0]} scans and "
                f"{mask.shape[0]} masks for {state.odom.q_w.shape[0]} "
                f"local streams")
        return pipeline.step_b(state, xyz, mask, cfg)
    return f


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(S, ·) stack of every group rank's ``t`` in group rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def gather_outputs(outs: pipeline.SlamOutputs,
                   mesh: DeviceMesh) -> pipeline.SlamOutputs:
    """The data group's SlamOutputs in global stream order: every tensor
    (B_local, ·) becomes (n_data · B_local, ·), stream ``rank · B_local +
    b`` at its place. Every rank of the data group gets the same."""
    group = mesh.get_group("data")

    def gather(t):
        if t is None:
            return None
        g = _all_gather(t, group)
        return g.reshape((-1,) + tuple(t.shape[1:]))
    return pipeline.SlamOutputs(*map(gather, outs))


def model_shard(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of ``x`` along the "model" axis: the
    ``M / n_model`` rows from ``model rank · M / n_model`` on. Raises
    unless n_model divides M, as the JAX package's ``P("model")``
    requires."""
    n = mesh.size(1)
    if x.shape[0] % n:
        raise ValueError(f"model_shard: {x.shape[0]} rows do not split "
                         f"over {n} model ranks")
    rows = x.shape[0] // n
    lo = mesh.get_local_rank("model") * rows
    return x[lo:lo + rows]


def sharded_knn(mesh: DeviceMesh, k: int = 5):
    """k-NN with the reference points split over the "model" axis:
    f(query (Q, 3), ref (M_local, 3), ref_mask (M_local,)) -> (d2 (Q, k),
    idx (Q, k) int64), where every model rank passes the same query and
    its own ``M / n_model`` rows of the refs (:func:`model_shard`).

    Each rank takes its local top-k (``neighbors.knn``) and offsets the
    indices to the global rows; the (Q, k) partials are ``all_gather``-ed
    over the model group and merged in shard-major order, equal distances
    keeping that order, so every rank returns the same result as the
    dense ``knn`` over all M rows, indices included. (A query with fewer
    than k valid refs has +inf slots, whose indices follow the path each
    search took: the lowest masked rows from a dense block, 0 from
    ``knn_streamed``.) Communication is O(Q·k·n_model), not O(M)."""
    def f(query, ref, ref_mask):
        group = mesh.get_group("model")
        d2, idx = knn(query, ref, ref_mask, k)
        idx = idx + mesh.get_local_rank("model") * ref.shape[0]
        d_all, i_all = _all_gather(d2, group), _all_gather(idx, group)
        s, nq, _ = d_all.shape
        d_flat = d_all.movedim(0, 1).reshape(nq, s * k)
        i_flat = i_all.movedim(0, 1).reshape(nq, s * k)
        return smallest_k(d_flat, i_flat, k)
    return f
