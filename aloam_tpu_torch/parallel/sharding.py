"""Multi-rank scaling: streams split across ranks, the map tables split
within a rank group, and the sharded neighbour search (port of
``aloam_tpu/parallel/sharding.py``).

The reference's only concurrency is three OS processes on one machine
(SURVEY.md §2.4). The port scales over ``torch.distributed`` ranks on a
("data", "model") ``DeviceMesh``:

* **Streams over "data".** Each model group steps its own ``B /
  n_data`` streams with ``pipeline.step_b``: every stream's state (pose,
  last features, map tables) is private, so no collective crosses the
  data axis on the hot path. :func:`gather_outputs` collects the
  per-stream outputs in global stream order for logging and tests.
* **The map tables over "model"** in :func:`batched_step_fn`, the JAX
  package's ``P("data", "model")`` on every table leaf: model rank r
  holds rows [r·H/n, (r+1)·H/n) of each of its streams' H-row tables
  (:func:`shard_tables`, :func:`gather_tables`), so a group holds a map
  n_model times one rank's memory. Everything else is replicated across
  the group, which runs the same step on the same streams. GSPMD derives
  the JAX package's collectives; here ``ops/gridmap.TableShard`` names
  them: the knn cache's bucket rows come from their owners (one int32
  ``all_reduce`` a cache build), the evict and the insert touch only the
  owned rows, and their counts are summed over the group. Every rank of
  the group gets the whole-table step's outputs bit for bit.
* **The reference points over "model"** in :func:`sharded_knn`: each
  rank takes the local top-k of its slice of the refs, and the partial
  results merge after an ``all_gather`` over the model group.

Both entry points are compiled, as the JAX package jits them:
:func:`batched_step_fn` is a ``graph.StepGraph`` and :func:`sharded_knn`
a ``graph.FnGraph``, captured into CUDA graphs with their collectives
where :func:`graphed` allows it.

``pin_table_layouts``, an XLA layout knob, has no counterpart.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aloam_tpu_torch import pipeline
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.graph import FnGraph, StepGraph
from aloam_tpu_torch.neighbors import knn, smallest_k
from aloam_tpu_torch.ops.gridmap import TableShard
from aloam_tpu_torch.parallel.distributed import world


def graphed(device_type: str, n_model: int, backend: str | None) -> bool:
    """The capture rule of the sharded entry points: whether a call on a
    ``device_type`` tensor captures a CUDA graph, for a mesh of
    ``n_model`` model ranks whose model group runs ``backend``. On a CUDA
    device it captures when the body issues no collective (n_model 1) or
    the model group is NCCL's, whose collectives a graph holds; a gloo
    model group with n_model > 1 runs eagerly, since gloo stages CUDA
    tensors through the host, which no capture allows. A CPU call runs
    eagerly. The rule is applied before any capture, from the group's
    backend, never after a capture that failed: that one raises."""
    return device_type == "cuda" and (n_model == 1 or backend == "nccl")


def _model_backend(mesh: DeviceMesh) -> str | None:
    """The backend of the mesh's model group; None for a group of one."""
    if mesh.size(1) == 1:
        return None
    return dist.get_backend(mesh.get_group("model"))


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


def _check_tables(cfg: AloamConfig, n_model: int, what: str) -> None:
    for name in ("map_table_corner", "map_table_surf"):
        if getattr(cfg, name) % n_model:
            raise ValueError(f"{what}: {n_model} model ranks do not divide "
                             f"{name} = {getattr(cfg, name)}")


def batched_init(cfg: AloamConfig, batch: int, device,
                 mesh: DeviceMesh | None = None) -> pipeline.SlamState:
    """The SLAM state of ``batch`` fresh streams (``pipeline.init_state``);
    with a mesh, its map tables are this rank's part, (batch, H /
    n_model, ·): what :func:`shard_tables` gives of the whole, made
    directly."""
    n = 1 if mesh is None else mesh.size(1)
    _check_tables(cfg, n, "batched_init")
    return pipeline.init_state(cfg.replace(
        map_table_corner=cfg.map_table_corner // n,
        map_table_surf=cfg.map_table_surf // n), batch, device)


def _map_tables(state: pipeline.SlamState, fn) -> pipeline.SlamState:
    """``state`` with ``fn`` applied to every map table leaf."""
    m = state.map
    return state._replace(map=m._replace(
        corner=type(m.corner)(*map(fn, m.corner)),
        surf=type(m.surf)(*map(fn, m.surf))))


def shard_tables(state: pipeline.SlamState,
                 mesh: DeviceMesh) -> pipeline.SlamState:
    """This rank's part of a whole state's map tables (the JAX package's
    ``put_state``): every table leaf (B, H, ·) becomes its model rank r's
    rows [r·H/n, (r+1)·H/n), copied, so the step's in-place updates leave
    the whole state alone; every other leaf is kept. Raises unless n_model
    divides H."""
    n, r = mesh.size(1), mesh.get_local_rank("model")

    def part(t):
        h = t.shape[1]
        if h % n:
            raise ValueError(f"shard_tables: {n} model ranks do not divide "
                             f"a table of {h} rows")
        return t[:, r * h // n:(r + 1) * h // n].clone()
    return _map_tables(state, part)


def gather_tables(state: pipeline.SlamState,
                  mesh: DeviceMesh) -> pipeline.SlamState:
    """The whole map tables of a partitioned state: every table leaf's
    parts ``all_gather``-ed over the model group and joined on the bucket
    axis in model rank order; every other leaf is kept. Every rank of the
    group calls it and gets the same."""
    if mesh.size(1) == 1:
        return state
    group = mesh.get_group("model")
    return _map_tables(state, lambda t: torch.cat(
        list(_all_gather(t, group)), dim=1))


def batched_step_jit(cfg: AloamConfig, donate: bool = True):
    """``pipeline.step_b`` with the config bound, on one device with no
    mesh: f(state, xyz (B, n_raw, 3), mask (B, n_raw)) -> (state,
    SlamOutputs), the JAX package's jitted ``step_b``. On a CUDA state it
    replays a captured CUDA graph of ``step_b`` (``graph.StepGraph``); on a
    CPU state the same body runs eagerly. With ``donate=True`` the state
    passed in is consumed, as JAX's donated state is; with
    ``donate=False`` the caller's state stays usable, as JAX's undonated
    input does."""
    return StepGraph(lambda s, x, m: pipeline.step_b(s, x, m, cfg),
                     functools.partial(pipeline.maps_at, cfg), donate)


def batched_step_fn(cfg: AloamConfig, mesh: DeviceMesh):
    """The batched step of one rank of the mesh: f(state, xyz, mask) ->
    (state, SlamOutputs), where ``xyz`` (B_local, n_raw, 3) and ``mask``
    (B_local, n_raw) are the rank's data group's ``B / n_data`` streams,
    the same on every rank of its model group, and ``state`` holds them
    with this rank's part of their map tables, (B_local, H / n_model, ·)
    (:func:`batched_init` with the mesh, or :func:`shard_tables`). The
    outputs are the data group's (:func:`gather_outputs` assembles the
    global ones), the same on every rank of the model group.

    It is a ``graph.StepGraph`` of the shape checks and ``pipeline.step_b``
    with the rank's ``TableShard``, gated by ``pipeline.maps_at``. On a
    CUDA state it captures the step into CUDA graphs and replays them
    where :func:`graphed` allows (n_model 1, or an NCCL model group: the
    table exchanges' ``all_reduce``s run inside the graph, and every rank
    of the group captures and replays the same graphs); on a gloo model
    group with n_model > 1, and on a CPU state, the same body runs
    eagerly. The state is donated: the map tables update in place, as in
    ``pipeline.step_b``, the state passed in is consumed, and a state the
    function returned steps with no copy (JAX's ``batched_step_fn``
    donates nothing). Its ``step`` attribute is the eager sharded step.

    Raises ``ValueError`` unless n_model divides both table sizes (as the
    JAX package asserts), on a rank outside the mesh, and on a state whose
    tables are not this rank's part."""
    n_model = mesh.size(1)
    _check_tables(cfg, n_model, "batched_step_fn")
    if mesh.get_coordinate() is None:
        raise ValueError(f"batched_step_fn: rank {dist.get_rank()} is not "
                         f"in the mesh {mesh.mesh.tolist()}")
    shard = None if n_model == 1 else TableShard(
        mesh.get_group("model"), mesh.get_local_rank("model"), n_model)
    rows = (cfg.map_table_corner // n_model, cfg.map_table_surf // n_model)

    def f(state, xyz, mask):
        if not xyz.shape[0] == mask.shape[0] == state.odom.q_w.shape[0]:
            raise ValueError(
                f"batched_step_fn: {xyz.shape[0]} scans and "
                f"{mask.shape[0]} masks for {state.odom.q_w.shape[0]} "
                f"local streams")
        got = (state.map.corner.pts.shape[1], state.map.surf.pts.shape[1])
        if got != rows:
            raise ValueError(f"batched_step_fn: tables of {got} rows, this "
                             f"rank's part is {rows}")
        return pipeline.step_b(state, xyz, mask, cfg, shard=shard)
    return StepGraph(f, functools.partial(pipeline.maps_at, cfg),
                     donate=True,
                     capture=graphed("cuda", n_model, _model_backend(mesh)))


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
    ``knn_streamed``.) Communication is O(Q·k·n_model), not O(M); with
    one model rank there is none.

    It is a ``graph.FnGraph``: on CUDA tensors it captures the search and
    the merge, the ``all_gather``s included, where :func:`graphed` allows,
    and replays them; otherwise it runs eagerly."""
    n_model = mesh.size(1)

    def f(query, ref, ref_mask):
        group = mesh.get_group("model")
        d2, idx = knn(query, ref, ref_mask, k)
        idx = idx + mesh.get_local_rank("model") * ref.shape[0]
        if n_model == 1:
            d_all, i_all = d2[None], idx[None]
        else:
            d_all, i_all = _all_gather(d2, group), _all_gather(idx, group)
        s, nq, _ = d_all.shape
        d_flat = d_all.movedim(0, 1).reshape(nq, s * k)
        i_flat = i_all.movedim(0, 1).reshape(nq, s * k)
        return smallest_k(d_flat, i_flat, k)
    return FnGraph(f, capture=graphed("cuda", n_model, _model_backend(mesh)))
