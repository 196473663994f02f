"""The SLAM step (port of ``aloam_tpu/pipeline.py``): registration →
features → scan-to-scan odometry → scan-to-map mapping.

This is the reference's three nodes (scanRegistration, laserOdometry,
laserMapping) as one eager call per frame. ``step_b`` steps B streams with
the batched mapping (a per-cell knn cache and the fused association
kernel); ``front_step_b`` is it without mapping: the odometry poses
(``/laser_odom_to_init``) do not depend on the map, so they hold directly
against the JAX step's ``q_odom`` / ``t_odom``. ``step`` steps one stream
with the reference's exact per-round map search (``mapping.mapping_step``);
its front half is the batched one at B = 1. Both update the state's map
tables in place: a state passed in is consumed.

A single-stream state keeps a stream axis of 1 on every tensor leaf;
``step`` takes and returns JAX's single-stream shapes (xyz (n_raw, 3),
poses (4,) / (3,), metrics (16,)).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import graph
from aloam_tpu_torch import mapping as mp
from aloam_tpu_torch import odometry as od
from aloam_tpu_torch import spans
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.frontend import extract_features_b, register_scan_b

METRIC_NAMES = (
    "corner_corr", "plane_corr", "odom_cost", "map_corner_factors",
    "map_surf_factors", "map_solved", "frontend_overflow", "map_overflow",
    "map_evicted", "n_sharp", "n_flat", "n_less_sharp", "n_less_flat",
    "odom_degenerate", "map_degenerate", "map_cache_crossed",
)

# the non-mapping columns of METRIC_NAMES, in its order
FRONT_METRIC_NAMES = tuple(n for n in METRIC_NAMES
                           if not n.startswith("map_"))


class SlamState(NamedTuple):
    odom: od.OdomState
    map: mp.MapState
    frame: int                   # frames stepped, counted on the host


class FrontOutputs(NamedTuple):
    # /laser_odom_to_init (laserOdometry.cpp:510-522), (B, 4) and (B, 3)
    q_odom: torch.Tensor
    t_odom: torch.Tensor
    # FRONT_METRIC_NAMES -> (B,) f32. frontend_overflow is per stream (the
    # JAX step broadcasts one batch-wide sum to every stream)
    metrics: dict


class SlamOutputs(NamedTuple):
    # /laser_odom_to_init
    q_odom: torch.Tensor
    t_odom: torch.Tensor
    # /aft_mapped_to_init (laserMapping.cpp:854-865)
    q_map: torch.Tensor
    t_map: torch.Tensor
    # /aft_mapped_to_init_high_frec (laserMapping.cpp:197-229): the
    # odometry pose with the previous frame's map correction
    q_hf: torch.Tensor
    t_hf: torch.Tensor
    # (B, len(METRIC_NAMES)) f32 (step: (len(METRIC_NAMES),)), see
    # metrics_dict. The overflow columns are per stream; the JAX step_b
    # adds batch-wide sums to every stream
    metrics: torch.Tensor
    # /velodyne_cloud_registered (laserMapping.cpp:838-848): the full ring
    # grid in the map frame at the refined pose, (B, R·C, 3) with its slot
    # mask (B, R·C); None unless cfg.emit_registered
    registered: torch.Tensor | None = None
    registered_mask: torch.Tensor | None = None


def metrics_dict(metrics) -> dict:
    """Unpack a step's packed metrics vector (host side)."""
    return dict(zip(METRIC_NAMES, torch.as_tensor(metrics).cpu().tolist()))


def init_state(cfg: AloamConfig, batch: int, device) -> SlamState:
    return SlamState(odom=od.init_state(cfg, batch, device),
                     map=mp.init_state(cfg, batch, device), frame=0)


def _with_stream_axis(tree):
    if isinstance(tree, tuple):
        return type(tree)(*map(_with_stream_axis, tree))
    return np.asarray(tree)[None]


def state_from_numpy(tree, device) -> SlamState:
    """The port's state from a JAX ``SlamState`` whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, state)``), bit for bit: a batched
    one (leaves (B, ·)), or a single-stream one (unbatched leaves, as
    JAX's ``step`` keeps them), which gets the port's stream axis of 1.
    The streams step in lock-step, so the frame counter is one number."""
    if np.ndim(tree.odom.q_w) == 1:
        tree = _with_stream_axis(tree)
    return SlamState(odom=od.state_from_numpy(tree.odom, device),
                     map=mp.state_from_numpy(tree.map, device),
                     frame=int(np.reshape(tree.frame, -1)[0]))


def _front_b(state: SlamState, xyz: torch.Tensor, mask: torch.Tensor,
             cfg: AloamConfig):
    """front_step_b, also returning the ring grid (for the registered
    cloud)."""
    with spans.stage("register"):
        rc, curv, ovf = register_scan_b(xyz, mask, cfg)
    with spans.stage("features"):
        feats = extract_features_b(rc, curv, cfg)
    with spans.stage("odometry"):
        odom, om = od.odometry_step_b(state.odom, feats, cfg)
        vals = (om.corner_corr, om.plane_corr, om.cost, ovf + feats.overflow,
                feats.sharp.count(), feats.flat.count(),
                feats.less_sharp.count(), feats.less_flat.count(),
                om.degenerate)
        metrics = {name: v.to(torch.float32)
                   for name, v in zip(FRONT_METRIC_NAMES, vals, strict=True)}
    return state._replace(odom=odom, frame=state.frame + 1), FrontOutputs(
        q_odom=odom.q_w, t_odom=odom.t_w, metrics=metrics), rc


def front_step_b(state: SlamState, xyz: torch.Tensor, mask: torch.Tensor,
                 cfg: AloamConfig):
    """Registration, features and odometry for one frame of B streams: xyz
    (B, n_raw, 3) f32 in firing order, mask (B, n_raw) bool. Returns (new
    state, FrontOutputs); the map state is passed through."""
    new_state, fo, _ = _front_b(state, xyz, mask, cfg)
    return new_state, fo


def maps_at(cfg: AloamConfig, frame: int) -> bool:
    """Whether the mapping stage runs at this frame: every
    ``mapping_skip_frame`` frames (laserOdometry.cpp:570-591)."""
    return cfg.mapping_skip_frame <= 1 or frame % cfg.mapping_skip_frame == 0


def _gated_mapping(run_mapping, state: SlamState, cfg: AloamConfig):
    """Run the mapping stage where :func:`maps_at` says. All streams step
    together, so the host's frame counter gates the whole batch; a
    skipped frame returns the map state unchanged and all-zero
    metrics."""
    if maps_at(cfg, state.frame):
        return run_mapping(state.map)
    zeros = torch.zeros_like(state.odom.initialized, dtype=torch.int64)
    return state.map, mp.MapMetrics(*([zeros] * len(mp.MapMetrics._fields)))


def _step(state: SlamState, xyz: torch.Tensor, mask: torch.Tensor,
          cfg: AloamConfig, mapping_step):
    """One frame of B streams with the given mapping step
    (mapping_step_b, or mapping_step at B = 1)."""
    front, fo, rc = _front_b(state, xyz, mask, cfg)
    odom = front.odom

    def run_mapping(map_state):
        # the handoff clouds: /laser_cloud_corner_last and _surf_last
        # (laserOdometry.cpp:570-585)
        return mapping_step(map_state, odom.corner_last, odom.surf_last,
                            odom.q_w, odom.t_w, cfg)

    with spans.stage("mapping"):
        # the high-frequency pose uses the correction from before this
        # frame's mapping solve (laserMapping.cpp:197-229)
        q_hf = geo.qmul(state.map.q_wmap_wodom, odom.q_w)
        t_hf = geo.qrot(state.map.q_wmap_wodom, odom.t_w) \
            + state.map.t_wmap_wodom
        map_state, mm = _gated_mapping(run_mapping, state, cfg)
    with spans.stage("outputs"):
        cols = dict(fo.metrics, map_corner_factors=mm.corner_factors,
                    map_surf_factors=mm.surf_factors, map_solved=mm.solved,
                    map_overflow=mm.overflow, map_evicted=mm.evicted,
                    map_degenerate=mm.degenerate,
                    map_cache_crossed=mm.cache_crossed)
        metrics = torch.stack([cols[n].to(torch.float32)
                               for n in METRIC_NAMES], dim=-1)
        registered = registered_mask = None
        if cfg.emit_registered:
            bsz = xyz.shape[0]
            registered = geo.qrot(map_state.q_w[:, None, :],
                                  rc.xyz.reshape(bsz, -1, 3)) \
                + map_state.t_w[:, None, :]
            registered_mask = rc.slot_mask().reshape(bsz, -1)
    return front._replace(map=map_state), SlamOutputs(
        q_odom=odom.q_w, t_odom=odom.t_w, q_map=map_state.q_w,
        t_map=map_state.t_w, q_hf=q_hf, t_hf=t_hf, metrics=metrics,
        registered=registered, registered_mask=registered_mask)


def step_b(state: SlamState, xyz: torch.Tensor, mask: torch.Tensor,
           cfg: AloamConfig, shard=None):
    """One frame of the whole pipeline for B streams: xyz (B, n_raw, 3),
    mask (B, n_raw). The map tables of ``state`` are updated in place.
    ``shard`` (``ops/gridmap.TableShard``): the state's tables are this
    rank's part of tables partitioned over a group whose ranks all step
    the same streams (``mapping.mapping_step_b``). Returns (new state,
    SlamOutputs)."""
    mapping = mp.mapping_step_b if shard is None \
        else functools.partial(mp.mapping_step_b, shard=shard)
    return _step(state, xyz, mask, cfg, mapping)


def step(state: SlamState, xyz: torch.Tensor, mask: torch.Tensor,
         cfg: AloamConfig):
    """One frame of one stream end to end: xyz (n_raw, 3), mask (n_raw,);
    ``state`` has a stream axis of 1 (``init_state(cfg, 1, device)``).
    The front half is step_b's at B = 1; mapping is ``mapping_step``, the
    exact per-round search. The map tables of ``state`` are updated in
    place. Returns (new state, SlamOutputs without the stream axis)."""
    if state.odom.q_w.shape[0] != 1:
        raise ValueError(f"step: a single-stream state, got "
                         f"{state.odom.q_w.shape[0]} streams")
    new_state, out = _step(state, xyz[None], mask[None], cfg,
                           mp.mapping_step)
    return new_state, SlamOutputs(*(None if x is None else x[0]
                                    for x in out))


def make_step_fn(cfg: AloamConfig, donate: bool = True):
    """``step`` with the config bound, the port's counterpart of the JAX
    package's jitted step: fn(state, xyz, mask) -> (state, SlamOutputs).
    On a CUDA state it replays a captured CUDA graph of ``step``
    (``graph.StepGraph``: one graph per gate branch and shape set,
    captured at first use); on a CPU state the same body runs eagerly.
    With ``donate=True`` the state passed in is consumed, as JAX's donated
    state is, and the state returned stays valid until the next call; with
    ``donate=False`` the caller's state stays usable."""
    return graph.StepGraph(lambda s, x, m: step(s, x, m, cfg),
                           functools.partial(maps_at, cfg), donate)


def run_sequence(state: SlamState, xyz_seq: torch.Tensor,
                 mask_seq: torch.Tensor, cfg: AloamConfig,
                 scan: bool = False):
    """``step`` over an (F, n_raw, ·) scan stack; returns (final state,
    outputs stacked along a leading frame axis). The input state is
    consumed. ``scan=False``: a host loop over ``make_step_fn``'s step, a
    replay a frame on a CUDA state. ``scan=True`` (the JAX package's
    one-program ``lax.scan``): on a CUDA state one graph of all F frames,
    replayed once; on a CPU state the same body in a loop."""
    step_fn = make_step_fn(cfg)
    if scan:
        return step_fn.run(state, xyz_seq, mask_seq)
    outs = []
    for f in range(xyz_seq.shape[0]):
        state, out = step_fn(state, xyz_seq[f], mask_seq[f])
        outs.append(out)
    return state, SlamOutputs(*(None if xs[0] is None else torch.stack(xs)
                                for xs in zip(*outs)))
