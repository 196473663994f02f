"""The batched SLAM step for B streams (port of ``aloam_tpu/pipeline.py``'s
``step_b``): registration → features → scan-to-scan odometry →
scan-to-map mapping.

This is the reference's three nodes (scanRegistration, laserOdometry,
laserMapping) as one eager call per frame. ``front_step_b`` is the step
without mapping: the odometry poses (``/laser_odom_to_init``) do not
depend on the map, so they hold directly against the JAX step's
``q_odom`` / ``t_odom``. ``step_b`` adds mapping (``/aft_mapped_to_init``)
and updates the state's map tables in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aloam_tpu.config import AloamConfig
from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import mapping as mp
from aloam_tpu_torch import odometry as od
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
    # (B, len(METRIC_NAMES)) f32. The overflow columns are per stream;
    # the JAX step adds batch-wide sums to every stream
    metrics: torch.Tensor


def init_state(cfg: AloamConfig, batch: int, device) -> SlamState:
    return SlamState(odom=od.init_state(cfg, batch, device),
                     map=mp.init_state(cfg, batch, device), frame=0)


def state_from_numpy(tree, device) -> SlamState:
    """The port's state from a JAX batched ``SlamState`` whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, state)``), bit for bit. The
    streams step in lock-step, so the frame counter is one number."""
    return SlamState(odom=od.state_from_numpy(tree.odom, device),
                     map=mp.state_from_numpy(tree.map, device),
                     frame=int(np.reshape(tree.frame, -1)[0]))


def front_step_b(state: SlamState, xyz: torch.Tensor, mask: torch.Tensor,
                 cfg: AloamConfig):
    """Registration, features and odometry for one frame of B streams: xyz
    (B, n_raw, 3) f32 in firing order, mask (B, n_raw) bool. Returns (new
    state, FrontOutputs); the map state is passed through."""
    rc, curv, ovf = register_scan_b(xyz, mask, cfg)
    feats = extract_features_b(rc, curv, cfg)
    odom, om = od.odometry_step_b(state.odom, feats, cfg)
    vals = (om.corner_corr, om.plane_corr, om.cost, ovf + feats.overflow,
            feats.sharp.count(), feats.flat.count(),
            feats.less_sharp.count(), feats.less_flat.count(),
            om.degenerate)
    metrics = {name: v.to(torch.float32)
               for name, v in zip(FRONT_METRIC_NAMES, vals, strict=True)}
    return state._replace(odom=odom, frame=state.frame + 1), FrontOutputs(
        q_odom=odom.q_w, t_odom=odom.t_w, metrics=metrics)


def _gated_mapping(run_mapping, state: SlamState, cfg: AloamConfig):
    """Run the mapping stage every ``mapping_skip_frame`` frames
    (laserOdometry.cpp:570-591). All streams step together, so the host's
    frame counter gates the whole batch; a skipped frame returns the map
    state unchanged and all-zero metrics."""
    if cfg.mapping_skip_frame <= 1 or state.frame % cfg.mapping_skip_frame \
            == 0:
        return run_mapping(state.map)
    zeros = torch.zeros_like(state.odom.initialized, dtype=torch.int64)
    return state.map, mp.MapMetrics(*([zeros] * len(mp.MapMetrics._fields)))


def step_b(state: SlamState, xyz: torch.Tensor, mask: torch.Tensor,
           cfg: AloamConfig):
    """One frame of the whole pipeline for B streams: xyz (B, n_raw, 3),
    mask (B, n_raw). The map tables of ``state`` are updated in place.
    Returns (new state, SlamOutputs)."""
    front, fo = front_step_b(state, xyz, mask, cfg)
    odom = front.odom
    # the high-frequency pose uses the correction from before this frame's
    # mapping solve (laserMapping.cpp:197-229)
    q_hf = geo.qmul(state.map.q_wmap_wodom, odom.q_w)
    t_hf = geo.qrot(state.map.q_wmap_wodom, odom.t_w) \
        + state.map.t_wmap_wodom

    def run_mapping(map_state):
        # the handoff clouds: /laser_cloud_corner_last and _surf_last
        # (laserOdometry.cpp:570-585)
        return mp.mapping_step_b(map_state, odom.corner_last,
                                 odom.surf_last, odom.q_w, odom.t_w, cfg)

    map_state, mm = _gated_mapping(run_mapping, state, cfg)
    cols = dict(fo.metrics, map_corner_factors=mm.corner_factors,
                map_surf_factors=mm.surf_factors, map_solved=mm.solved,
                map_overflow=mm.overflow, map_evicted=mm.evicted,
                map_degenerate=mm.degenerate,
                map_cache_crossed=mm.cache_crossed)
    metrics = torch.stack([cols[n].to(torch.float32) for n in METRIC_NAMES],
                          dim=-1)
    return front._replace(map=map_state), SlamOutputs(
        q_odom=odom.q_w, t_odom=odom.t_w, q_map=map_state.q_w,
        t_map=map_state.t_w, q_hf=q_hf, t_hf=t_hf, metrics=metrics)
