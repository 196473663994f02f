"""The ported front half of the SLAM step: registration, features and
scan-to-scan odometry for B streams (port of the part of
``aloam_tpu/pipeline.step_b`` before its mapping stage).

This is the reference's ``scanRegistration`` + ``laserOdometry`` nodes,
which publish ``/laser_odom_to_init`` at 10 Hz. The odometry poses do not
depend on the mapping stage, so they hold directly against the JAX step's
``q_odom`` / ``t_odom``. Mapping is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aloam_tpu.config import AloamConfig
from aloam_tpu_torch import odometry as od
from aloam_tpu_torch.frontend import extract_features_b, register_scan_b

# the non-mapping columns of aloam_tpu.pipeline.METRIC_NAMES, same names
FRONT_METRIC_NAMES = (
    "corner_corr", "plane_corr", "odom_cost", "frontend_overflow",
    "n_sharp", "n_flat", "n_less_sharp", "n_less_flat", "odom_degenerate",
)

state_from_numpy = od.state_from_numpy


class FrontOutputs(NamedTuple):
    # /laser_odom_to_init (laserOdometry.cpp:510-522), (B, 4) and (B, 3)
    q_odom: torch.Tensor
    t_odom: torch.Tensor
    # FRONT_METRIC_NAMES -> (B,) f32. frontend_overflow is per stream (the
    # JAX step broadcasts one batch-wide sum to every stream)
    metrics: dict


def init_state(cfg: AloamConfig, batch: int, device) -> od.OdomState:
    return od.init_state(cfg, batch, device)


def front_step_b(state: od.OdomState, xyz: torch.Tensor, mask: torch.Tensor,
                 cfg: AloamConfig):
    """One frame for B streams: xyz (B, n_raw, 3) f32 in firing order, mask
    (B, n_raw) bool. Returns (new OdomState, FrontOutputs)."""
    rc, curv, ovf = register_scan_b(xyz, mask, cfg)
    feats = extract_features_b(rc, curv, cfg)
    odom, om = od.odometry_step_b(state, feats, cfg)
    vals = (om.corner_corr, om.plane_corr, om.cost, ovf + feats.overflow,
            feats.sharp.count(), feats.flat.count(),
            feats.less_sharp.count(), feats.less_flat.count(),
            om.degenerate)
    metrics = {name: v.to(torch.float32)
               for name, v in zip(FRONT_METRIC_NAMES, vals, strict=True)}
    return odom, FrontOutputs(q_odom=odom.q_w, t_odom=odom.t_w,
                              metrics=metrics)
