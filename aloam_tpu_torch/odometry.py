"""Scan-to-scan LiDAR odometry (port of ``aloam_tpu/odometry.py``, batched
form, ``cfg.distortion=False`` only).

Re-design of laserOdometry.cpp:186-601: per feature class one exhaustive
search gives the 1-NN and the ring-windowed secondary minima
(neighbors.py), two outer rounds of correspondence + 4 LM iterations
mirror :278/:496, the constant-velocity warm start mirrors the never-reset
``para_q/para_t`` (:97-98), and pose accumulation mirrors :504-505.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aloam_tpu.config import AloamConfig
from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import solver
from aloam_tpu_torch.neighbors import odom_window_mins_b
from aloam_tpu_torch.types import PointCloud, ScanFeatures
from aloam_tpu_torch.utils.batch import bgather


class OdomState(NamedTuple):
    """Per-stream odometry state; every leaf has a leading B axis."""
    q_w: torch.Tensor            # odom-frame world pose (laserOdometry.cpp:93)
    t_w: torch.Tensor
    q_lc: torch.Tensor           # frame-to-frame curr->last (:97-101)
    t_lc: torch.Tensor
    corner_last: PointCloud      # previous less-sharp cloud (:554-556)
    surf_last: PointCloud        # previous less-flat cloud (:558-560)
    initialized: torch.Tensor    # (B,) bool (systemInited, :267-271)


class OdomMetrics(NamedTuple):
    corner_corr: torch.Tensor
    plane_corr: torch.Tensor
    cost0: torch.Tensor
    cost: torch.Tensor
    degenerate: torch.Tensor  # clamped or non-finite LM iterations, all rounds


def init_state(cfg: AloamConfig, batch: int, device) -> OdomState:
    def empty(cap):
        return PointCloud(
            xyz=torch.zeros((batch, cap, 3), dtype=torch.float32,
                            device=device),
            intensity=torch.zeros((batch, cap), dtype=torch.float32,
                                  device=device),
            mask=torch.zeros((batch, cap), dtype=torch.bool, device=device))
    q = geo.qidentity(device).expand(batch, 4).contiguous()
    t = torch.zeros((batch, 3), dtype=torch.float32, device=device)
    return OdomState(q_w=q, t_w=t, q_lc=q.clone(), t_lc=t.clone(),
                     corner_last=empty(cfg.less_sharp_cap),
                     surf_last=empty(cfg.less_flat_cap),
                     initialized=torch.zeros((batch,), dtype=torch.bool,
                                             device=device))


def state_from_numpy(tree, device) -> OdomState:
    """The port's state from a JAX batched ``OdomState`` whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, state)``): the odometry state
    is what carries over between the two packages."""
    def t(x):
        return torch.from_numpy(np.array(x)).to(device)

    def cloud(pc):
        return PointCloud(xyz=t(pc.xyz), intensity=t(pc.intensity),
                          mask=t(pc.mask))
    return OdomState(q_w=t(tree.q_w), t_w=t(tree.t_w), q_lc=t(tree.q_lc),
                     t_lc=t(tree.t_lc), corner_last=cloud(tree.corner_last),
                     surf_last=cloud(tree.surf_last),
                     initialized=t(tree.initialized))


def _transform_to_start_b(q, t, pts):
    """TransformToStart (laserOdometry.cpp:111-129) on the DISTORTION 0
    path: q (B,4), t (B,3), pts (B,N,3)."""
    return geo.qrot(q[:, None, :], pts) + t[:, None, :]


def edge_correspondences_b(sharp: PointCloud, last: PointCloud, q, t,
                           cfg: AloamConfig) -> solver.EdgeFactors:
    """Corner correspondences (laserOdometry.cpp:299-384): the 1-NN gated
    at 25 m², plus the closest point on a different ring within ±2 rings
    (±NEARBY_SCAN = 2.5 on integer ring IDs), gated at 25 m²."""
    sel = _transform_to_start_b(q, t, sharp.xyz)
    d2_nn, nn, d2_diff, idx2 = odom_window_mins_b(
        sel, last.xyz, last.mask, last.ring(), int(cfg.nearby_scan),
        want_same_ring=False)
    valid = sharp.mask & (d2_nn < cfg.dist_sq_threshold) \
        & (d2_diff < cfg.dist_sq_threshold)
    return solver.EdgeFactors(p=sharp.xyz, a=bgather(last.xyz, nn),
                              b=bgather(last.xyz, idx2), mask=valid)


def plane_correspondences_b(flat: PointCloud, last: PointCloud, q, t,
                            cfg: AloamConfig) -> solver.PlaneFactors:
    """Surf correspondences (laserOdometry.cpp:387-483): the 1-NN gated at
    25 m², the closest same-ring point (minPointInd2) and the closest point
    within ±2 other rings (minPointInd3), both gated at 25 m²; the plane
    normal is (j−l)×(j−m) normalized (lidarFactor.hpp:64-65), and
    collinear triples are dropped."""
    sel = _transform_to_start_b(q, t, flat.xyz)
    d2_nn, nn, val3, idx3, val2, idx2 = odom_window_mins_b(
        sel, last.xyz, last.mask, last.ring(), int(cfg.nearby_scan),
        want_same_ring=True)
    valid = flat.mask & (d2_nn < cfg.dist_sq_threshold) \
        & (val2 < cfg.dist_sq_threshold) & (val3 < cfg.dist_sq_threshold)
    a = bgather(last.xyz, nn)
    n = torch.linalg.cross(a - bgather(last.xyz, idx2),
                           a - bgather(last.xyz, idx3), dim=-1)
    n_norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / n_norm.clamp_min(1e-12)
    valid = valid & (n_norm[..., 0] > 1e-6)
    d = -(n * a).sum(dim=-1)
    return solver.PlaneFactors(p=flat.xyz, n=n, d=d, mask=valid)


def odometry_step_b(state: OdomState, feats: ScanFeatures,
                    cfg: AloamConfig):
    """One odometry frame for B streams. Returns (new_state, metrics); the
    new world pose and handoff clouds are what the reference publishes to
    mapping (laserOdometry.cpp:510-591)."""
    if cfg.distortion:
        raise NotImplementedError("the DISTORTION path (cfg.distortion) "
                                  "is not ported")
    q, t = state.q_lc, state.t_lc
    metrics = degen = None
    for _ in range(cfg.odom_outer_rounds):
        edges = edge_correspondences_b(feats.sharp, state.corner_last, q, t,
                                       cfg)
        planes = plane_correspondences_b(feats.flat, state.surf_last, q, t,
                                         cfg)
        q, t, stats = solver.lm_solve_b(edges, planes, q, t,
                                        cfg.odom_lm_iters, cfg.huber_delta)
        d = stats.clamped + stats.nonfinite
        degen = d if degen is None else degen + d
        metrics = OdomMetrics(corner_corr=edges.mask.sum(dim=1),
                              plane_corr=planes.mask.sum(dim=1),
                              cost0=stats.cost0, cost=stats.cost,
                              degenerate=degen)

    # first frame: initialization only (laserOdometry.cpp:267-271)
    inited = state.initialized[:, None]
    q_lc = torch.where(inited, q, geo.qidentity(q.device))
    t_lc = torch.where(inited, t, 0.0)
    q_w, t_w = geo.compose(state.q_w, state.t_w, q_lc, t_lc)
    new_state = OdomState(
        q_w=q_w, t_w=t_w, q_lc=q_lc, t_lc=t_lc,
        corner_last=feats.less_sharp, surf_last=feats.less_flat,
        initialized=torch.ones_like(state.initialized))
    return new_state, metrics
