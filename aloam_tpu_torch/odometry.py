"""Scan-to-scan LiDAR odometry (port of ``aloam_tpu/odometry.py``, batched
form).

Re-design of laserOdometry.cpp:186-601: per feature class one exhaustive
search gives the 1-NN and the ring-windowed secondary minima
(neighbors.py), two outer rounds of correspondence + 4 LM iterations
mirror :278/:496, the constant-velocity warm start mirrors the never-reset
``para_q/para_t`` (:97-98), and pose accumulation mirrors :504-505.
With ``cfg.distortion`` (the reference's ``DISTORTION 1``, :59,111-148)
each point is moved by the pose slerped to its time fraction in the
sweep, the factors carry those fractions into the solve, and the handoff
clouds are undistorted to the sweep end (TransformToEnd).

The single-stream API (``transform_to_end``, ``edge_correspondences``,
``plane_correspondences``, ``odometry_step``) takes and returns the JAX
package's unbatched leaves and runs the batched functions at B = 1: the
same search (the ring-window skip of ``odometry_step_b`` changes no
output) and the one-launch LM solve, within its stated tolerance of the
JAX package's plain solve. ``init_state(cfg, batch, device)`` keeps the
port's batched signature: a single-stream state is
``drop_stream_axis(init_state(cfg, 1, device))``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import solver, spans
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.neighbors import odom_window_mins_b
from aloam_tpu_torch.ops import gather as gather_op
from aloam_tpu_torch.types import PointCloud, ScanFeatures
from aloam_tpu_torch.utils.batch import add_stream_axis, drop_stream_axis


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


def _point_s(pc: PointCloud, cfg: AloamConfig) -> torch.Tensor:
    """Per-point time fraction from the intensity encoding ring +
    relTime·scanPeriod (s = (intensity − int(intensity)) / SCAN_PERIOD,
    laserOdometry.cpp:116), clipped to [0, 1]."""
    frac = pc.intensity - torch.floor(pc.intensity)
    return (frac / cfg.scan_period).clamp(0.0, 1.0)


def _transform_to_start_b(q, t, pts, s=None):
    """TransformToStart (laserOdometry.cpp:111-129): current-frame points
    into the last frame, q (B,4), t (B,3), pts (B,N,3). With time fractions
    s (B,N) (DISTORTION 1) each point moves by the pose interpolated to its
    s; s = None is the DISTORTION 0 path, s ≡ 1."""
    if s is None:
        return geo.qrot(q[:, None, :], pts) + t[:, None, :]
    qs, ts = solver._interp_pose(q, t, s)
    return geo.qrot(qs, pts) + ts


def transform_to_end_b(pc: PointCloud, q, t, cfg: AloamConfig) -> PointCloud:
    """TransformToEnd (laserOdometry.cpp:131-148): undistort a cloud to the
    sweep-end frame (to the sweep start by each point's interpolated pose,
    then by the full inverse) and strip the time fraction from the
    intensity (:146). The reference keeps this handoff re-projection under
    ``if (0)`` (:533-552); with the distortion path it is what keeps the
    frame chain consistent, so it runs whenever cfg.distortion is set. Row
    layout and mask are kept."""
    un = _transform_to_start_b(q, t, pc.xyz, _point_s(pc, cfg))
    end = geo.qrot_inv(q[:, None, :], un - t[:, None, :])
    return pc._replace(xyz=end, intensity=torch.floor(pc.intensity))


def _frontend_ring_seg(last: PointCloud, seg: int, cfg: AloamConfig) -> int:
    """The ring-segment stride of a handoff cloud (``OdomState.corner_last``
    / ``surf_last``). Those are always ``features.ring_heads`` outputs: ring
    r's points live in rows [r·seg, (r+1)·seg) and the tail rows are
    padding (mask False, poisoned in the search). Any other cloud must be
    searched with ring_seg = 0."""
    if last.capacity < cfg.scan_lines * seg:
        raise ValueError(f"a handoff cloud of {last.capacity} rows cannot "
                         f"hold {cfg.scan_lines} rings of {seg}")
    return seg


def edge_correspondences_b(sharp: PointCloud, last: PointCloud, q, t,
                           cfg: AloamConfig,
                           ring_seg: int = 0) -> solver.EdgeFactors:
    """Corner correspondences (laserOdometry.cpp:299-384): the 1-NN gated
    at 25 m², plus the closest point on a different ring within ±2 rings
    (±NEARBY_SCAN = 2.5 on integer ring IDs), gated at 25 m². ``ring_seg``
    > 0 declares ``last`` ring-segmented (neighbors.odom_window_mins_b).
    With cfg.distortion the factors carry each point's time fraction."""
    s = _point_s(sharp, cfg) if cfg.distortion else None
    sel = _transform_to_start_b(q, t, sharp.xyz, s)
    d2_nn, nn, d2_diff, idx2 = odom_window_mins_b(
        sel, last.xyz, last.mask, last.ring(), int(cfg.nearby_scan),
        want_same_ring=False, ring_seg=ring_seg)
    valid = sharp.mask & (d2_nn < cfg.dist_sq_threshold) \
        & (d2_diff < cfg.dist_sq_threshold)
    return solver.EdgeFactors(p=sharp.xyz,
                              a=gather_op.bgather(last.xyz, nn),
                              b=gather_op.bgather(last.xyz, idx2),
                              mask=valid, s=s)


def plane_correspondences_b(flat: PointCloud, last: PointCloud, q, t,
                            cfg: AloamConfig,
                            ring_seg: int = 0) -> solver.PlaneFactors:
    """Surf correspondences (laserOdometry.cpp:387-483): the 1-NN gated at
    25 m², the closest same-ring point (minPointInd2) and the closest point
    within ±2 other rings (minPointInd3), both gated at 25 m²; the plane
    normal is (j−l)×(j−m) normalized (lidarFactor.hpp:64-65), and
    collinear triples are dropped. ``ring_seg`` as in
    edge_correspondences_b."""
    s = _point_s(flat, cfg) if cfg.distortion else None
    sel = _transform_to_start_b(q, t, flat.xyz, s)
    d2_nn, nn, val3, idx3, val2, idx2 = odom_window_mins_b(
        sel, last.xyz, last.mask, last.ring(), int(cfg.nearby_scan),
        want_same_ring=True, ring_seg=ring_seg)
    valid = flat.mask & (d2_nn < cfg.dist_sq_threshold) \
        & (val2 < cfg.dist_sq_threshold) & (val3 < cfg.dist_sq_threshold)
    a = gather_op.bgather(last.xyz, nn)
    n = torch.linalg.cross(a - gather_op.bgather(last.xyz, idx2),
                           a - gather_op.bgather(last.xyz, idx3), dim=-1)
    n_norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / n_norm.clamp_min(1e-12)
    valid = valid & (n_norm[..., 0] > 1e-6)
    d = -(n * a).sum(dim=-1)
    return solver.PlaneFactors(p=flat.xyz, n=n, d=d, mask=valid, s=s)


def odometry_step_b(state: OdomState, feats: ScanFeatures,
                    cfg: AloamConfig):
    """One odometry frame for B streams. Returns (new_state, metrics); the
    new world pose and handoff clouds are what the reference publishes to
    mapping (laserOdometry.cpp:510-591)."""
    q, t = state.q_lc, state.t_lc
    metrics = degen = None
    # the handoff clouds are ring_heads outputs (set below from
    # feats.less_sharp / less_flat; transform_to_end_b keeps their row
    # layout and mask), so the search may skip by ring
    seg_e = _frontend_ring_seg(state.corner_last,
                               cfg.n_regions * cfg.max_less_sharp, cfg)
    seg_p = _frontend_ring_seg(
        state.surf_last,
        min(cfg.ring_cap, cfg.less_flat_cap // cfg.scan_lines), cfg)
    for _ in range(cfg.odom_outer_rounds):
        with spans.stage("odom.assoc"):
            edges = edge_correspondences_b(feats.sharp, state.corner_last, q,
                                           t, cfg, ring_seg=seg_e)
            planes = plane_correspondences_b(feats.flat, state.surf_last, q,
                                             t, cfg, ring_seg=seg_p)
        with spans.stage("odom.lm"):
            q, t, stats = solver.lm_solve_b(edges, planes, q, t,
                                            cfg.odom_lm_iters,
                                            cfg.huber_delta)
            d = stats.clamped + stats.nonfinite
            degen = d if degen is None else degen + d
            metrics = OdomMetrics(corner_corr=edges.mask.sum(dim=1),
                                  plane_corr=planes.mask.sum(dim=1),
                                  cost0=stats.cost0, cost=stats.cost,
                                  degenerate=degen)

    with spans.stage("odom.handoff"):
        # first frame: initialization only (laserOdometry.cpp:267-271)
        inited = state.initialized[:, None]
        q_lc = torch.where(inited, q, geo.qidentity(q.device))
        t_lc = torch.where(inited, t, 0.0)
        q_w, t_w = geo.compose(state.q_w, state.t_w, q_lc, t_lc)
        # the handoff clouds; with the distortion path undistorted to the
        # sweep end, so that the next frame's TransformToStart and the
        # mapping stage see one frame chain
        if cfg.distortion:
            corner_last = transform_to_end_b(feats.less_sharp, q_lc, t_lc,
                                             cfg)
            surf_last = transform_to_end_b(feats.less_flat, q_lc, t_lc, cfg)
        else:
            corner_last, surf_last = feats.less_sharp, feats.less_flat
        new_state = OdomState(
            q_w=q_w, t_w=t_w, q_lc=q_lc, t_lc=t_lc,
            corner_last=corner_last, surf_last=surf_last,
            initialized=torch.ones_like(state.initialized))
    return new_state, metrics


def transform_to_end(pc: PointCloud, q, t, cfg: AloamConfig) -> PointCloud:
    """:func:`transform_to_end_b` of one cloud: leaves (N, ·), q (4,), t
    (3,)."""
    return drop_stream_axis(transform_to_end_b(add_stream_axis(pc), q[None],
                                               t[None], cfg))


def edge_correspondences(sharp: PointCloud, last: PointCloud, q, t,
                         cfg: AloamConfig) -> solver.EdgeFactors:
    """:func:`edge_correspondences_b` of one stream, searched exhaustively
    (ring_seg 0, as the JAX package's single-stream search): clouds (N, ·),
    q (4,), t (3,); factors with (N, ·) leaves."""
    return drop_stream_axis(edge_correspondences_b(
        *add_stream_axis((sharp, last, q, t)), cfg))


def plane_correspondences(flat: PointCloud, last: PointCloud, q, t,
                          cfg: AloamConfig) -> solver.PlaneFactors:
    """:func:`plane_correspondences_b` of one stream, as
    :func:`edge_correspondences`."""
    return drop_stream_axis(plane_correspondences_b(
        *add_stream_axis((flat, last, q, t)), cfg))


def odometry_step(state: OdomState, feats: ScanFeatures,
                  cfg: AloamConfig):
    """:func:`odometry_step_b` of one stream: state and feature leaves
    without the stream axis. Returns (new_state, OdomMetrics of
    scalars)."""
    new_state, metrics = odometry_step_b(add_stream_axis(state),
                                         add_stream_axis(feats), cfg)
    return drop_stream_axis(new_state), drop_stream_axis(metrics)
