"""Batched Levenberg-Marquardt on SE(3) with analytic LOAM Jacobians
(port of ``aloam_tpu/solver.py``).

The reference solves each stage with Ceres (``AutoDiffCostFunction`` +
Huber(0.1) + an ``EigenQuaternionParameterization``,
laserOdometry.cpp:284-291,493-499). Here the point-to-line and
point-to-plane residuals of ``lidarFactor.hpp`` carry hand-derived
Jacobians, factors are fixed-capacity masked batches with a leading stream
axis, the robust loss enters as IRLS weights, and each iteration is one
damped 6x6 solve per stream. The tangent is ``[dtheta, dt]``:
``q' = exp(dtheta) ⊗ q``, ``t' = t + dt``.

Only the reference's compiled ``DISTORTION 0`` path (laserOdometry.cpp:59;
mapping always passes 1.0, laserMapping.cpp:618): no per-point pose
interpolation.

``lm_solve`` is the plain batched form; ``lm_solve_b`` packs the factors
as the one-launch solve of ``ops/lm.py`` takes them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from benchmark.reference.aloam import geometry as geo
from benchmark.reference.aloam.ops import lm as lm_op


class EdgeFactors(NamedTuple):
    """Point-to-line (LidarEdgeFactor, lidarFactor.hpp:12-55): residual
    (3,) = (u−a)×(u−b)/‖a−b‖ with u = q·p + t. Leaves (B, N, 3) /
    (B, N)."""
    p: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    mask: torch.Tensor


class PlaneFactors(NamedTuple):
    """Point-to-plane (LidarPlaneNormFactor, lidarFactor.hpp:106-138):
    residual (1,) = n·(q·p + t) + d. Leaves (B, N, 3) / (B, N)."""
    p: torch.Tensor
    n: torch.Tensor
    d: torch.Tensor
    mask: torch.Tensor


def _moved(f, q, t):
    """(u, R p) of a factor batch's points at (q, t)."""
    u = geo.qrot(q[:, None], f.p) + t[:, None]
    return u, u - t[:, None]


def edge_residuals(f: EdgeFactors, q, t):
    """Residual (B, N, 3) and Jacobian (B, N, 3, 6) at (q (B,4), t (B,3))."""
    u, rp = _moved(f, q, t)                                # rp = R p
    dv = f.a - f.b
    inv_norm = 1.0 / torch.linalg.vector_norm(
        dv, dim=-1, keepdim=True).clamp_min(1e-12)
    r = torch.linalg.cross(u - f.a, u - f.b, dim=-1) * inv_norm
    # dr/du = -[d]x / ||d|| ; dr/dtheta = (rp d^T - (d.rp) I) / ||d||
    j_u = -geo.skew(dv) * inv_norm[..., None]
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    j_theta = (rp[..., :, None] * dv[..., None, :]
               - (dv * rp).sum(-1)[..., None, None] * eye) \
        * inv_norm[..., None]
    return r, torch.cat([j_theta, j_u], dim=-1)


def plane_residuals(f: PlaneFactors, q, t):
    """Residual (B, N, 1) and Jacobian (B, N, 1, 6)."""
    u, rp = _moved(f, q, t)
    r = ((f.n * u).sum(-1) + f.d)[..., None]
    j_theta = torch.linalg.cross(rp, f.n, dim=-1)          # (Rp × n)^T
    return r, torch.cat([j_theta, f.n], dim=-1)[..., None, :]


_RESIDUAL_FNS = {EdgeFactors: edge_residuals, PlaneFactors: plane_residuals}


def huber_weight(s: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight rho'(s) of Huber on the squared block norm s = ‖r‖²
    (Ceres HuberLoss: rho(s) = s for s ≤ δ², else 2δ√s − δ²)."""
    return torch.where(s <= delta * delta, 1.0,
                       delta / s.clamp_min(1e-20).sqrt())


def huber_cost(s: torch.Tensor, delta: float) -> torch.Tensor:
    d2 = delta * delta
    return torch.where(s <= d2, s, 2.0 * delta * s.clamp_min(1e-20).sqrt()
                       - d2)


def _accumulate(factors: Sequence, q, t, delta: float):
    """Robust-weighted normal equations per stream: H (B,6,6), g (B,6),
    cost (B,), n_active (B,)."""
    bsz = q.shape[0]
    h = torch.zeros((bsz, 6, 6), dtype=torch.float32, device=q.device)
    g = torch.zeros((bsz, 6), dtype=torch.float32, device=q.device)
    cost = torch.zeros((bsz,), dtype=torch.float32, device=q.device)
    n_active = torch.zeros((bsz,), dtype=torch.int64, device=q.device)
    for f in factors:
        r, jac = _RESIDUAL_FNS[type(f)](f, q, t)
        m = f.mask.to(torch.float32)
        # hard-zero masked rows: a zero weight alone cannot neutralize
        # non-finite padding (0 * inf = nan would poison H)
        r = torch.where(f.mask[..., None], r, 0.0)
        jac = torch.where(f.mask[..., None, None], jac, 0.0)
        s = (r * r).sum(-1)
        w = huber_weight(s, delta) * m
        jw = jac * w[..., None, None]
        h = h + torch.einsum("bnki,bnkj->bij", jw, jac)
        g = g + torch.einsum("bnki,bnk->bi", jw, r)
        cost = cost + 0.5 * (huber_cost(s, delta) * m).sum(-1)
        n_active = n_active + f.mask.sum(-1)
    return h, g, cost, n_active


class SolveStats(NamedTuple):
    cost0: torch.Tensor
    cost: torch.Tensor
    n_factors: torch.Tensor
    clamped: torch.Tensor     # iterations whose update hit the norm clamp
    nonfinite: torch.Tensor   # iterations rejected for NaN/Inf deltas


# Per-iteration update-norm ceilings (rad, m): LOAM inter-frame motion is
# far below them; a singular solve's delta is far above.
_MAX_DTHETA = 0.5
_MAX_DT = 5.0


def lm_solve(factors: Sequence, q0, t0, n_iters: int,
             huber_delta: float = 0.1, lambda0: float = 1e-4):
    """Fixed-iteration Levenberg-Marquardt per stream (the reference's max
    4 Ceres iterations, laserOdometry.cpp:496). A step that raises the
    robust cost is rolled back and λ grows; a non-finite delta is rejected
    and counted; oversized updates are norm-clamped and counted. With no
    active factors the pose comes back unchanged."""
    bsz = q0.shape[0]
    dev = q0.device
    eye = torch.eye(6, dtype=torch.float32, device=dev)
    h, g, cost, n_factors = _accumulate(factors, q0, t0, huber_delta)
    cost0 = cost
    q, t = q0, t0
    lam = torch.full((bsz,), lambda0, dtype=torch.float32, device=dev)
    n_clamp = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    n_nan = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    for _ in range(n_iters):
        # Marquardt damping on the diagonal + a floor for empty problems
        diag = torch.diag_embed(torch.diagonal(h, dim1=-2, dim2=-1)) \
            + 1e-8 * eye
        delta = torch.linalg.solve_ex(h + lam[:, None, None] * diag,
                                      -g[..., None])[0][..., 0]
        finite = torch.isfinite(delta).all(dim=-1)
        delta = torch.where(finite[:, None], delta, 0.0)
        nth = torch.linalg.vector_norm(delta[:, :3], dim=-1)
        ntr = torch.linalg.vector_norm(delta[:, 3:], dim=-1)
        sc_th = (_MAX_DTHETA / nth.clamp_min(1e-20)).clamp_max(1.0)
        sc_tr = (_MAX_DT / ntr.clamp_min(1e-20)).clamp_max(1.0)
        hit_clamp = finite & ((sc_th < 1.0) | (sc_tr < 1.0))
        q_new = geo.retract(q, delta[:, :3] * sc_th[:, None])
        t_new = t + delta[:, 3:] * sc_tr[:, None]
        h_new, g_new, cost_new, _ = _accumulate(factors, q_new, t_new,
                                                huber_delta)
        accept = finite & (cost_new < cost)
        q = torch.where(accept[:, None], q_new, q)
        t = torch.where(accept[:, None], t_new, t)
        h = torch.where(accept[:, None, None], h_new, h)
        g = torch.where(accept[:, None], g_new, g)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, (lam / 3.0).clamp_min(1e-7),
                          (lam * 10.0).clamp_max(1e4))
        n_clamp = n_clamp + hit_clamp
        n_nan = n_nan + ~finite
    # a non-finite pose (the guards above prevent it) falls back to the prior
    pose_ok = (torch.isfinite(q).all(dim=-1)
               & torch.isfinite(t).all(dim=-1))[:, None]
    q = torch.where(pose_ok, q, q0)
    t = torch.where(pose_ok, t, t0)
    return q, t, SolveStats(cost0=cost0, cost=cost, n_factors=n_factors,
                            clamped=n_clamp, nonfinite=n_nan)


def lm_solve_b(edges: EdgeFactors, planes: PlaneFactors, q0, t0,
               n_iters: int, huber_delta: float = 0.1,
               lambda0: float = 1e-4):
    """``lm_solve`` over one edge and one plane factor batch (the shape
    both pipeline stages use) as one solve of ops/lm.py."""
    pose = torch.cat([q0, t0, torch.zeros_like(t0[:, :1])], dim=1)
    out = lm_op.lm_fused(lm_op.pack_edge_channels(edges),
                         lm_op.pack_plane_channels(planes),
                         pose.contiguous(), n_iters, huber_delta, lambda0)
    return (out[:, lm_op.OUT_Q:lm_op.OUT_Q + 4],
            out[:, lm_op.OUT_T:lm_op.OUT_T + 3],
            SolveStats(cost0=out[:, lm_op.OUT_COST0],
                       cost=out[:, lm_op.OUT_COST],
                       n_factors=out[:, lm_op.OUT_NFAC].to(torch.int32),
                       clamped=out[:, lm_op.OUT_CLAMP].to(torch.int32),
                       nonfinite=out[:, lm_op.OUT_NAN].to(torch.int32)))
