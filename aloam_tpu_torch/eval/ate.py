"""Trajectory evaluation: ATE (Umeyama-aligned RMSE) and RPE.

The reference offers only a visual rviz overlay against the KITTI GT path
(SURVEY.md §4); this module provides the quantitative equivalent used by the
integration tests and benchmarks (host-side NumPy — evaluation is not on the
hot path)."""

from __future__ import annotations

import numpy as np


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment est -> gt (Umeyama 1991).

    est, gt: (N, 3). Returns (R (3,3), t (3,), s scalar).
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / est.shape[0]
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    rot = u @ s_mat @ vt
    if with_scale:
        var_e = (e ** 2).sum() / est.shape[0]
        scale = float(np.trace(np.diag(d) @ s_mat) / var_e)
    else:
        scale = 1.0
    t = mu_g - scale * rot @ mu_e
    return rot, t, scale


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of aligned positions), meters."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if align:
        rot, t, s = umeyama_align(est, gt)
        est = (s * (rot @ est.T)).T + t
    return float(np.sqrt(((est - gt) ** 2).sum(axis=1).mean()))


def _rot_inv_apply(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Apply R(q)^T to rows of v; q (N,4) wxyz, v (N,3)."""
    q = np.asarray(q, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q.T
    # conjugate rotation: R(q)^T v = R(q*) v
    x, y, z = -x, -y, -z
    uv = np.stack([y * v[:, 2] - z * v[:, 1],
                   z * v[:, 0] - x * v[:, 2],
                   x * v[:, 1] - y * v[:, 0]], axis=-1)
    uuv = np.stack([y * uv[:, 2] - z * uv[:, 1],
                    z * uv[:, 0] - x * uv[:, 2],
                    x * uv[:, 1] - y * uv[:, 0]], axis=-1)
    return v + 2.0 * (w[:, None] * uv + uuv)


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1,
        est_q: np.ndarray | None = None, gt_q: np.ndarray | None = None):
    """Relative pose error at frame spacing delta (translation part).

    With quaternions given, follows the KITTI convention (Geiger et al.
    CVPR 2012): each segment's motion is expressed in its START pose's
    frame, trans(inv(P_i) P_{i+delta}) = R_i^T (t_{i+delta} - t_i), so
    rotational drift shows up in the comparison. Without rotations it
    degrades to world-frame position increments (rotation-blind — fine
    for unit tests that have no orientation stream).
    Returns (rmse_trans, per-step errors)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    d_e = est[delta:] - est[:-delta]
    d_g = gt[delta:] - gt[:-delta]
    if est_q is not None and gt_q is not None:
        d_e = _rot_inv_apply(np.asarray(est_q)[:-delta], d_e)
        d_g = _rot_inv_apply(np.asarray(gt_q)[:-delta], d_g)
    err = np.linalg.norm(d_e - d_g, axis=1)
    return float(np.sqrt((err ** 2).mean())), err


def _q_rel_angle(qa: np.ndarray, qb: np.ndarray) -> np.ndarray:
    """Rotation angle [rad] between wxyz quaternion arrays (N,4)."""
    dot = np.abs(np.sum(qa * qb, axis=-1))
    n = np.linalg.norm(qa, axis=-1) * np.linalg.norm(qb, axis=-1)
    return 2.0 * np.arccos(np.clip(dot / np.maximum(n, 1e-12), -1.0, 1.0))


def rpe_rot(est_q: np.ndarray, gt_q: np.ndarray, delta: int = 1):
    """Rotational relative pose error at frame spacing delta.

    est_q, gt_q: (N, 4) wxyz quaternions. The per-step error is the angle of
    (dq_est^-1 · dq_gt) where dq = q_i^-1 · q_{i+delta}; for unit quaternions
    that angle equals the angle between dq_est and dq_gt. Returns
    (rmse_deg, per-step errors in degrees)."""
    def qmul(a, b):
        w1, x1, y1, z1 = a.T
        w2, x2, y2, z2 = b.T
        return np.stack([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=-1)

    def conj(q):
        return q * np.array([1.0, -1, -1, -1])

    est_q = np.asarray(est_q, np.float64)
    gt_q = np.asarray(gt_q, np.float64)
    d_e = qmul(conj(est_q[:-delta]), est_q[delta:])
    d_g = qmul(conj(gt_q[:-delta]), gt_q[delta:])
    err = np.degrees(_q_rel_angle(d_e, d_g))
    return float(np.sqrt((err ** 2).mean())), err


def kitti_drift(est: np.ndarray, gt: np.ndarray,
                lengths=(100, 200, 300, 400, 500, 600, 700, 800),
                est_q: np.ndarray | None = None,
                gt_q: np.ndarray | None = None):
    """KITTI odometry translational drift [%]: for every start frame and
    every segment length L (by GT arc length), the endpoint translation
    error of the relative motion — each segment anchored in its start
    pose's frame when rotations are given (Geiger et al. CVPR 2012
    convention, translation part; rotation-blind world increments
    otherwise) — as a percentage of L, averaged over all segments.
    Returns (mean_pct or nan, n_segments)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    dist = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(gt, axis=0), axis=1))])
    anchored = est_q is not None and gt_q is not None
    errs = []
    for L in lengths:
        for i in range(len(gt)):
            j = np.searchsorted(dist, dist[i] + L)
            if j >= len(gt):
                break
            d_e = (est[j] - est[i])[None]
            d_g = (gt[j] - gt[i])[None]
            if anchored:
                d_e = _rot_inv_apply(np.asarray(est_q)[i:i + 1], d_e)
                d_g = _rot_inv_apply(np.asarray(gt_q)[i:i + 1], d_g)
            errs.append(np.linalg.norm(d_e[0] - d_g[0]) / L * 100.0)
    if not errs:
        return float("nan"), 0
    return float(np.mean(errs)), len(errs)
