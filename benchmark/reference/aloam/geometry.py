"""Quaternion / SE(3) primitives (port of ``aloam_tpu/geometry.py``).

Unit quaternions are ``(..., 4)`` tensors in **wxyz** order, vectors
``(..., 3)``; every function broadcasts over leading batch dims. The
solver's retraction is the left-multiplied ``q' = exp(delta) ⊗ q`` of
Ceres' ``EigenQuaternionParameterization`` (laserOdometry.cpp:286).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def qidentity(device=None, dtype=torch.float32) -> torch.Tensor:
    """A fresh identity quaternion, made on ``device`` by device operations
    (no host copy, so a CUDA graph capture can run it; fresh, so no state
    leaf built from it aliases another)."""
    q = torch.zeros(4, dtype=dtype, device=device)
    q[:1].fill_(1.0)      # q[0] = 1.0 would copy a host scalar
    return q


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (wxyz)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def qconj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (= conjugate)."""
    return qconj(q)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / n.clamp_min(_EPS)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q:
    v + 2*qw*(u×v) + 2*u×(u×v), u = q.xyz."""
    u = q[..., 1:4]
    w = q[..., 0:1]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def qrot_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q^{-1}."""
    return qrot(qconj(q), v)


def q_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def mat_to_q(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (wxyz), branch-free:
    all four Shepperd candidates, the best-conditioned one chosen by the
    largest of (tr, m00 − m11 − m22, −m00 + m11 − m22, −m00 − m11 + m22),
    the first on a tie."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def four(s):
        return 2.0 * s.clamp_min(_EPS).sqrt()

    s0 = four(1.0 + tr)
    s1 = four(1.0 + m00 - m11 - m22)
    s2 = four(1.0 - m00 + m11 - m22)
    s3 = four(1.0 - m00 - m11 + m22)
    cands = torch.stack([
        torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                     (m10 - m01) / s0], dim=-1),
        torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                     (m02 + m20) / s1], dim=-1),
        torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                     (m12 + m21) / s2], dim=-1),
        torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                     0.25 * s3], dim=-1),
    ], dim=-2)                                              # (..., 4, 4)
    scores = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    idx = scores.argmax(dim=-1)[..., None, None].expand(
        scores.shape[:-1] + (1, 4))
    return qnormalize(cands.gather(-2, idx)[..., 0, :])


def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) tangent -> unit quaternion exp(phi), with the
    small-angle Taylor branch of the reference implementation."""
    theta_sq = (phi * phi).sum(dim=-1, keepdim=True)
    theta = theta_sq.clamp_min(_EPS).sqrt()
    half = 0.5 * theta
    small = theta_sq < 1e-8
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def log_so3(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> axis-angle tangent (the inverse of exp_so3), from
    the w ≥ 0 representative."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = q[..., 0].clamp(-1.0, 1.0)
    v = q[..., 1:4]
    vn = torch.linalg.vector_norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    k = torch.where(vn < 1e-8, 2.0, theta / vn.clamp_min(_EPS))
    return k[..., None] * v


def retract(q: torch.Tensor, dtheta: torch.Tensor) -> torch.Tensor:
    """Local-parameterization update q' = exp(dtheta) ⊗ q (left-multiply)."""
    return qnormalize(qmul(exp_so3(dtheta), q))


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product (hat) matrix [v]x (..., 3, 3), [v]x @ u = v × u."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def compose(q_a: torch.Tensor, t_a: torch.Tensor,
            q_b: torch.Tensor, t_b: torch.Tensor):
    """SE(3) composition (q_a,t_a) ∘ (q_b,t_b): first apply b, then a
    (the odometry accumulation of laserOdometry.cpp:504-505)."""
    return qmul(q_a, q_b), t_a + qrot(q_a, t_b)


def inverse_pose(q: torch.Tensor, t: torch.Tensor):
    """The inverse of SE(3) (q, t): (q*, −q*·t)."""
    qi = qconj(q)
    return qi, -qrot(qi, t)


def transform(q: torch.Tensor, t: torch.Tensor,
              pts: torch.Tensor) -> torch.Tensor:
    """Apply SE(3) (q, t) to points (..., 3)."""
    return qrot(q, pts) + t
