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


def retract(q: torch.Tensor, dtheta: torch.Tensor) -> torch.Tensor:
    """Local-parameterization update q' = exp(dtheta) ⊗ q (left-multiply)."""
    return qnormalize(qmul(exp_so3(dtheta), q))


def slerp(q0: torch.Tensor, q1: torch.Tensor, s) -> torch.Tensor:
    """Spherical interpolation from q0 to q1 by fraction s ∈ [0, 1] (s
    broadcasts against the quaternions' leading dims). Eigen's
    ``Quaterniond::slerp`` (laserOdometry.cpp:120, lidarFactor.hpp:29): the
    shortest-path sign flip and the small-angle LERP fallback."""
    s = torch.as_tensor(s, dtype=q0.dtype, device=q0.device)[..., None]
    dot = (q0 * q1).sum(dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = dot.abs().clamp(-1.0, 1.0)
    theta = torch.acos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, 1.0, sin_theta)
    w0 = torch.where(small, 1.0 - s, torch.sin((1.0 - s) * theta) / safe)
    w1 = torch.where(small, s, torch.sin(s * theta) / safe)
    return qnormalize(w0 * q0 + w1 * q1)


def compose(q_a: torch.Tensor, t_a: torch.Tensor,
            q_b: torch.Tensor, t_b: torch.Tensor):
    """SE(3) composition (q_a,t_a) ∘ (q_b,t_b): first apply b, then a
    (the odometry accumulation of laserOdometry.cpp:504-505)."""
    return qmul(q_a, q_b), t_a + qrot(q_a, t_b)
