"""Closed-form batched 3x3 linear algebra (port of
``aloam_tpu/ops/linalg3.py``).

The mapping fits need a symmetric 3x3 eigendecomposition per corner query
(covariance PCA, laserMapping.cpp:605) and a 3x3 solve per surf query
(plane-fit normal equations, :663). Both are the JAX package's closed
forms: Smith's trigonometric eigenvalues with the spectral-projector
eigenvector, and a Cramer solve.

Every sum is written out element by element in a fixed order, and
``csrc/assoc.cu`` evaluates the same expressions in the same order, so
the association kernel and its plain version round alike.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12
_TWO_PI_3 = 2.0 * math.pi / 3.0


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as one IEEE division on every device (on CUDA, torch
    turns a division by a Python number into a multiplication by its
    rounded reciprocal)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _clamp_det(det: torch.Tensor) -> torch.Tensor:
    """det with |det| < _EPS replaced by ±_EPS (the sign of det)."""
    return torch.where(det.abs() < _EPS,
                       torch.where(det < 0, -_EPS, _EPS), det)


def solve3(a: torch.Tensor, b: torch.Tensor, reg: float = 0.0):
    """Solve a @ x = b for batched (..., 3, 3) ``a`` and (..., 3) ``b`` via
    the adjugate (Cramer); ``reg`` adds Tikhonov regularization."""
    if reg:
        a = a + reg * torch.eye(3, dtype=a.dtype, device=a.device)
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / _clamp_det(det)
    adj = ((c00, a02 * a21 - a01 * a22, a01 * a12 - a02 * a11),
           (c01, a00 * a22 - a02 * a20, a02 * a10 - a00 * a12),
           (c02, a01 * a20 - a00 * a21, a00 * a11 - a01 * a10))
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(r[0] * b0 + r[1] * b1 + r[2] * b2) * inv_det
                        for r in adj], dim=-1)


def eigh3(a: torch.Tensor):
    """Eigenvalues (ascending) and the principal eigenvector of symmetric
    (..., 3, 3) ``a``.

    Returns (vals (..., 3), v_max (..., 3)), v_max the unit eigenvector of
    the largest eigenvalue (the direction of the fitted line,
    laserMapping.cpp:609). The eigenvector is the largest-norm column of
    the spectral projector (A - l1 I)(A - l2 I) (the first one on a tie);
    a (near-)degenerate top eigenvalue gives the unit x vector, which the
    callers' line test l2 > 3 l1 rejects anyway."""
    m = [[a[..., i, j] for j in range(3)] for i in range(3)]
    q = true_div(m[0][0] + m[1][1] + m[2][2], 3.0)
    bd = [m[i][i] - q for i in range(3)]
    b = [[bd[i] if i == j else m[i][j] for j in range(3)] for i in range(3)]
    p2 = None
    for i in range(3):
        for j in range(3):
            sq = b[i][j] * b[i][j]
            p2 = sq if p2 is None else p2 + sq
    p2 = true_div(p2, 6.0)
    p = p2.clamp_min(_EPS).sqrt()
    c = [[b[i][j] / p for j in range(3)] for i in range(3)]
    r = 0.5 * (c[0][0] * (c[1][1] * c[2][2] - c[1][2] * c[2][1])
               - c[0][1] * (c[1][0] * c[2][2] - c[1][2] * c[2][0])
               + c[0][2] * (c[1][0] * c[2][1] - c[1][1] * c[2][0]))
    phi = true_div(torch.acos(r.clamp(-1.0, 1.0)), 3.0)
    lam0 = q + 2.0 * p * torch.cos(phi)                 # largest
    lam2 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)     # smallest
    lam1 = 3.0 * q - lam0 - lam2
    vals = torch.stack([lam2, lam1, lam0], dim=-1)

    # projector onto the top eigenspace: (A - lam1 I)(A - lam2 I)
    a1 = [[m[i][j] - lam1 if i == j else m[i][j] for j in range(3)]
          for i in range(3)]
    a2 = [[m[i][j] - lam2 if i == j else m[i][j] for j in range(3)]
          for i in range(3)]
    pm = [[a1[i][0] * a2[0][j] + a1[i][1] * a2[1][j] + a1[i][2] * a2[2][j]
           for j in range(3)] for i in range(3)]
    n = [pm[0][j] * pm[0][j] + pm[1][j] * pm[1][j] + pm[2][j] * pm[2][j]
         for j in range(3)]
    s0 = (n[0] >= n[1]) & (n[0] >= n[2])
    s1 = ~s0 & (n[1] >= n[2])
    v = [torch.where(s0, pm[i][0], torch.where(s1, pm[i][1], pm[i][2]))
         for i in range(3)]
    vn = (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]).sqrt()
    good = vn > 1e-8
    den = vn.clamp_min(_EPS)
    v = [torch.where(good, v[i] / den, 1.0 if i == 0 else 0.0)
         for i in range(3)]
    return vals, torch.stack(v, dim=-1)
