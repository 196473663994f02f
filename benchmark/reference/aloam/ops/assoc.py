"""Fused mapping association (kernel module; here the frozen plain copy: the
CUDA kernel named below is not part of it, and every entry point runs the
plain version on any device).

Port of ``aloam_tpu/ops/pallas_assoc.py``: per cell-sorted query, pick its
cell's candidate row, run the gated 5-NN select, then the PCA line fit
(corner) or the plane fit (surf) of laserMapping.cpp:577-705, and emit 8
floats. The CUDA kernel is ``csrc/assoc.cu``: a warp owns 8 queries,
stages the row of each run of queries that share a cell once in shared
memory, selects two queries of a run at once with the lanes spread over
the candidates, and then fits one query per lane. The plain version
beside it is the JAX package's XLA path: a per-query row gather with the
5-pass select (``ops/knn.knn_select_plain``, called as the plain version
on every device), then :func:`assoc_xla`.

Packed output columns, (N, 8) f32 for both kinds:
  corner: [ax, ay, az, bx, by, bz, ok, d2_4]
  surf:   [nx, ny, nz, neg_oa, ok, d2_4, 0, 0]

Both versions compute d2 = ((x-qx)^2 + (y-qy)^2) + (z-qz)^2 one rounded
operation at a time and pick with lowest-index ties, so their 5-sets are
identical; the fits evaluate the same expressions in the same order
(ops/linalg3.py).
"""

from __future__ import annotations

import torch

from benchmark.reference.aloam.ops import knn as knn_op
from benchmark.reference.aloam.ops.linalg3 import eigh3, solve3, true_div


OUT_W = 8
_KINDS = {"corner": 0, "surf": 1}


def _sum5(v):
    return (((v[0] + v[1]) + v[2]) + v[3]) + v[4]


def assoc_xla(d2: torch.Tensor, near: torch.Tensor, gate_sq: float,
              kind: str, plane_tol: float = 0.2, eigen_ratio: float = 3.0,
              half_len: float = 0.1) -> torch.Tensor:
    """The association fit on (..., 5) neighbour distances and (..., 5, 3)
    neighbours (port of ``pallas_assoc.assoc_xla``). Neighbours of a query
    whose 5th distance fails the gate are zeroed before the fit. Returns
    the (..., 8) packed columns."""
    gate = d2[..., 4] < gate_sq
    near = torch.where(gate[..., None, None], near, 0.0)
    pts = [[near[..., k, i] for k in range(5)] for i in range(3)]
    s = [_sum5(pts[i]) for i in range(3)]
    cen = [true_div(s[i], 5.0) for i in range(3)]
    dev = [[v - cen[i] for v in pts[i]] for i in range(3)]

    def dot5(i, j):
        return _sum5([dev[i][k] * dev[j][k] for k in range(5)])

    zero = torch.zeros_like(d2[..., 4])
    if kind == "surf":
        # normal equations of A n = -1 over the 5 neighbours: the centred
        # Gram plus 5 c c^T (== sum p p^T, better conditioned in f32)
        ata = torch.stack([torch.stack([dot5(i, j) + 5.0 * cen[i] * cen[j]
                                        for j in range(3)], -1)
                           for i in range(3)], -2)
        nv = solve3(ata, torch.stack([-s[i] for i in range(3)], -1),
                    reg=1e-9)
        n_norm = (nv[..., 0] * nv[..., 0] + nv[..., 1] * nv[..., 1]
                  + nv[..., 2] * nv[..., 2]).sqrt()
        neg_oa = 1.0 / n_norm.clamp_min(1e-12)
        nh = [nv[..., i] * neg_oa for i in range(3)]
        ok = gate
        for k in range(5):
            res = (pts[0][k] * nh[0] + pts[1][k] * nh[1]
                   + pts[2][k] * nh[2] + neg_oa).abs()
            ok = ok & (res <= plane_tol)
        return torch.stack([nh[0], nh[1], nh[2], neg_oa, ok.to(d2.dtype),
                            d2[..., 4], zero, zero], dim=-1)
    cov = torch.stack([torch.stack([dot5(i, j) for j in range(3)], -1)
                       for i in range(3)], -2)
    vals, direction = eigh3(cov)
    ok = gate & (vals[..., 2] > eigen_ratio * vals[..., 1])
    a = [cen[i] + half_len * direction[..., i] for i in range(3)]
    b = [cen[i] - half_len * direction[..., i] for i in range(3)]
    return torch.stack(a + b + [ok.to(d2.dtype), d2[..., 4]], dim=-1)


def _rows(cand_flat, cid0, q8, tq: int, cspan: int):
    """Each query's candidate row and its poison flag: the query's own
    poison, or a cell beyond the tile's clipped window (align8(cid0) +
    cspan + 8 rows)."""
    n = q8.shape[0]
    win = (cspan if 0 < cspan <= tq else tq) + 8
    local = q8[:, 4].to(torch.int64)
    c0 = cid0.to(torch.int64).repeat_interleave(tq)[:n]
    rem = c0 - 8 * torch.div(c0, 8, rounding_mode="floor")
    poison = (q8[:, 3] > 0) | (local + rem >= win)
    return c0 + local, poison


def assoc_cell_plain(cand_flat, cid0, q8, kind: str, gate_sq: float,
                     plane_tol: float = 0.2, eigen_ratio: float = 3.0,
                     half_len: float = 0.1, tq: int = 256,
                     cspan: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`assoc_cell`: every query gathers
    its row and runs the plain select (never the knn kernel, whatever the
    device); a poisoned query reads row 0 with +inf distances."""
    row, poison = _rows(cand_flat, cid0, q8, tq, cspan)
    q4 = torch.cat([q8[:, :3], poison[:, None].to(q8.dtype)], dim=1)
    d2, near = knn_op.knn_select_plain(cand_flat, torch.where(poison, 0, row),
                                       q4, 5)
    return assoc_xla(d2, near, gate_sq, kind, plane_tol, eigen_ratio,
                     half_len)


def assoc_cell(cand_flat: torch.Tensor, cid0: torch.Tensor, q8: torch.Tensor,
               kind: str, gate_sq: float, plane_tol: float = 0.2,
               eigen_ratio: float = 3.0, half_len: float = 0.1,
               tq: int = 256, cspan: int = 0) -> torch.Tensor:
    """Fused association over cell-sorted queries.

    cand_flat (Ctot, 8·3·bw) f32 block-planar candidate rows of every
    stream's cell slots, padded so each tile's window is in bounds;
    cid0 (N/tq,) int32, the first query's flattened cell slot per tile;
    q8 (N, 8) f32 [x, y, z, poison, local, 0, 0, 0] with local = cid -
    cid0[tile] (cid is non-decreasing within a tile). poison > 0 gates a
    query. With 0 < cspan < tq a query whose cell lies at or past
    align8(cid0) + cspan + 8 is gated too (callers count it). Returns
    (N, 8) f32 packed columns (see the module docstring). CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if kind not in _KINDS:
        raise ValueError(f"assoc_cell: kind {kind!r}")
    return assoc_cell_plain(cand_flat, cid0, q8, kind, gate_sq,
                            plane_tol, eigen_ratio, half_len, tq, cspan)

