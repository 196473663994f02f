"""Gated k-NN select over candidate rows (kernel module).

Port of ``aloam_tpu/ops/pallas_knn.py:knn_select``, the select tail of
``gridmap.knn_from_cache_b``: per query, its cell's block-planar candidate
row (8 sub-blocks of [x(bw) | y(bw) | z(bw)], candidate j = block·bw + e),
d2 = ((x-qx)^2 + (y-qy)^2) + (z-qz)^2 one rounded operation at a time,
+inf for a gated query, then k passes that each take the minimum with the
lowest index on a tie and set it to +inf.

The CUDA kernel is ``csrc/knn.cu``: one warp per query, which reads the
query's row in place from the cell cache (the TPU kernel took a gathered
(Q, 24·bw) row copy). The plain version beside it gathers the rows, in
chunks, and runs :func:`select_passes`. The two agree bit for bit.
"""

from __future__ import annotations

import torch

from aloam_tpu_torch.ops import _build

launches = 0  # kernel launches since the last reset

_INF = float("inf")
# queries per gather chunk of the plain version (bounds its (chunk, 24·bw)
# row copy)
_PLAIN_CHUNK = 8192


def select_passes(crow: torch.Tensor, q: torch.Tensor, poison: torch.Tensor,
                  k: int):
    """Gated k-pass select over block-planar candidate rows.

    crow (..., 8·3·bw); q (..., 3) queries, poison (...) bool (all
    distances +inf). Each pass takes the minimum d2 with the lowest index
    on a tie and sets it to +inf, so a row with fewer than k finite
    candidates picks its lowest-index +inf candidate from then on. Returns
    (d2 (..., k), nbrs (..., k, 3))."""
    lead = crow.shape[:-1]
    bw = crow.shape[-1] // 24
    blk = crow.reshape(lead + (8, 3, bw))
    xs, ys, zs = (blk[..., c, :].reshape(lead + (8 * bw,)) for c in range(3))
    dx = xs - q[..., 0:1]
    dy = ys - q[..., 1:2]
    dz = zs - q[..., 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    d2 = torch.where(poison[..., None], _INF, d2)
    ds, nb = [], []
    for _ in range(k):
        am = d2.argmin(dim=-1, keepdim=True)
        ds.append(d2.gather(-1, am))
        nb.append(torch.cat([c.gather(-1, am) for c in (xs, ys, zs)], -1))
        d2 = d2.scatter(-1, am, _INF)
    return torch.cat(ds, -1), torch.stack(nb, -2)


def knn_select_plain(cand_flat: torch.Tensor, row: torch.Tensor,
                     q: torch.Tensor, k: int, chunk: int = 0):
    """Plain PyTorch version of :func:`knn_select`: each query's row
    gathered, ``chunk`` queries at a time (0: 8192), then
    :func:`select_passes`."""
    step = chunk or _PLAIN_CHUNK
    ds, nbs = [], []
    for s in range(0, q.shape[0], step):
        qs = q[s:s + step]
        d2, nb = select_passes(cand_flat[row[s:s + step].long()], qs[:, :3],
                               qs[:, 3] > 0, k)
        ds.append(d2)
        nbs.append(nb)
    return torch.cat(ds), torch.cat(nbs)


def knn_select(cand_flat: torch.Tensor, row: torch.Tensor, q: torch.Tensor,
               k: int, chunk: int = 0):
    """Gated k-NN of each query over its candidate row.

    cand_flat (R, 8·3·bw) f32 block-planar candidate rows; row (N,) int32,
    each query's row in [0, R); q (N, 4) f32 [x, y, z, poison], poison > 0
    gates a query (all distances +inf). Returns (d2 (N, k), nbrs (N, k,
    3)) in pick order. CPU tensors take the plain version (``chunk`` bounds
    its row copy); CUDA tensors launch the kernel (bw <= 64), which reads
    the rows in place."""
    if all(t.device.type == "cpu" for t in (cand_flat, row, q)):
        return knn_select_plain(cand_flat, row, q, k, chunk)
    _build.require_cuda("knn_select", cand_flat, row, q,
                        dtypes=(torch.float32, torch.int32, torch.float32))
    n = q.shape[0]
    w = cand_flat.shape[1]
    if tuple(q.shape) != (n, 4) or tuple(row.shape) != (n,) or w % 24 \
            or not 0 < w // 24 <= 64 or not 0 < k <= w // 3:
        raise ValueError(f"knn_select: cand_flat {tuple(cand_flat.shape)}, "
                         f"row {tuple(row.shape)}, q {tuple(q.shape)}, k {k}")
    d2 = torch.empty((n, k), dtype=torch.float32, device=q.device)
    nbrs = torch.empty((n, k, 3), dtype=torch.float32, device=q.device)
    _build.launch("aloam_knn_select", q.device, cand_flat.data_ptr(),
                  row.data_ptr(), q.data_ptr(), d2.data_ptr(),
                  nbrs.data_ptr(), cand_flat.shape[0], n, w // 24, k)
    global launches
    launches += 1
    return d2, nbrs
