"""Gated k-NN select over a query's 2×2×2 bucket block (kernel module; here the
frozen plain copy: the CUDA kernel named below is not part of it, and every
entry point runs the plain version on any device).

Port of ``aloam_tpu/ops/pallas_knn.py:knn_select``: per query, 8 blocks of
bw candidates in the block-planar layout [x(bw) | y(bw) | z(bw)] (candidate
j = block·bw + e), d2 = ((x-qx)^2 + (y-qy)^2) + (z-qz)^2 one rounded
operation at a time, +inf for a gated query, then k passes that each take
the minimum with the lowest index on a tie and set it to +inf.

Two entries share one CUDA kernel (``csrc/knn.cu``, its select in
``csrc/knn_select.cuh``, which ``csrc/assoc.cu`` shares):

* :func:`knn_grid`, the table entry: each query's 8 bucket rows straight
  from the map table, as ``aloam_tpu/ops/gridmap.py:knn`` gathers them (a
  bucket that an earlier cell of the block has is read once, the later
  copy at the ``_FAR`` sentinel). ``gridmap.knn``, the single-stream
  search, calls it. It has no cache and so no cache key: the knn cache's
  key clamps each axis at 1023 cells from the stream's lowest (~2 km at
  2 m cells), so two queries further apart share a slot there and one
  reads the other's block; here, as in JAX's ``knn``, none can.
* :func:`knn_select`, the cache entry: each query's candidate row of a knn
  cache (``gridmap.knn_cache_b``), read in place; the association API
  (``mapping._associations_b``) calls it through
  ``gridmap.knn_from_cache_b``, since its cache is reused across rounds.

The plain versions beside them gather the blocks, ``chunk`` queries at a
time, and run :func:`select_passes`; kernel and plain agree bit for bit.
"""

from __future__ import annotations

import torch


_INF = float("inf")
# queries per gather chunk of the plain versions (bounds their (chunk,
# 24·bw) row copy)
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


def _chunked(n: int, chunk: int, fn):
    """fn(slice) over the queries ``chunk`` at a time (0: 8192), the
    (d2, nbrs) pieces concatenated."""
    step = chunk or _PLAIN_CHUNK
    parts = [fn(slice(s, s + step)) for s in range(0, n, step)]
    return torch.cat([d for d, _ in parts]), torch.cat([b for _, b in parts])


def knn_select_plain(cand_flat: torch.Tensor, row: torch.Tensor,
                     q: torch.Tensor, k: int, chunk: int = 0):
    """Plain PyTorch version of :func:`knn_select`: each query's row
    gathered, ``chunk`` queries at a time (0: 8192), then
    :func:`select_passes`."""
    def part(s):
        qs = q[s]
        return select_passes(cand_flat[row[s].long()], qs[:, :3],
                             qs[:, 3] > 0, k)
    return _chunked(q.shape[0], chunk, part)


def knn_select(cand_flat: torch.Tensor, row: torch.Tensor, q: torch.Tensor,
               k: int, chunk: int = 0):
    """Gated k-NN of each query over its candidate row (the cache entry).

    cand_flat (R, 8·3·bw) f32 block-planar candidate rows; row (N,) int32,
    each query's row in [0, R); q (N, 4) f32 [x, y, z, poison], poison > 0
    gates a query (all distances +inf). Returns (d2 (N, k), nbrs (N, k,
    3)) in pick order. CPU tensors take the plain version (``chunk`` bounds
    its row copy); CUDA tensors launch the kernel (bw a multiple of 4 up to
    64, k <= 8), which reads the rows in place."""
    return knn_select_plain(cand_flat, row, q, k, chunk)


def knn_grid_plain(pts: torch.Tensor, q: torch.Tensor, k: int,
                   cell_size: float, radius: float, chunk: int = 0):
    """Plain PyTorch version of :func:`knn_grid`: each query's 8 bucket
    rows gathered from the table (``gridmap.block_buckets``), duplicates
    at ``_FAR``, ``chunk`` queries at a time (0: 8192), then
    :func:`select_passes`."""
    # gridmap imports this module; its hash is needed only here
    from benchmark.reference.aloam.ops.gridmap import _FAR, block_buckets

    def part(s):
        qs = q[s]
        hh, dup = block_buckets(qs, pts.shape[0], cell_size, radius)
        crow = pts[hh.long()].masked_fill_(dup[..., None], _FAR)
        ungated = torch.zeros(qs.shape[:1], dtype=torch.bool, device=q.device)
        return select_passes(crow.reshape(qs.shape[0], -1), qs, ungated, k)
    return _chunked(q.shape[0], chunk, part)


def knn_grid(pts: torch.Tensor, q: torch.Tensor, k: int, cell_size: float,
             radius: float, chunk: int = 0):
    """Exact k-NN of each query over its 2×2×2 bucket block (the table
    entry).

    pts (H, 3·bw) f32 bucket-planar map table (``GridMap.pts`` of one
    stream, H a power of two); q (N, 3) f32. A query's block is the 8
    cells at floor((q - radius) / cell_size) + ``_offsets8``, hashed as
    ``gridmap._hash``. Returns (d2 (N, k), nbrs (N, k, 3)) in pick order.
    CPU tensors take the plain version (``chunk`` bounds its block copy);
    CUDA tensors launch the kernel (bw a multiple of 4 up to 64, k <= 8),
    which reads the bucket rows in place."""
    return knn_grid_plain(pts, q, k, cell_size, radius, chunk)

