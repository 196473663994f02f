"""Nearest-neighbour search (port of ``aloam_tpu/neighbors.py``).

The reference rebuilds a KD-tree every frame (laserOdometry.cpp:567-568,
laserMapping.cpp:558-559) and runs 1-NN / 5-NN queries per point. Here
the search is exhaustive and exact, like the KD-tree:
``odom_window_mins_b`` is the odometry's global 1-NN and ring-window
minima in one kernel launch (ops/odom.py); ``knn`` is the dense k-NN over
a (Q, M) distance block, or ``knn_streamed`` over M-chunks with a running
top-k when the block would not fit (``parallel.sharding.sharded_knn``'s
local search). ``nn1`` and ``odom_window_mins`` are the single-stream
API of the JAX package: the dense 1-NN, and ``odom_window_mins_b`` at
B = 1."""

from __future__ import annotations

import torch

from aloam_tpu_torch.ops import odom as odom_op

_POISON = 1e9
_INF = float("inf")
_DENSE_MAX = 32 * 1024 * 1024    # Q·M scores in one block: 128 MB of f32


def dist2_matrix(query: torch.Tensor, ref: torch.Tensor,
                 ref_mask: torch.Tensor | None = None,
                 center: torch.Tensor | None = None) -> torch.Tensor:
    """Squared euclidean distances (Q, M) of query (Q, 3) to ref (M, 3);
    masked refs get +inf.

    Both sets are recentred on the query mean first (smaller coordinates
    round less), and d2 = |q|² − 2 q·r + |r|², clamped at 0, as the JAX
    package computes it (on the CPU ``torch.matmul`` rounds the cross
    term as JAX's f32 product does, bit for bit). The product must run in
    full f32: JAX forces ``Precision.HIGHEST`` because a reduced-precision
    pass corrupts the 1.0 / 25.0 m² gates (laserOdometry.cpp:65,
    laserMapping.cpp:584), and TF32 on the card does the same damage, so a
    CUDA call raises unless ``torch.get_float32_matmul_precision()`` is
    "highest"."""
    if query.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "dist2_matrix: the f32 product would run in TF32 "
            f"(float32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r}); set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    if center is None:
        center = query.mean(dim=0)
    q = query - center
    r = ref - center
    q2 = (q * q).sum(dim=-1, keepdim=True)
    r2 = (r * r).sum(dim=-1)
    cross = torch.matmul(q, r.T)
    d2 = (q2 - 2.0 * cross + r2[None, :]).clamp_min_(0.0)
    if ref_mask is not None:
        d2 = d2.masked_fill_(~ref_mask[None, :], _INF)
    return d2


def nn1(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor):
    """1-NN of query (Q, 3) among the valid rows of ref (M, 3): (d2 (Q,),
    idx (Q,) int32), ties to the lowest index."""
    d2 = dist2_matrix(query, ref, ref_mask)
    return d2.min(dim=-1).values, d2.argmin(dim=-1).to(torch.int32)


def smallest_k(d2: torch.Tensor, idx: torch.Tensor, k: int):
    """The k smallest of each row of d2 (Q, N) with their idx (Q, N),
    ascending; equal distances (+inf included) go to the lowest idx, as
    ``lax.top_k`` keeps the lowest position first (every caller lists
    tied candidates in ascending idx order).

    One ``torch.topk`` over int64 keys (d2's bits << 32 | idx): the bits
    of a non-negative f32 keep its order, +inf sorts last, and distinct
    idx make every key distinct, so the pick is exact and needs no stable
    sort of the whole row. d2 must be non-negative or +inf, as
    ``dist2_matrix`` gives it."""
    key = (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | idx
    key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return ((key >> 32).to(torch.int32).view(torch.float32),
            key & 0xFFFFFFFF)


def knn_streamed(query: torch.Tensor, ref: torch.Tensor,
                 ref_mask: torch.Tensor, k: int, chunk: int = 8192):
    """Exact k-NN with bounded memory: over M-chunks of the reference,
    merging a running top-k. Returns (d2 (Q, k), idx (Q, k) int64),
    ascending. The running top-k starts at (+inf, index 0) and the ref is
    padded with masked rows to a multiple of ``chunk``, as the JAX scan
    does, so a query with fewer than k valid refs gets index 0 in its
    +inf slots. Memory high-water: Q·(chunk + k) f32, independent of M."""
    m, nq = ref.shape[0], query.shape[0]
    if m % chunk:
        pad = chunk - m % chunk
        ref = torch.cat([ref, ref.new_zeros((pad, 3))])
        ref_mask = torch.cat([ref_mask, ref_mask.new_zeros((pad,))])
        m += pad
    center = query.mean(dim=0)
    best_d = query.new_full((nq, k), _INF)
    best_i = torch.zeros((nq, k), dtype=torch.int64, device=query.device)
    cols = torch.arange(chunk, device=query.device)
    for lo in range(0, m, chunk):
        d2 = dist2_matrix(query, ref[lo:lo + chunk],
                          ref_mask[lo:lo + chunk], center)
        best_d, best_i = smallest_k(
            torch.cat([best_d, d2], dim=1),
            torch.cat([best_i, (lo + cols).expand(nq, chunk)], dim=1), k)
    return best_d, best_i


def knn(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
        k: int, chunk: int = 8192):
    """k-NN of query (Q, 3) among the valid rows of ref (M, 3): one
    distance block when Q·M ≤ 32 Mi, else ``knn_streamed``. Returns (d2
    (Q, k), idx (Q, k) int64), ascending; ties go to the lowest index."""
    nq, m = query.shape[0], ref.shape[0]
    if nq * m <= _DENSE_MAX:
        d2 = dist2_matrix(query, ref, ref_mask)
        cols = torch.arange(m, device=query.device).expand(nq, m)
        return smallest_k(d2, cols, k)
    return knn_streamed(query, ref, ref_mask, k, chunk)


def odom_window_mins_b(sel: torch.Tensor, ref: torch.Tensor,
                       ref_mask: torch.Tensor, ref_ring: torch.Tensor,
                       nearby_scan: int, want_same_ring: bool,
                       ring_seg: int = 0):
    """sel (B, Q, 3) queries; ref (B, M, 3) with ref_mask (B, M) and integer
    ref_ring (B, M).

    Pass 1 is the global 1-NN (the KD-tree query, :302/:390). Pass 2 takes
    the minima over the different-ring window 1 ≤ |Δring| ≤ nearby_scan
    (:312-361) and, with ``want_same_ring``, over the NN's own ring without
    the NN itself (minPointInd2, :402-428). Ties go to the lowest index.
    ``ring_seg`` > 0 declares the reference ring-segmented (ring r in rows
    [r·ring_seg, (r+1)·ring_seg), a ``features.ring_heads`` output), so
    pass 2 scans only the rows of the neighbour's ring window; the outputs
    do not change.
    Returns (d2_nn, nn, d2_diff, idx_diff[, d2_same, idx_same]).

    Both sets are recentred on the query mean before the kernel (smaller
    coordinates round less), and invalid reference points are poisoned at
    1e9 after centring, which puts them beyond every distance gate and
    ring window. The mean is summed in fixed point (1/1024 m): an integer
    sum does not depend on the order the card adds in, where a float
    reduction's order follows the batch's size, so a stream's outputs do
    not depend on the batch it is stepped in."""
    center = ((sel * 1024.0).round().to(torch.int64).sum(dim=1, keepdim=True)
              .to(torch.float32) / (1024.0 * sel.shape[1]))  # (B, 1, 3)
    ref_p = torch.cat(
        [torch.where(ref_mask[:, None, :], (ref - center).transpose(1, 2),
                     _POISON),
         torch.where(ref_mask, ref_ring.to(torch.float32), _POISON)[:, None]],
        dim=1).contiguous()
    outs = odom_op.window_mins((sel - center).contiguous(), ref_p,
                               float(nearby_scan), want_same_ring, ring_seg)
    return outs if want_same_ring else outs[:4]


def odom_window_mins(sel: torch.Tensor, ref: torch.Tensor,
                     ref_mask: torch.Tensor, ref_ring: torch.Tensor,
                     nearby_scan: int, want_same_ring: bool,
                     chunk: int = 8192):
    """:func:`odom_window_mins_b` of one stream, exhaustive (ring_seg 0):
    sel (Q, 3), ref (M, 3), ref_mask and ref_ring (M,). ``chunk`` is the
    JAX package's memory bound on its scan; the kernel tiles on its own
    and the outputs do not depend on it. Returns (d2_nn, nn, d2_diff,
    idx_diff[, d2_same, idx_same]), each (Q,)."""
    del chunk
    outs = odom_window_mins_b(sel[None], ref[None], ref_mask[None],
                              ref_ring[None], nearby_scan, want_same_ring)
    return tuple(o[0] for o in outs)
