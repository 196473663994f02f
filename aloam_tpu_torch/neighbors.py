"""Odometry nearest-neighbour search (port of
``aloam_tpu/neighbors.py:odom_window_mins_b``).

The reference rebuilds a KD-tree every frame and walks the ring-ordered
cloud around the nearest neighbour (laserOdometry.cpp:299-483). Here the
search is exhaustive and exact, like the KD-tree: the global 1-NN, then
the minima over the ring windows around the neighbour's ring, in one
kernel launch (ops/odom.py)."""

from __future__ import annotations

import torch

from aloam_tpu_torch.ops import odom as odom_op

_POISON = 1e9


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
    ring window."""
    center = sel.mean(dim=1, keepdim=True)                   # (B, 1, 3)
    ref_p = torch.cat(
        [torch.where(ref_mask[:, None, :], (ref - center).transpose(1, 2),
                     _POISON),
         torch.where(ref_mask, ref_ring.to(torch.float32), _POISON)[:, None]],
        dim=1).contiguous()
    outs = odom_op.window_mins((sel - center).contiguous(), ref_p,
                               float(nearby_scan), want_same_ring, ring_seg)
    return outs if want_same_ring else outs[:4]
