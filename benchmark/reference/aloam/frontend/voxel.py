"""Voxel-grid downsampling on fixed-capacity masked rows (port of
``aloam_tpu/frontend/voxel.py``).

Replaces ``pcl::VoxelGrid`` (scanRegistration.cpp:401-407): one centroid
per occupied voxel, averaging every field, voxels anchored at the origin
(``ijk = floor(coord / leaf)``), output in PCL leaf order (x fastest, then
y, then z). Per row:

1. one stable sort by the voxel key (k, ji), packed into one int64 so
   torch's single-key sort gives the lexicographic order;
2. per-voxel sums by a segmented scan (ops/voxel.py), which leaves each
   voxel's sums at its segment tail;
3. a stable sort that moves the tails to the front, in key order.
"""

from __future__ import annotations

import torch

from benchmark.reference.aloam.ops import voxel as seg_op

_SENTINEL = 2 ** 30
_JI_BITS = 26          # ji = y * 8192 + x < 2^26


def voxel_segment_tails(values: torch.Tensor, mask: torch.Tensor,
                        leaf: float):
    """Voxel sort + segmented sums, before compaction.

    values (R, N, K) with xyz leading, mask (R, N). The key (k, ji) is
    taken after a per-row rebase, so one cloud spans at most 8192 cells
    per axis; invalid rows carry a sentinel k and sort last. Returns
    ``(sums (K, R, N), cnts (R, N), is_tail (R, N))`` in key order: each
    voxel's channel sums and point count sit at its segment tail."""
    r, n, k_dim = values.shape
    ijk = torch.floor(values[..., :3] * (1.0 / leaf)).to(torch.int32)
    base = torch.where(mask[..., None], ijk, _SENTINEL).amin(dim=1,
                                                             keepdim=True)
    rel = (ijk - base).clamp(0, 8191)
    ji = rel[..., 1] * 8192 + rel[..., 0]
    k = torch.where(mask, rel[..., 2], _SENTINEL)
    key = (k.to(torch.int64) << _JI_BITS) | ji.to(torch.int64)
    key_s, order = torch.sort(key, dim=1, stable=True)
    vals_s = values.gather(1, order[..., None].expand(r, n, k_dim))
    mask_s = (key_s >> _JI_BITS) < _SENTINEL

    new_seg = key_s != key_s.roll(1, dims=1)
    new_seg[:, 0] = True
    new_seg = new_seg & mask_s

    # channels (K + count, R, N): payload zeroed outside the mask
    chan = torch.cat([torch.where(mask_s[..., None], vals_s, 0.0),
                      mask_s[..., None].to(values.dtype)], dim=-1)
    prefix = seg_op.segmented_prefix_sums(
        chan.permute(2, 0, 1).contiguous(), new_seg)

    # segment totals sit at TAILS: the slot before the next head (or the
    # last valid slot)
    nxt_head = torch.cat([new_seg[:, 1:] | ~mask_s[:, 1:],
                          torch.ones((r, 1), dtype=torch.bool,
                                     device=mask.device)], dim=1)
    return prefix[:k_dim], prefix[k_dim], mask_s & nxt_head


def _voxel_core(values: torch.Tensor, mask: torch.Tensor, leaf: float,
                out_cap: int):
    """Segment stage + tail compaction. Returns (means (R, out_cap, K),
    out_mask (R, out_cap), drops (R,))."""
    r, n, k_dim = values.shape
    sums, cnt_s, is_tail = voxel_segment_tails(values, mask, leaf)
    iota = torch.arange(n, device=values.device)
    _, order = torch.sort(torch.where(is_tail, iota, _SENTINEL), dim=1,
                          stable=True)
    m = min(out_cap, n)
    order = order[:, :m]
    totals = sums.gather(2, order.expand(k_dim, r, m)).permute(1, 2, 0)
    cnts = cnt_s.gather(1, order)

    n_seg = is_tail.sum(dim=1)
    out_mask = torch.arange(out_cap, device=values.device) < n_seg[:, None]
    means = totals / cnts.clamp_min(1.0)[..., None]
    if m < out_cap:
        means = torch.nn.functional.pad(means, (0, 0, 0, out_cap - m))
    means = torch.where(out_mask[..., None], means, 0.0)
    return means, out_mask, (n_seg - out_cap).clamp_min(0)


def voxel_downsample_masked(values: torch.Tensor, mask: torch.Tensor,
                            leaf: float, out_cap: int):
    """:func:`voxel_downsample_masked_b` of one cloud: values (N, K), mask
    (N,). Returns (out (out_cap, K), out_mask (out_cap,), n_dropped)."""
    out, out_mask, dropped = _voxel_core(values[None], mask[None], leaf,
                                         out_cap)
    return out[0], out_mask[0], dropped[0]


def voxel_downsample_masked_b(values: torch.Tensor, mask: torch.Tensor,
                              leaf: float, out_cap: int):
    """Downsample B masked clouds (the mapping input stacks,
    laserMapping.cpp:542-550): values (B, N, K) with xyz leading (every
    column is averaged), mask (B, N). Returns (out (B, out_cap, K),
    out_mask (B, out_cap), n_dropped (B,))."""
    return _voxel_core(values, mask, leaf, out_cap)


def voxel_downsample_rings(xyz: torch.Tensor, intensity: torch.Tensor,
                           mask: torch.Tensor, leaf: float):
    """Per-ring voxel downsample (scanRegistration.cpp:401-407) over the
    leading row axis: xyz (R, C, 3), intensity (R, C), mask (R, C). Output
    capacity per ring = C. Returns (xyz, intensity, mask, drops (R,))."""
    c = xyz.shape[1]
    vals = torch.cat([xyz, intensity[..., None]], dim=-1)
    out, out_mask, dropped = _voxel_core(vals, mask, leaf, c)
    return out[..., :3], out[..., 3], out_mask, dropped
