"""Segmented prefix sums for the voxel downsample (kernel module).

Port of ``aloam_tpu/ops/pallas_voxel.py:segmented_prefix_sums``. The CUDA
kernel is ``csrc/seg_scan.cu`` (one warp per row, a shuffle ladder per
32-element chunk, the open segment carried across chunks). The plain
version beside it is a float64 running sum with the sum before each
segment's head subtracted, which resets at heads without cancellation
error.
"""

from __future__ import annotations

import torch

from aloam_tpu_torch.ops import _build

launches = 0  # kernel launches since the last reset


def segmented_prefix_sums_plain(vals: torch.Tensor,
                                heads: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`segmented_prefix_sums`."""
    v = vals.double()
    total = v.cumsum(dim=-1)
    before = total - v                       # exclusive running sum
    n = heads.shape[-1]
    pos = torch.arange(n, device=heads.device).expand_as(heads)
    # index of each element's segment head (position 0 if none yet)
    head_at = torch.where(heads, pos, 0).cummax(dim=-1).values
    start = before.gather(-1, head_at.expand_as(before))
    return (total - start).to(vals.dtype)


def segmented_prefix_sums(vals: torch.Tensor,
                          heads: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive prefix sums along the last axis.

    vals (K, R, N) f32 channels, heads (R, N) bool segment heads. Returns
    (K, R, N): out[k, r, j] = vals[k, r, j] + (heads[r, j] ? 0 :
    out[k, r, j-1]). CPU tensors take the plain version; CUDA tensors
    launch the kernel (K <= 8)."""
    if vals.device.type == "cpu" and heads.device.type == "cpu":
        return segmented_prefix_sums_plain(vals, heads)
    _build.require_cuda("segmented_prefix_sums", vals, heads,
                        dtypes=(torch.float32, torch.bool))
    k, r, n = vals.shape
    if tuple(heads.shape) != (r, n) or not 1 <= k <= 8:
        raise ValueError(f"segmented_prefix_sums: vals {tuple(vals.shape)}, "
                         f"heads {tuple(heads.shape)}")
    out = torch.empty_like(vals)
    _build.launch("aloam_seg_scan", vals.device, vals.data_ptr(),
                  heads.data_ptr(), out.data_ptr(), k, r, n)
    global launches
    launches += 1
    return out
