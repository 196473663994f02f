"""Segmented prefix sums for the voxel downsample (kernel module; here the
frozen plain copy: the CUDA kernel named below is not part of it, and every
entry point runs the plain version on any device).

Port of ``aloam_tpu/ops/pallas_voxel.py:segmented_prefix_sums``. The CUDA
kernel is ``csrc/seg_scan.cu``: rows are cut into tiles of 256·E elements,
one block per tile scans its tile and records the tile's aggregate, and a
second launch carries each open segment into the tiles after it
(:func:`launch_plan` picks E and the tile count). The plain version beside
it is a float64 running sum with the sum before each segment's head
subtracted, which resets at heads without cancellation error.
"""

from __future__ import annotations

import torch


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
    return segmented_prefix_sums_plain(vals, heads)

