"""Segmented prefix sums for the voxel downsample (kernel module).

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


_THREADS = 256   # threads per tile block (csrc/seg_scan.cu)


def launch_plan(rows: int, n: int, n_sm: int):
    """(E, tiles): 8 elements per thread unless that leaves fewer than two
    tile blocks per SM, then 4; tiles = ceil(n / (256 E)) per row."""
    e = 8 if rows * -(-n // (_THREADS * 8)) >= 2 * n_sm else 4
    return e, -(-n // (_THREADS * e))


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
    n4 = n + -n % 4
    if n4 != n or vals.data_ptr() % 16 or heads.data_ptr() % 4:
        # the kernel loads 4 elements at a time from aligned rows: copy into
        # fresh rows padded with elements of value 0 and no head, which
        # change no sum before them
        vals4 = vals.new_zeros((k, r, n4))
        heads4 = heads.new_zeros((r, n4))
        vals4[..., :n] = vals
        heads4[:, :n] = heads
        return segmented_prefix_sums(vals4, heads4)[..., :n].contiguous()
    e, tiles = launch_plan(r, n, _build.sm_count(vals.device))
    out = torch.empty_like(vals)
    agg = meta = 0
    if tiles > 1:
        # one scratch buffer: the tile sums (r, tiles, k), then the
        # position of each tile's first head (r, tiles) as int32
        scratch = torch.empty(r * tiles * (k + 1), dtype=torch.float32,
                              device=vals.device)
        agg = scratch.data_ptr()
        meta = agg + r * tiles * k * 4
    _build.launch("aloam_seg_scan", vals.device, vals.data_ptr(),
                  heads.data_ptr(), out.data_ptr(), agg, meta, k, r, n, e,
                  tiles)
    global launches
    launches += 1
    return out
