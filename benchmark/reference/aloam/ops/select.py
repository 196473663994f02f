"""Greedy sharp/flat feature selection (kernel module; here the frozen plain
copy: the CUDA kernel named below is not part of it, and every entry point
runs the plain version on any device).

Port of ``aloam_tpu/ops/pallas_select.py:select_rings``. The CUDA kernel
is ``csrc/select.cu``: one block per ring row stages the row in shared
memory, and a warp walks each region's 24 sequential picks, each lane
caching the best of its own columns; the regions are walked at once and
checked in order afterwards (a region whose walk met the marks of the one
before is walked again). The plain version beside it runs the same walk
on all rows at once: each pick is one masked extremum over the (R', C)
grid, ties to the lowest index, then the closed-form gap-stopped NMS mark
of ``aloam_tpu/frontend/features._select_rings``.
"""

from __future__ import annotations

import torch


def select_rings_plain(curv, bcum, spep, n_regions: int, max_sharp: int,
                       max_less_sharp: int, max_flat: int, nms_window: int,
                       curv_thr: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`select_rings`."""
    r, c = curv.shape
    idx = torch.arange(c, device=curv.device)[None, :]
    picked = torch.zeros((r, c), dtype=torch.bool, device=curv.device)
    label = torch.zeros((r, c), dtype=torch.int32, device=curv.device)
    corner_ok = curv > curv_thr
    flat_ok = curv < curv_thr

    def pick(window, want_max, thr_mask, lbl, mark_nbrs):
        nonlocal picked, label
        elig = window & ~picked & thr_mask
        fill = float("-inf") if want_max else float("inf")
        score = torch.where(elig, curv, fill)
        best = score.amax(dim=1) if want_max else score.amin(dim=1)
        ok = torch.isfinite(best)[:, None]
        cand = torch.where(score == best[:, None], idx, c).amin(dim=1)
        cand = cand.clamp_max(c - 1)[:, None]
        at_cand = ok & (idx == cand)
        label = torch.where(at_cand, lbl, label)
        if mark_nbrs:
            b_cand = bcum.gather(1, cand)
            mark = ((idx - cand).abs() <= nms_window) & (bcum == b_cand) & ok
            picked = picked | mark

    for j in range(n_regions):
        window = (idx >= spep[:, j:j + 1]) & (idx <= spep[:, n_regions + j:
                                                          n_regions + j + 1])
        for t in range(max_less_sharp):
            pick(window, True, corner_ok, 2 if t < max_sharp else 1, True)
        for t in range(max_flat):
            # the last flat pick labels but suppresses nothing
            # (scanRegistration.cpp:358-362)
            pick(window, False, flat_ok, -1, t < max_flat - 1)
    return label


def select_rings(curv: torch.Tensor, bcum: torch.Tensor, spep: torch.Tensor,
                 n_regions: int, max_sharp: int, max_less_sharp: int,
                 max_flat: int, nms_window: int,
                 curv_thr: float) -> torch.Tensor:
    """curv (R', C) f32; bcum (R', C) int32 bad-gap prefix counts; spep
    (R', 2*n_regions) f32 [sp... | ep...] (ep = -1 disables a region).
    Returns label (R', C) int32: 2 sharp, 1 less-sharp, -1 flat, 0 other.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (:func:`check_launch`: a row within a block's shared memory, at most
    ``MAX_REGIONS`` regions)."""
    args = (n_regions, max_sharp, max_less_sharp, max_flat, nms_window)
    return select_rings_plain(curv, bcum, spep, *args, curv_thr)

