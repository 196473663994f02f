"""Feature selection and the five frontend clouds (port of
``aloam_tpu/frontend/features.py``, batched form).

Re-design of scanRegistration.cpp:277-408. The reference sorts each
(ring, region) window by curvature and walks it, picking unsuppressed
candidates and NMS-marking ±5 ring neighbours per pick (gap-stopped at
>0.05 m², :319-342). Walking the sorted order while skipping suppressed
points is exactly repeated selection of the extremum of the still-eligible
curvature, so the walk needs no sort: each pick is one masked extremum
(ops/select.py). Ties go to the lowest index; the 4th flat pick is labelled
but marks nothing (:358-362).
"""

from __future__ import annotations

import torch

from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.frontend.voxel import voxel_downsample_rings
from aloam_tpu_torch.ops import select as select_op
from aloam_tpu_torch.types import PointCloud, RingCloud, ScanFeatures
from aloam_tpu_torch.utils.batch import bgather


def _region_bounds(cnt: torch.Tensor, n_regions: int):
    """Per-ring region windows (rel. indices), scanRegistration.cpp:284-285:
    sp_j = 5 + (cnt-11)*j//6, ep_j = 5 + (cnt-11)*(j+1)//6 - 1, for cnt
    (R',). A ring with cnt-11 < 6 is skipped entirely (:279-280). Returns
    (sp, ep, size, ok) with (R', n_regions) leaves and ok (R',)."""
    base = (cnt.to(torch.int64) - 11)[:, None]
    j = torch.arange(n_regions, device=cnt.device)
    sp = 5 + torch.div(base * j, n_regions, rounding_mode="floor")
    ep = 5 + torch.div(base * (j + 1), n_regions, rounding_mode="floor") - 1
    ok = base[:, 0] >= n_regions
    size = torch.where(ok[:, None], ep - sp + 1, 0)
    return sp, ep, size, ok


def _select_args(pts, curv, cnt, cfg: AloamConfig):
    """The selection kernel's inputs for rings pts (R', C, 3), curv (R', C),
    cnt (R',): (curv, bcum (R', C) int32 exclusive count of bad gaps,
    spep (R', 2*n_regions) f32 with ep = -1 for a disabled region), plus
    in_region (R', C) bool."""
    c = curv.shape[1]
    sp, ep, size, ok = _region_bounds(cnt, cfg.n_regions)
    idx = torch.arange(c, device=curv.device)[None, :]
    in_any = ok[:, None] & (idx >= 5) & (idx <= ep[:, -1:]) \
        & (idx < cnt[:, None])
    ep_eff = torch.where((size > 0) & ok[:, None], ep, -1)
    spep = torch.cat([sp, ep_eff], dim=1).to(torch.float32)
    # bad gap g sits between slots g and g+1; slot j and a pick at cand
    # share an NMS run iff bcum[j] == bcum[cand]
    d = pts[:, 1:] - pts[:, :-1]
    bad = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
           + d[..., 2] * d[..., 2]) > cfg.nms_gap_sq
    bcum = torch.nn.functional.pad(bad.to(torch.int32).cumsum(dim=1),
                                   (1, 0)).to(torch.int32)
    return (curv.contiguous(), bcum.contiguous(), spep.contiguous()), in_any


def _select_labels(pts, curv, cnt, cfg: AloamConfig):
    """Label grid for all rings: (label (R', C) int32 with cloudLabel
    semantics 2 sharp / 1 less-sharp / -1 flat / 0 other, in_region
    (R', C) bool)."""
    args, in_any = _select_args(pts, curv, cnt, cfg)
    label = select_op.select_rings(
        *args, cfg.n_regions, cfg.max_sharp, cfg.max_less_sharp,
        cfg.max_flat, cfg.nms_window, cfg.curvature_threshold)
    return label, in_any


def _dyn_rows(vals: torch.Tensor, starts: torch.Tensor, cap: int):
    """Per-row window: vals (R', N, K), starts (R',) -> rows
    [start, start + cap) of each, zero past the end (R', cap, K)."""
    n = vals.shape[1]
    padded = torch.nn.functional.pad(vals, (0, 0, 0, cap))
    src = starts.to(torch.int64).clamp_max(n)[:, None] \
        + torch.arange(cap, device=vals.device)
    return bgather(padded, src)


def extract_features_b(rc: RingCloud, curv: torch.Tensor,
                       cfg: AloamConfig) -> ScanFeatures:
    """C5 + C6 for B scans: rc leaves (B, R, C, ·), curv (B, R, C).

    Selection and the per-ring voxel downsample are row-parallel, so the
    stream axis folds into the ring axis. One stable sort per ring by
    class (sharp, less-sharp only, flat, rest) compacts the picks: every
    cloud is a head slice of its ring's sorted row, ring-grouped. Returns
    ScanFeatures with (B, cap, ·) leaves and per-stream overflow (B,)."""
    bsz, r, c = curv.shape
    xs = rc.xyz.reshape(bsz * r, c, 3)
    ins = rc.intensity.reshape(bsz * r, c)
    label, in_region = _select_labels(xs, curv.reshape(bsz * r, c),
                                      rc.cnt.reshape(bsz * r), cfg)

    def pc(out, m):
        return PointCloud(xyz=out[..., :3], intensity=out[..., 3], mask=m)

    cls = torch.where(label == 2, 0,
                      torch.where(label == 1, 1,
                                  torch.where(label == -1, 2, 3)))
    _, order = torch.sort(cls, dim=1, stable=True)
    sorted_f = bgather(torch.cat([xs, ins[..., None]], dim=-1), order)
    n2 = (label == 2).sum(dim=1)
    n1 = (label == 1).sum(dim=1)
    nm1 = (label == -1).sum(dim=1)

    def ring_heads(rows, count, cap_r, cap_total):
        """Per-ring head slices -> (B, cap_total) cloud."""
        m = torch.arange(cap_r, device=rows.device)[None, :] < count[:, None]
        out = torch.where(m[..., None], rows[:, :cap_r], 0.0)
        out = out.reshape(bsz, r * cap_r, 4)
        m = m.reshape(bsz, r * cap_r)
        pad = cap_total - r * cap_r
        if pad < 0:
            raise ValueError(f"ring_heads: {r} x {cap_r} > cap {cap_total}")
        if pad:
            out = torch.nn.functional.pad(out, (0, 0, 0, pad))
            m = torch.nn.functional.pad(m, (0, pad))
        return pc(out, m)

    sharp = ring_heads(sorted_f, n2, cfg.n_regions * cfg.max_sharp,
                       cfg.sharp_cap)
    less_sharp = ring_heads(sorted_f, n2 + n1,
                            cfg.n_regions * cfg.max_less_sharp,
                            cfg.less_sharp_cap)
    f_rows = _dyn_rows(sorted_f, n2 + n1, cfg.n_regions * cfg.max_flat)
    flat = ring_heads(f_rows, nm1, cfg.n_regions * cfg.max_flat,
                      cfg.flat_cap)

    # the voxel output is head-packed per ring, so the less-flat cloud is a
    # per-ring slice too; per-ring cap pressure is counted, never silent
    lf_xyz, lf_int, lf_mask, drops = voxel_downsample_rings(
        xs, ins, (label <= 0) & in_region, cfg.less_flat_leaf)
    lf_cap_r = min(c, cfg.less_flat_cap // r)
    n_lf_r = lf_mask.sum(dim=1)
    lf4 = torch.cat([lf_xyz[:, :lf_cap_r], lf_int[:, :lf_cap_r, None]],
                    dim=-1)
    less_flat = ring_heads(lf4, n_lf_r, lf_cap_r, cfg.less_flat_cap)
    lf_drops = (n_lf_r - lf_cap_r).clamp_min(0)

    # the full ring cloud stays slot-ordered with gaps masked
    full_mask = rc.slot_mask().reshape(bsz, r * c)
    full = pc(torch.cat([xs, ins[..., None]], dim=-1).reshape(bsz, r * c, 4),
              full_mask)

    # only less-flat can overflow (the pick counts per ring are bounded)
    overflow = (drops + lf_drops).reshape(bsz, r).sum(dim=1)
    return ScanFeatures(sharp=sharp, less_sharp=less_sharp, flat=flat,
                        less_flat=less_flat, full=full, overflow=overflow)
