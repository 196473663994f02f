"""Feature selection and the five frontend clouds (port of
``aloam_tpu/frontend/features.py``, batched form).

Re-design of scanRegistration.cpp:277-408. The reference sorts each
(ring, region) window by curvature and walks it, picking unsuppressed
candidates and NMS-marking ±5 ring neighbours per pick (gap-stopped at
>0.05 m², :319-342). Walking the sorted order while skipping suppressed
points is exactly repeated selection of the extremum of the still-eligible
curvature, so the walk needs no sort: each pick is one masked extremum
(ops/select.py). Ties go to the lowest index; the 4th flat pick is labelled
but marks nothing (:358-362). ``extract_features`` is the single-stream
API: :func:`extract_features_b` at B = 1, as in the JAX package.
"""

from __future__ import annotations

import torch

from aloam_tpu_torch import spans
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.ops import rings as rings_op
from aloam_tpu_torch.ops import select as select_op
from aloam_tpu_torch.types import PointCloud, RingCloud, ScanFeatures
from aloam_tpu_torch.utils.batch import add_stream_axis, drop_stream_axis


def _select_args(pts, curv, cnt, cfg: AloamConfig):
    """The selection kernel's inputs for rings pts (R', C, 3), curv (R', C),
    cnt (R',): curv, bcum (R', C) int32 exclusive count of bad gaps, and
    spep (R', 2*n_regions) f32 with ep = -1 for a disabled region."""
    sp, ep, size, ok = rings_op.region_bounds(cnt, cfg.n_regions)
    ep_eff = torch.where((size > 0) & ok[:, None], ep, -1)
    spep = torch.cat([sp, ep_eff], dim=1).to(torch.float32)
    # bad gap g sits between slots g and g+1; slot j and a pick at cand
    # share an NMS run iff bcum[j] == bcum[cand]
    d = pts[:, 1:] - pts[:, :-1]
    bad = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
           + d[..., 2] * d[..., 2]) > cfg.nms_gap_sq
    bcum = torch.nn.functional.pad(bad.to(torch.int32).cumsum(dim=1),
                                   (1, 0)).to(torch.int32)
    return curv.contiguous(), bcum.contiguous(), spep.contiguous()


def _select_labels(pts, curv, cnt, cfg: AloamConfig) -> torch.Tensor:
    """Label grid for all rings: (R', C) int32 with cloudLabel semantics 2
    sharp / 1 less-sharp / -1 flat / 0 other."""
    return select_op.select_rings(
        *_select_args(pts, curv, cnt, cfg), cfg.n_regions, cfg.max_sharp,
        cfg.max_less_sharp, cfg.max_flat, cfg.nms_window,
        cfg.curvature_threshold)


def extract_features_b(rc: RingCloud, curv: torch.Tensor,
                       cfg: AloamConfig) -> ScanFeatures:
    """C5 + C6 for B scans: rc leaves (B, R, C, ·), curv (B, R, C).

    Selection and the per-ring clouds are row-parallel, so the stream axis
    folds into the ring axis: the labels of the selection walk, then one
    ``ops/rings.ring_clouds`` call, which puts each ring's picks at the
    head of its slice of their cloud, downsamples its less-flat points
    and copies the grid into ``full``. Returns ScanFeatures with (B, cap,
    ·) leaves and per-stream overflow (B,)."""
    bsz, r, c = curv.shape
    xs = rc.xyz.reshape(bsz * r, c, 3)
    ins = rc.intensity.reshape(bsz * r, c)
    cnt = rc.cnt.reshape(bsz * r).to(torch.int32)
    with spans.stage("features.select"):
        label = _select_labels(xs, curv.reshape(bsz * r, c), cnt, cfg)
    ring_caps = (cfg.n_regions * cfg.max_sharp,
                 cfg.n_regions * cfg.max_less_sharp,
                 cfg.n_regions * cfg.max_flat,
                 min(c, cfg.less_flat_cap // r))
    caps = (cfg.sharp_cap, cfg.less_sharp_cap, cfg.flat_cap,
            cfg.less_flat_cap)
    with spans.stage("features.rings"):
        out = rings_op.ring_clouds(xs, ins, label, cnt, bsz, cfg.n_regions,
                                   ring_caps, caps, cfg.less_flat_leaf)
    sharp, less_sharp, flat, less_flat, full = (
        PointCloud(xyz=out[k][..., :3], intensity=out[k][..., 3],
                   mask=out[k + 1]) for k in range(0, 10, 2))
    # only less-flat can overflow (the pick counts per ring are bounded)
    overflow = out[10].reshape(bsz, r).sum(dim=1)
    return ScanFeatures(sharp=sharp, less_sharp=less_sharp, flat=flat,
                        less_flat=less_flat, full=full, overflow=overflow)


def extract_features(rc: RingCloud, curv: torch.Tensor,
                     cfg: AloamConfig) -> ScanFeatures:
    """:func:`extract_features_b` of one scan: rc leaves (R, C, ·), curv
    (R, C). Returns ScanFeatures with (cap, ·) leaves and a scalar
    overflow."""
    return drop_stream_axis(extract_features_b(add_stream_axis(rc),
                                               curv[None], cfg))
