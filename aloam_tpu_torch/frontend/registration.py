"""Scan registration: range filter, ring split, per-point time, curvature
(port of ``aloam_tpu/frontend/registration.py``, batched form).

Vectorized form of the per-point loops of scanRegistration.cpp:114-266:
the sequential ``halfPassed`` azimuth state machine becomes an exclusive
cumulative OR, ring bucketing one stable sort by ring plus a gather into a
(R, C) grid, and the 11-point curvature stencil a sum of neighbour
differences. Every tensor carries a leading stream axis B, but in the
single-stream API (``bucket_rings``, ``register_scan``): those take and
return the JAX package's unbatched leaves, through the batched functions
at B = 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.ops import gather as gather_op
from aloam_tpu_torch.types import RingCloud
from aloam_tpu_torch.utils.batch import add_stream_axis, drop_stream_axis

_TWO_PI = 2.0 * math.pi


def ring_ids(xyz: torch.Tensor, scan_lines: int):
    """Elevation-angle ring assignment (scanRegistration.cpp:166-205), with
    C ``int()`` truncation toward zero. Returns (ring int32, keep bool)."""
    x, y, z = xyz.unbind(-1)
    angle = torch.atan(z / torch.sqrt(x * x + y * y)) * (180.0 / math.pi)

    def trunc_i32(v):
        return torch.trunc(v).to(torch.int32)

    if scan_lines == 16:
        sid = trunc_i32((angle + 15.0) / 2.0 + 0.5)
        keep = (sid >= 0) & (sid <= scan_lines - 1)
    elif scan_lines == 32:
        sid = trunc_i32((angle + 92.0 / 3.0) * 3.0 / 4.0)
        keep = (sid >= 0) & (sid <= scan_lines - 1)
    elif scan_lines == 64:
        upper = trunc_i32((2.0 - angle) * 3.0 + 0.5)
        lower = scan_lines // 2 + trunc_i32((-8.83 - angle) * 2.0 + 0.5)
        sid = torch.where(angle >= -8.83, upper, lower)
        keep = ~((angle > 2) | (angle < -24.33) | (sid > 50) | (sid < 0))
    else:
        raise ValueError(f"unsupported scan_lines={scan_lines}")
    return sid, keep


def rel_times(xyz: torch.Tensor, valid: torch.Tensor, kept: torch.Tensor):
    """Azimuth-derived intra-scan relative time (scanRegistration.cpp:
    141-238), per stream. ``valid`` points define startOri/endOri through
    the first and last of them (:141-144); ``kept`` points (legal ring)
    drive the halfPassed flag, which flips once, after the first kept
    point past startOri + pi: an exclusive cumulative OR."""
    n = xyz.shape[1]
    ori = -torch.atan2(xyz[..., 1], xyz[..., 0])
    pos = torch.arange(n, device=xyz.device)
    # first / last valid point (0 and n-1 when a stream has none)
    first = torch.where(valid, pos, n).amin(dim=1, keepdim=True) % n
    last = torch.where(valid, pos, -1).amax(dim=1, keepdim=True)
    last = torch.where(last < 0, n - 1, last)
    start_ori = ori.gather(1, first)
    end_ori = ori.gather(1, last) + _TWO_PI
    span = end_ori - start_ori
    end_ori = torch.where(span > 3 * math.pi, end_ori - _TWO_PI,
                          torch.where(span < math.pi, end_ori + _TWO_PI,
                                      end_ori))

    # branch-false (first half) adjustment
    ori_f = torch.where(ori < start_ori - math.pi / 2, ori + _TWO_PI,
                        torch.where(ori > start_ori + 3 * math.pi / 2,
                                    ori - _TWO_PI, ori))
    trigger = (kept & (ori_f - start_ori > math.pi)).to(torch.int32)
    half_passed = (trigger.cumsum(dim=1) - trigger) >= 1     # exclusive

    # branch-true (second half) adjustment
    ori_t = ori + _TWO_PI
    ori_t = torch.where(ori_t < end_ori - 3 * math.pi / 2, ori_t + _TWO_PI,
                        torch.where(ori_t > end_ori + math.pi / 2,
                                    ori_t - _TWO_PI, ori_t))
    ori_out = torch.where(half_passed, ori_t, ori_f)
    return (ori_out - start_ori) / (end_ori - start_ori)


def bucket_rings_b(xyz: torch.Tensor, intensity: torch.Tensor,
                   ring: torch.Tensor, valid: torch.Tensor,
                   scan_lines: int, ring_cap: int):
    """Ring-major repack (scanRegistration.cpp:240-252): one stable sort by
    ring (arrival order kept within a ring), then slot (r, j) of the
    (R, C) grid reads sorted row start_r + j. Points past a ring's
    capacity are dropped and counted per stream in ``overflow`` (B,)."""
    bsz, n = ring.shape
    ring_v = torch.where(valid, ring, scan_lines)
    ring_s, order = torch.sort(ring_v, dim=1, stable=True)
    fused = gather_op.bgather(
        torch.cat([xyz, intensity[..., None]], dim=-1), order)

    rids = torch.arange(scan_lines, dtype=ring_s.dtype,
                        device=ring.device).repeat(bsz, 1)
    starts = torch.searchsorted(ring_s, rids)                       # (B, R)
    cnt = torch.searchsorted(ring_s, rids, right=True) - starts
    slot = torch.arange(ring_cap, device=ring.device)
    src = (starts[..., None] + slot).clamp_max(n - 1)               # (B,R,C)
    occupied = slot < cnt[..., None]
    grid = gather_op.bgather(fused, src.reshape(bsz, -1)).reshape(
        bsz, scan_lines, ring_cap, 4)
    grid = torch.where(occupied[..., None], grid, 0.0)
    cnt = cnt.clamp_max(ring_cap).to(torch.int32)
    overflow = valid.sum(dim=1) - cnt.sum(dim=1)
    return RingCloud(xyz=grid[..., :3], intensity=grid[..., 3],
                     cnt=cnt), overflow


def bucket_rings(xyz: torch.Tensor, intensity: torch.Tensor,
                 ring: torch.Tensor, valid: torch.Tensor,
                 scan_lines: int, ring_cap: int):
    """:func:`bucket_rings_b` of one scan: xyz (N, 3), intensity, ring and
    valid (N,). Returns (RingCloud with (R, C) leaves, overflow)."""
    rc, overflow = bucket_rings_b(*add_stream_axis(
        (xyz, intensity, ring, valid)), scan_lines, ring_cap)
    return drop_stream_axis(rc), overflow[0]


def curvature(pts: torch.Tensor, edge_margin: int = 5) -> torch.Tensor:
    """11-point curvature stencil (scanRegistration.cpp:256-266) along the
    slot axis of (..., C, 3) rings: c_i = ‖Σ_{k=-5..5, k≠0} (p_{i+k} −
    p_i)‖², as a sum of neighbour differences (identical in exact math to
    the reference's raw-coordinate sum, better conditioned in f32). Only
    slots margin ≤ j ≤ cnt−margin−2 are meaningful; the selection windows
    mask the rest."""
    c = pts.shape[-2]
    pad = F.pad(pts, (0, 0, edge_margin, edge_margin))
    acc = -2.0 * edge_margin * pts
    for k in range(2 * edge_margin + 1):
        if k != edge_margin:
            acc = acc + pad[..., k:k + c, :]
    return acc[..., 0] * acc[..., 0] + acc[..., 1] * acc[..., 1] \
        + acc[..., 2] * acc[..., 2]


def register_scan_b(xyz: torch.Tensor, mask: torch.Tensor,
                    cfg: AloamConfig):
    """Filter + ring split + time + bucketing + curvature for B scans:
    xyz (B, n_raw, 3) f32 in firing order, mask (B, n_raw) bool. Returns
    (RingCloud with (B, R, C) leaves, curvature (B, R, C), overflow (B,))."""
    finite = torch.isfinite(xyz).all(dim=-1)
    d2 = xyz[..., 0] * xyz[..., 0] + xyz[..., 1] * xyz[..., 1] \
        + xyz[..., 2] * xyz[..., 2]
    valid = mask & finite & (d2 >= cfg.minimum_range ** 2)

    ring, keep = ring_ids(xyz, cfg.scan_lines)
    rel = rel_times(xyz, valid, valid & keep)
    intensity = ring.to(xyz.dtype) + cfg.scan_period * rel

    rc, overflow = bucket_rings_b(xyz, intensity, ring, valid & keep,
                                  cfg.scan_lines, cfg.ring_cap)
    return rc, curvature(rc.xyz, cfg.edge_margin), overflow


def register_scan(xyz: torch.Tensor, mask: torch.Tensor, cfg: AloamConfig):
    """:func:`register_scan_b` of one scan: xyz (n_raw, 3), mask (n_raw,).
    Returns (RingCloud with (R, C) leaves, curvature (R, C), overflow)."""
    rc, curv, overflow = register_scan_b(xyz[None], mask[None], cfg)
    return drop_stream_axis(rc), curv[0], overflow[0]
