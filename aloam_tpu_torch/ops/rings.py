"""The feature stage's per-ring clouds (kernel module).

Replaces no ``pallas_call``: the JAX package leaves this part of
``aloam_tpu/frontend/features.py:extract_features_b`` to XLA (a stable
sort by class, the head slices of the sorted rows, and the per-ring voxel
downsample). The CUDA kernel is ``csrc/rings.cu``: one block per ring row
stages the row in shared memory, places every pick with one block-wide
scan of the class counts, sorts the less-flat points by voxel key with a
radix sort in shared memory, averages each voxel, and writes each cloud
once, straight to its slots. The plain version beside it is the PyTorch
code the stage ran before: one stable sort by class, the gathers of the
sorted rows and ``frontend.voxel.voxel_downsample_rings``. The picks and
the full grid are copies, so the two agree bit for bit there; a voxel's
mean is its sum in double precision rounded once to f32 on both sides,
in another order, so the means agree within ``ops/kernels.py``'s bound.
"""

from __future__ import annotations

import torch

from aloam_tpu_torch.frontend import voxel as voxel_mod
from aloam_tpu_torch.ops import _build
from aloam_tpu_torch.ops import gather as gather_op

launches = 0  # kernel launches since the last reset

MAX_SLOTS = 4096            # slots a ring row (csrc/rings.cu: kMaxSlots)
SMEM_BYTES = 227 * 1024     # the shared memory a block may use
_HIST_BYTES = 256 * 16 * 2  # radix counters: 256 digits x 16 warps, u16


def smem_bytes(c: int) -> int:
    """Shared memory of one staged row, as ``csrc/rings.cu:smem_bytes``
    counts it: a 16-byte point, an 8-byte voxel key, two 2-byte
    permutation entries and a class byte a slot (C rounded up to 16),
    and the radix counters."""
    cp = -(-c // 16) * 16
    return 29 * cp + _HIST_BYTES


def region_bounds(cnt: torch.Tensor, n_regions: int):
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


def in_region(cnt: torch.Tensor, c: int, n_regions: int) -> torch.Tensor:
    """(R', C) bool: the slots inside some region window of their ring."""
    _, ep, _, ok = region_bounds(cnt, n_regions)
    idx = torch.arange(c, device=cnt.device)[None, :]
    return ok[:, None] & (idx >= 5) & (idx <= ep[:, -1:]) \
        & (idx < cnt[:, None])


def _check(xyz, intensity, label, cnt, streams, n_regions, ring_caps,
           caps) -> None:
    """Raise ValueError for inputs either version cannot take; the kernel's
    limits hold on every device, so a configuration that runs on the CPU
    runs on the card."""
    rows, c = label.shape
    if (tuple(xyz.shape) != (rows, c, 3)
            or tuple(intensity.shape) != (rows, c)
            or tuple(cnt.shape) != (rows,) or streams < 1
            or rows % streams or rows == 0):
        raise ValueError(f"ring_clouds: xyz {tuple(xyz.shape)}, intensity "
                         f"{tuple(intensity.shape)}, label {(rows, c)}, cnt "
                         f"{tuple(cnt.shape)}, {streams} streams")
    if c > MAX_SLOTS:
        raise ValueError(f"ring_clouds: a ring of {c} slots, past the "
                         f"kernel's {MAX_SLOTS}")
    if n_regions < 1:
        raise ValueError(f"ring_clouds: {n_regions} regions a ring")
    r = rows // streams
    for cap_r, cap in zip(ring_caps, caps, strict=True):
        if not 0 <= cap_r <= c or r * cap_r > cap:
            raise ValueError(f"ring_clouds: {r} rings x {cap_r} slots of "
                             f"{c} into a cloud of {cap}")


def _dyn_rows(vals: torch.Tensor, starts: torch.Tensor, cap: int):
    """Per-row window: vals (R', N, K), starts (R',) -> rows
    [start, start + cap) of each, zero past the end (R', cap, K)."""
    n = vals.shape[1]
    padded = torch.nn.functional.pad(vals, (0, 0, 0, cap))
    src = starts.to(torch.int64).clamp_max(n)[:, None] \
        + torch.arange(cap, device=vals.device)
    return gather_op.bgather(padded, src)


def ring_clouds_plain(xyz, intensity, label, cnt, streams: int,
                      n_regions: int, ring_caps: tuple, caps: tuple,
                      leaf: float):
    """Plain PyTorch version of :func:`ring_clouds`."""
    _check(xyz, intensity, label, cnt, streams, n_regions, ring_caps, caps)
    rows, c = label.shape
    r = rows // streams
    cap_s, cap_ls, cap_f, cap_lf = ring_caps
    pts = torch.cat([xyz, intensity[..., None]], dim=-1)
    # one stable sort per ring by class (sharp, less-sharp only, flat,
    # rest): every pick cloud is a head slice of its ring's sorted row
    cls = torch.where(label == 2, 0,
                      torch.where(label == 1, 1,
                                  torch.where(label == -1, 2, 3)))
    _, order = torch.sort(cls, dim=1, stable=True)
    sorted_f = gather_op.bgather(pts, order)
    n2 = (label == 2).sum(dim=1)
    n1 = (label == 1).sum(dim=1)
    nm1 = (label == -1).sum(dim=1)

    def ring_heads(vals, count, cap_r, cap_total):
        """Per-ring head slices -> (B, cap_total, 4) cloud and its mask."""
        m = torch.arange(cap_r, device=vals.device)[None, :] < count[:, None]
        out = torch.where(m[..., None], vals[:, :cap_r], 0.0)
        out = out.reshape(streams, r * cap_r, 4)
        m = m.reshape(streams, r * cap_r)
        pad = cap_total - r * cap_r
        if pad:
            out = torch.nn.functional.pad(out, (0, 0, 0, pad))
            m = torch.nn.functional.pad(m, (0, pad))
        return out, m

    sharp = ring_heads(sorted_f, n2, cap_s, caps[0])
    less_sharp = ring_heads(sorted_f, n2 + n1, cap_ls, caps[1])
    flat = ring_heads(_dyn_rows(sorted_f, n2 + n1, cap_f), nm1, cap_f,
                      caps[2])

    # the voxel output is head-packed per ring, so the less-flat cloud is a
    # per-ring slice too; per-ring cap pressure is counted, never silent
    lf_xyz, lf_int, lf_mask, drops = voxel_mod.voxel_downsample_rings(
        xyz, intensity, (label <= 0) & in_region(cnt, c, n_regions), leaf)
    n_lf_r = lf_mask.sum(dim=1)
    lf4 = torch.cat([lf_xyz[:, :cap_lf], lf_int[:, :cap_lf, None]], dim=-1)
    less_flat = ring_heads(lf4, n_lf_r, cap_lf, caps[3])
    lf_drops = (n_lf_r - cap_lf).clamp_min(0)

    # the full ring cloud stays slot-ordered with gaps masked
    full_mask = torch.arange(c, device=cnt.device) < cnt[:, None]
    return (*sharp, *less_sharp, *flat, *less_flat,
            pts.reshape(streams, r * c, 4), full_mask.reshape(streams, r * c),
            (drops + lf_drops).to(torch.int32))


def _points(xyz: torch.Tensor, intensity: torch.Tensor) -> torch.Tensor:
    """(R', C, 4) [x, y, z, intensity] rows of 16-byte points: the ring
    grid itself where xyz and intensity are views of one 4-wide grid (as
    registration leaves them), else a copy."""
    rows, c = intensity.shape
    if (xyz.stride() == (4 * c, 4, 1) and intensity.stride() == (4 * c, 4)
            and xyz.untyped_storage().data_ptr()
            == intensity.untyped_storage().data_ptr()
            and intensity.data_ptr() == xyz.data_ptr() + 12
            and xyz.data_ptr() % 16 == 0):
        return xyz.as_strided((rows, c, 4), (4 * c, 4, 1))
    return torch.cat([xyz, intensity[..., None]], dim=-1)


def ring_clouds(xyz: torch.Tensor, intensity: torch.Tensor,
                label: torch.Tensor, cnt: torch.Tensor, streams: int,
                n_regions: int, ring_caps: tuple, caps: tuple, leaf: float):
    """The feature stage's clouds of ``streams`` scans from their ring rows:
    xyz (R', C, 3) and intensity (R', C) f32, label (R', C) int32 (2 sharp,
    1 less-sharp, -1 flat, 0 other: ``ops/select``), cnt (R',) int32, the
    rows of stream b being b·R .. b·R + R - 1. ``ring_caps`` are the slots
    a ring gets in the sharp, less-sharp, flat and less-flat clouds,
    ``caps`` each cloud's capacity a stream; ``leaf`` the less-flat voxel
    size. Returns (sharp, sharp_mask, less_sharp, less_sharp_mask, flat,
    flat_mask, less_flat, less_flat_mask, full, full_mask, drops): each
    cloud (B, cap, 4) [x, y, z, intensity] f32 with its (B, cap) mask, its
    rings' slices in ring order, zero past each ring's count and past the
    rings; full (B, R·C, 4) the rows as they are, masked past cnt; drops
    (R',) int32 the less-flat voxels past a ring's slots. A ring's picks
    keep slot order, the sharp ones first in the less-sharp cloud; its
    less-flat points (label <= 0 inside its regions) become one mean per
    occupied voxel, in the voxel key's order. CPU tensors take the plain
    version; CUDA tensors launch the kernel (rows up to ``MAX_SLOTS``
    slots on either)."""
    _check(xyz, intensity, label, cnt, streams, n_regions, ring_caps, caps)
    args = (streams, n_regions, tuple(ring_caps), tuple(caps), leaf)
    if all(t.device.type == "cpu" for t in (xyz, intensity, label, cnt)):
        return ring_clouds_plain(xyz, intensity, label, cnt, *args)
    _build.require_cuda("ring_clouds", label, cnt,
                        dtypes=(torch.int32, torch.int32))
    if xyz.device != label.device or intensity.device != label.device \
            or xyz.dtype != torch.float32 \
            or intensity.dtype != torch.float32:
        raise ValueError(f"ring_clouds: expected f32 points on "
                         f"{label.device}, got {xyz.dtype} on {xyz.device} "
                         f"and {intensity.dtype} on {intensity.device}")
    rows, c = label.shape
    r = rows // streams
    dev = label.device
    pts = _points(xyz, intensity)
    # the kernel writes every element, padding included
    out = []
    for cap in caps:
        out += [torch.empty((streams, cap, 4), dtype=torch.float32,
                            device=dev),
                torch.empty((streams, cap), dtype=torch.bool, device=dev)]
    out += [torch.empty((streams, r * c, 4), dtype=torch.float32,
                        device=dev),
            torch.empty((streams, r * c), dtype=torch.bool, device=dev),
            torch.empty(rows, dtype=torch.int32, device=dev)]
    _build.launch("aloam_ring_clouds", dev, pts.data_ptr(),
                  label.data_ptr(), cnt.data_ptr(),
                  *(t.data_ptr() for t in out), rows, r, c, n_regions,
                  *ring_caps, *caps, float(1.0 / leaf))
    global launches
    launches += 1
    return tuple(out)
