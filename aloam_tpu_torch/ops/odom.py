"""Odometry correspondence search (kernel module).

Port of ``aloam_tpu/ops/pallas_odom.py:window_mins``. The CUDA kernel is
``csrc/odom_window.cu``: pass 1 splits the reference across blocks as well
as the queries and writes per-split (d2, idx) partials to scratch; pass 2
merges them and scans each query's ring window with a group of lanes.
:func:`launch_plan` picks the split count and the group size from the
shapes and the card's SM count. The plain version beside it is the chunked
scan of ``aloam_tpu/neighbors.odom_window_mins_b``: per reference chunk one
(B, Q, chunk) distance block, a first-minimum, and a strict-< merge into
the running minimum.

``ring_seg > 0`` declares the reference ring-segmented (ring r's points
live in rows [r·ring_seg, (r+1)·ring_seg), the frontend's ``ring_heads``
layout); both versions then skip the rows no ring window can reach, and
the outputs are the same as with ``ring_seg = 0``.

Both compute d2 = ((qx-rx)^2 + (qy-ry)^2) + (qz-rz)^2 directly, one
rounded operation at a time in the same order, so they agree bit for bit;
the JAX package's ``q² − 2q·r + r²`` expansion rounds differently, which
only near-ties can see.
"""

from __future__ import annotations

import math

import torch

from aloam_tpu_torch.ops import _build

launches = 0  # kernel launches since the last reset

_INF = float("inf")


def _first_min(d2: torch.Tensor, offset: int):
    """(min, lowest index of the min) along the last axis."""
    loc = d2.amin(dim=-1)
    iota = torch.arange(d2.shape[-1], device=d2.device)
    at = torch.where(d2 == loc[..., None], iota, d2.shape[-1]).amin(dim=-1)
    return loc, at + offset


def _merge(best, cand):
    better = cand[0] < best[0]
    return (torch.where(better, cand[0], best[0]),
            torch.where(better, cand[1], best[1]))


def _window_rows(br, m: int, nearby: float, ring_seg: int):
    """Rows [lo, hi) that hold every ring window of the queries whose
    nearest neighbour lies on rings ``br`` (B, Q, 1), or all M when
    ``ring_seg`` is 0 or some br is not a real ring (an all-poisoned
    reference gives br = 1e9)."""
    if ring_seg <= 0:
        return 0, m
    real = (br >= 0) & (br < m // ring_seg) & (br == br.floor())
    if not bool(real.all()):
        return 0, m
    nb = math.floor(nearby)
    return (max(0, (int(br.min()) - nb) * ring_seg),
            min(m, (int(br.max()) + nb + 1) * ring_seg))


def window_mins_plain(sel, ref_planar, nearby: float, want_same: bool,
                      ring_seg: int = 0, chunk: int = 2048):
    """Plain PyTorch version of :func:`window_mins`."""
    bsz, q_n, _ = sel.shape
    m = ref_planar.shape[2]
    q = [sel[..., k:k + 1] for k in range(3)]              # (B, Q, 1)

    def d2_of(c0, c1):
        r = ref_planar[:, :, None, c0:c1]                  # (B, 4, 1, ch)
        dx, dy, dz = q[0] - r[:, 0], q[1] - r[:, 1], q[2] - r[:, 2]
        return dx * dx + dy * dy + dz * dz

    def init():
        return (torch.full((bsz, q_n), _INF, device=sel.device),
                torch.zeros((bsz, q_n), dtype=torch.int64, device=sel.device))

    nn = init()
    for c0 in range(0, m, chunk):
        nn = _merge(nn, _first_min(d2_of(c0, c0 + chunk), c0))
    ring = ref_planar[:, 3]                                # (B, M)
    br = ring.gather(1, nn[1])[..., None]                  # (B, Q, 1)

    diff, same = init(), init()
    lo, hi = _window_rows(br, m, nearby, ring_seg)
    for c0 in range(lo, hi, chunk):
        c1 = min(c0 + chunk, hi)
        d2 = d2_of(c0, c1)
        adiff = (ring[:, None, c0:c1] - br).abs()
        in_diff = (adiff >= 1.0) & (adiff <= nearby)
        diff = _merge(diff, _first_min(torch.where(in_diff, d2, _INF), c0))
        if want_same:
            gidx = torch.arange(c0, c1, device=sel.device)
            in_same = (adiff < 0.5) & (gidx != nn[1][..., None])
            same = _merge(same, _first_min(torch.where(in_same, d2, _INF),
                                           c0))
    return tuple(t.to(torch.int32) if t.dtype == torch.int64 else t
                 for t in (*nn, *diff, *same))


_THREADS1 = 128    # pass-1 threads per block (csrc/odom_window.cu)
_MIN_SPLIT = 128   # fewest reference rows a pass-1 split scans


def launch_plan(bsz: int, q_n: int, m: int, n_sm: int):
    """(qpt, splits, group) of a launch: queries per pass-1 thread (4,
    or 2 where the last tile of 4 would be mostly empty), reference splits
    (enough pass-1 blocks for about four per SM, each split at least
    ``_MIN_SPLIT`` rows, no split empty) and lanes per pass-2 query (32,
    halved while the lanes would exceed 2048 per SM, down to 8)."""
    qpt = 4 if -(-q_n // _THREADS1) % 4 == 0 else 2
    tiles = -(-q_n // (_THREADS1 * qpt))
    splits = max(1, min(-(-4 * n_sm // (tiles * bsz)), -(-m // _MIN_SPLIT)))
    splits = -(-m // -(-m // splits))
    group = 32
    while group > 8 and bsz * q_n * group > 2048 * n_sm:
        group //= 2
    return qpt, splits, group


def window_mins(sel: torch.Tensor, ref_planar: torch.Tensor, nearby: float,
                want_same: bool, ring_seg: int = 0):
    """sel (B, Q, 3) f32 queries; ref_planar (B, 4, M) f32 planar
    [x | y | z | ring], invalid points poisoned at 1e9 (coordinates and
    ring); both recentred by the caller. ``ring_seg`` > 0 declares the
    reference ring-segmented (module docstring).

    Returns (d2_nn, idx_nn, d2_diff, idx_diff, d2_same, idx_same), each
    (B, Q); indices int32, d2 +inf where a window had no point (the same
    outputs are +inf / 0 unless want_same). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if sel.device.type == "cpu" and ref_planar.device.type == "cpu":
        return window_mins_plain(sel, ref_planar, nearby, want_same,
                                 ring_seg)
    _build.require_cuda("window_mins", sel, ref_planar,
                        dtypes=(torch.float32, torch.float32))
    bsz, q_n, three = sel.shape
    if three != 3 or ref_planar.shape[:2] != (bsz, 4) \
            or ref_planar.shape[2] < 1:
        raise ValueError(f"window_mins: sel {tuple(sel.shape)}, ref "
                         f"{tuple(ref_planar.shape)}")
    m = ref_planar.shape[2]
    qpt, splits, group = launch_plan(bsz, q_n, m,
                                     _build.sm_count(sel.device))
    # one scratch buffer: the interleaved reference (B, M, 4) f32, then
    # the splits' partials (splits, B, Q) f32 d2 and int32 idx
    part = splits * bsz * q_n
    scratch = torch.empty(bsz * m * 4 + 2 * part, dtype=torch.float32,
                          device=sel.device)
    ref4 = scratch.data_ptr()
    part_d = ref4 + bsz * m * 16
    out_d = torch.empty((3, bsz, q_n), dtype=torch.float32, device=sel.device)
    out_i = torch.empty((3, bsz, q_n), dtype=torch.int32, device=sel.device)
    _build.launch("aloam_odom_window", sel.device, sel.data_ptr(),
                  ref_planar.data_ptr(), ref4, part_d, part_d + part * 4,
                  out_d.data_ptr(), out_i.data_ptr(), bsz, q_n, m,
                  float(nearby), int(bool(want_same)), int(ring_seg), qpt,
                  splits, group)
    global launches
    launches += 1
    return (out_d[0], out_i[0], out_d[1], out_i[1], out_d[2], out_i[2])
