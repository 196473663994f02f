"""Odometry correspondence search (kernel module).

Port of ``aloam_tpu/ops/pallas_odom.py:window_mins``. The CUDA kernel is
``csrc/odom_window.cu`` (one thread per query, the planar reference
streamed through shared memory). The plain version beside it is the
chunked scan of ``aloam_tpu/neighbors.odom_window_mins_b``: per reference
chunk one (B, Q, chunk) distance block, a first-minimum, and a strict-<
merge into the running minimum.

Both compute d2 = ((qx-rx)^2 + (qy-ry)^2) + (qz-rz)^2 directly, one
rounded operation at a time in the same order, so they agree bit for bit;
the JAX package's ``q² − 2q·r + r²`` expansion rounds differently, which
only near-ties can see.
"""

from __future__ import annotations

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


def window_mins_plain(sel, ref_planar, nearby: float, want_same: bool,
                      chunk: int = 2048):
    """Plain PyTorch version of :func:`window_mins`."""
    bsz, q_n, _ = sel.shape
    m = ref_planar.shape[2]
    q = [sel[..., k:k + 1] for k in range(3)]              # (B, Q, 1)

    def d2_of(c0):
        r = ref_planar[:, :, None, c0:c0 + chunk]          # (B, 4, 1, ch)
        dx, dy, dz = q[0] - r[:, 0], q[1] - r[:, 1], q[2] - r[:, 2]
        return dx * dx + dy * dy + dz * dz

    def init():
        return (torch.full((bsz, q_n), _INF, device=sel.device),
                torch.zeros((bsz, q_n), dtype=torch.int64, device=sel.device))

    nn = init()
    for c0 in range(0, m, chunk):
        nn = _merge(nn, _first_min(d2_of(c0), c0))
    ring = ref_planar[:, 3]                                # (B, M)
    br = ring.gather(1, nn[1])[..., None]                  # (B, Q, 1)

    diff, same = init(), init()
    for c0 in range(0, m, chunk):
        d2 = d2_of(c0)
        adiff = (ring[:, None, c0:c0 + chunk] - br).abs()
        in_diff = (adiff >= 1.0) & (adiff <= nearby)
        diff = _merge(diff, _first_min(torch.where(in_diff, d2, _INF), c0))
        if want_same:
            gidx = torch.arange(c0, c0 + d2.shape[-1], device=sel.device)
            in_same = (adiff < 0.5) & (gidx != nn[1][..., None])
            same = _merge(same, _first_min(torch.where(in_same, d2, _INF),
                                           c0))
    return tuple(t.to(torch.int32) if t.dtype == torch.int64 else t
                 for t in (*nn, *diff, *same))


def window_mins(sel: torch.Tensor, ref_planar: torch.Tensor, nearby: float,
                want_same: bool):
    """sel (B, Q, 3) f32 queries; ref_planar (B, 4, M) f32 planar
    [x | y | z | ring], invalid points poisoned at 1e9 (coordinates and
    ring); both recentred by the caller.

    Returns (d2_nn, idx_nn, d2_diff, idx_diff, d2_same, idx_same), each
    (B, Q); indices int32, d2 +inf where a window had no point (the same
    outputs are +inf / 0 unless want_same). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if sel.device.type == "cpu" and ref_planar.device.type == "cpu":
        return window_mins_plain(sel, ref_planar, nearby, want_same)
    _build.require_cuda("window_mins", sel, ref_planar,
                        dtypes=(torch.float32, torch.float32))
    bsz, q_n, three = sel.shape
    if three != 3 or ref_planar.shape[:2] != (bsz, 4):
        raise ValueError(f"window_mins: sel {tuple(sel.shape)}, ref "
                         f"{tuple(ref_planar.shape)}")
    m = ref_planar.shape[2]
    out_d = torch.empty((3, bsz, q_n), dtype=torch.float32, device=sel.device)
    out_i = torch.empty((3, bsz, q_n), dtype=torch.int32, device=sel.device)
    _build.launch("aloam_odom_window", sel.device, sel.data_ptr(),
                  ref_planar.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                  bsz, q_n, m, float(nearby), int(bool(want_same)))
    global launches
    launches += 1
    return (out_d[0], out_i[0], out_d[1], out_i[1], out_d[2], out_i[2])
