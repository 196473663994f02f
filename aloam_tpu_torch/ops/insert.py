"""Map-insert merge and append over bucket rows (kernel module).

Port of ``aloam_tpu/ops/pallas_insert.py:merge_tiles``. The CUDA kernel is
``csrc/insert.cu``: one warp per used bucket row reads the row where it
lives in the map table, merges and appends the row's points, and writes
it back in place; the TPU kernel's tiles, gathered from the table and
scattered back around it, have no counterpart on the card. The plain
version, :func:`merge_rows_plain`, does just that around
:func:`merge_tiles_plain`, the JAX package's dense form
(``gridmap._merge_dense_xla``): one-hot (B, C, P, Bk) match masks, a
stable argsort of the eviction priority indexed by append rank, and index
gathers and scatters in place of the one-hot matmuls (the same values,
every slot written at most once).

Per bucket row, for points p < min(cnt, P) in order:

* merge: a point whose voxel id equals an occupied slot's merges into it;
  the last matching point wins and the slot becomes the midpoint
  0.5 * (slot + point);
* append: a point with no match takes the free slot of least eviction
  priority (empty 0 < out-of-window 1e3 + far < in-window 1e6 + far, far =
  4000 - Chebyshev cell distance to the pose), ties to the lowest slot;
* appended slots get their cell and voxel id recomputed from the point
  (floor(x * (1 / cell_size)), floor(x * (1 / leaf))); merged slots keep
  theirs.

The two versions agree bit for bit.
"""

from __future__ import annotations

import torch

from aloam_tpu_torch.ops import _build
from aloam_tpu_torch.ops import gather as gather_op

launches = 0  # kernel launches since the last reset

_EMPTY = 32767


def merge_tiles_plain(pts_tile, s_int, cell_tile, vox_tile, ppx, ppy, ppz,
                      ppi, pvox, cnt, center, window, cell_size: float,
                      leaf: float):
    """Merge and append each bucket tile's points into its slots: the
    twin of the TPU kernel, on tiles gathered from the table.

    pts_tile (B, C, 3·Bk) f32 planar [x|y|z]; s_int (B, C, Bk) f32;
    cell_tile (B, C, 3·Bk) i32; vox_tile (B, C, Bk) i32; ppx, ppy, ppz, ppi
    (B, C, P) f32 and pvox (B, C, P) i32 the points; cnt (B, C) i32;
    center (B, 3) i32 pose cells; window (3,) i32. Returns the updated
    (B, C, Bk) planes (x, y, z, intensity, cx, cy, cz, vox) and the
    per-bucket (merged, appended, evicted) counts (B, C) int32."""
    from aloam_tpu_torch.ops.gridmap import _mix
    bsz, cap_c, cap_p = ppx.shape
    bk = vox_tile.shape[-1]
    dev = ppx.device
    s_p = pts_tile.view(bsz, cap_c, 3, bk)
    s_px, s_py, s_pz = s_p[:, :, 0], s_p[:, :, 1], s_p[:, :, 2]
    s_c = cell_tile.view(bsz, cap_c, 3, bk)
    s_cx, s_cy, s_cz = s_c[:, :, 0], s_c[:, :, 1], s_c[:, :, 2]
    s_vox = vox_tile
    occ = s_cx != _EMPTY

    # --- merge: one-hot match masks, the last matching point wins ---------
    iota_p = torch.arange(cap_p, device=dev)
    pvalid = iota_p < cnt.clamp_max(cap_p)[..., None]       # (B, C, P)
    match = (pvalid[..., None] & occ[:, :, None, :]
             & (pvox[..., None] == s_vox[:, :, None, :]))   # (B, C, P, Bk)
    has_match = match.any(dim=-1)                           # (B, C, P)
    m_any = match.any(dim=2)                                # (B, C, Bk)
    best = torch.where(match, iota_p[:, None], -1).amax(dim=2).clamp_min(0)

    def merged(s, vals):
        return torch.where(m_any, 0.5 * (s + vals.gather(2, best)), s)

    s_px, s_py, s_pz, o_int = (merged(s, v) for s, v in (
        (s_px, ppx), (s_py, ppy), (s_pz, ppz), (s_int, ppi)))

    # --- appends: slots in ascending eviction priority --------------------
    app = pvalid & ~has_match
    arank = app.to(torch.int32).cumsum(dim=2, dtype=torch.int32) - 1
    adx = (s_cx - center[:, None, 0, None]).abs()
    ady = (s_cy - center[:, None, 1, None]).abs()
    adz = (s_cz - center[:, None, 2, None]).abs()
    dist = torch.maximum(adx, torch.maximum(ady, adz))
    in_win = (adx <= window[0]) & (ady <= window[1]) & (adz <= window[2])
    far = 4000.0 - dist.to(torch.float32).clamp_max(4000.0)
    prio = torch.where(occ, torch.where(in_win, 1e6 + far, 1e3 + far), 0.0)
    prio_sorted, slot_order = torch.sort(prio, dim=-1, stable=True)

    can_app = app & (arank < bk)
    rk = arank.clamp(0, bk - 1).to(torch.int64)
    slot_p = slot_order.gather(2, rk)                       # (B, C, P)
    chosen_prio = prio_sorted.gather(2, rk)
    # each appended point owns its slot; the rest land on spare column bk
    tgt = torch.where(can_app, slot_p, bk)

    def written(vals):
        buf = torch.zeros((bsz, cap_c, bk + 1), dtype=vals.dtype, device=dev)
        return buf.scatter_(2, tgt, vals)[..., :bk]

    wr_any = written(can_app)
    s_px, s_py, s_pz, o_int = (torch.where(wr_any, written(v), s) for s, v in (
        (s_px, ppx), (s_py, ppy), (s_pz, ppz), (o_int, ppi)))

    # an appended slot's cell and voxel id follow from its point (values
    # of other slots, including out-of-range floors of the 1e9 sentinel,
    # are discarded by the where)
    inv_cell, inv_leaf = 1.0 / cell_size, 1.0 / leaf
    a_c = [torch.floor(s * inv_cell).to(torch.int32)
           for s in (s_px, s_py, s_pz)]
    a_vox = _mix(*(torch.floor(s * inv_leaf).to(torch.int32)
                   for s in (s_px, s_py, s_pz)))
    o_cx, o_cy, o_cz = (torch.where(wr_any, a, s)
                        for a, s in zip(a_c, (s_cx, s_cy, s_cz)))
    o_vox = torch.where(wr_any, a_vox, s_vox)

    i32 = torch.int32
    return (s_px, s_py, s_pz, o_int, o_cx, o_cy, o_cz, o_vox,
            (has_match & pvalid).sum(dim=2, dtype=i32),
            can_app.sum(dim=2, dtype=i32),
            (can_app & (chosen_prio >= 1e3)).sum(dim=2, dtype=i32))


def _pack_aux(inten, cx, cy, cz, vox) -> torch.Tensor:
    """(..., Bk) planes -> (..., 5·Bk) planar aux rows."""
    planes = torch.stack([inten.contiguous().view(torch.int32), cx, cy, cz,
                          vox], dim=-2)
    return planes.reshape(planes.shape[:-2] + (5 * planes.shape[-1],))


def merge_rows_plain(pts_table, aux_table, slot_h, cnt, ppx, ppy, ppz, ppi,
                     pvox, center, window, cell_size: float, leaf: float):
    """Plain PyTorch version of :func:`merge_rows`: gather the rows' tiles,
    :func:`merge_tiles_plain`, write the used rows back. An unused row
    (cnt 0) is redirected to its stream's row 0 with row 0's values, so
    every duplicate index writes identical bytes and the copy order does
    not matter (the used rows are a prefix of each stream's rows)."""
    bsz, cap_c = cnt.shape
    table_size = pts_table.shape[1]
    bk = aux_table.shape[-1] // 5
    pts_tile = gather_op.bgather(pts_table, slot_h)          # (B, C, 3Bk)
    av = gather_op.bgather(aux_table, slot_h).view(bsz, cap_c, 5, bk)
    s_int = av[:, :, 0].contiguous().view(torch.float32)
    cell_tile = av[:, :, 1:4].reshape(bsz, cap_c, 3 * bk)
    vox_tile = av[:, :, 4].contiguous()
    (s_px, s_py, s_pz, s_int, s_cx, s_cy, s_cz, s_vox,
     merged, appended, evicted) = merge_tiles_plain(
        pts_tile, s_int, cell_tile, vox_tile, ppx, ppy, ppz, ppi, pvox, cnt,
        center, window, cell_size, leaf)

    used = cnt > 0
    new_pts = torch.stack([s_px, s_py, s_pz], dim=2).view(bsz, cap_c, -1)
    new_aux = _pack_aux(s_int, s_cx, s_cy, s_cz, s_vox)
    dest = torch.where(used, slot_h, slot_h[:, :1]) \
        + torch.arange(bsz, device=cnt.device)[:, None] * table_size
    new_pts = torch.where(used[..., None], new_pts, new_pts[:, :1])
    new_aux = torch.where(used[..., None], new_aux, new_aux[:, :1])
    pts_table.view(bsz * table_size, -1).index_copy_(
        0, dest.reshape(-1), new_pts.reshape(bsz * cap_c, -1))
    aux_table.view(bsz * table_size, -1).index_copy_(
        0, dest.reshape(-1), new_aux.reshape(bsz * cap_c, -1))
    return merged, appended, evicted


def merge_rows(pts_table: torch.Tensor, aux_table: torch.Tensor,
               slot_h: torch.Tensor, cnt: torch.Tensor, ppx: torch.Tensor,
               ppy: torch.Tensor, ppz: torch.Tensor, ppi: torch.Tensor,
               pvox: torch.Tensor, center: torch.Tensor,
               window: torch.Tensor, cell_size: float, leaf: float):
    """Merge and append each bucket row's points into its slots, in place
    in the map table.

    pts_table (B, H, 3·Bk) f32 and aux_table (B, H, 5·Bk) i32, a GridMap's
    planes (updated in place); slot_h (B, C) i32 each row's bucket; cnt
    (B, C) i32 its points, a row with cnt 0 unused; ppx, ppy, ppz, ppi
    (B, C, P) f32 and pvox (B, C, P) i32 the points; center (B, 3) i32
    pose cells; window (3,) i32. The used rows of a stream are a prefix of
    its rows and name distinct buckets (as ``gridmap._insert_sorted``
    builds them). Returns the per-row (merged, appended, evicted) counts
    (B, C) int32. CPU tensors take the plain version; CUDA tensors launch
    the kernel (Bk a multiple of 4 up to 128, P <= 128)."""
    args = (pts_table, aux_table, slot_h, cnt, ppx, ppy, ppz, ppi, pvox,
            center, window)
    if all(t.device.type == "cpu" for t in args):
        return merge_rows_plain(*args, cell_size, leaf)
    f32, i32 = torch.float32, torch.int32
    _build.require_cuda("merge_rows", *args,
                        dtypes=(f32, i32, i32, i32, f32, f32, f32, f32, i32,
                                i32, i32))
    bsz, h_rows = pts_table.shape[:2]
    cap_c, cap_p = ppx.shape[1:]
    bk = aux_table.shape[-1] // 5
    shapes_ok = (
        tuple(pts_table.shape) == (bsz, h_rows, 3 * bk)
        and tuple(aux_table.shape) == (bsz, h_rows, 5 * bk)
        and tuple(slot_h.shape) == tuple(cnt.shape) == (bsz, cap_c)
        and all(tuple(t.shape) == (bsz, cap_c, cap_p)
                for t in (ppx, ppy, ppz, ppi, pvox))
        and tuple(center.shape) == (bsz, 3) and tuple(window.shape) == (3,)
        and 0 < bk <= 128 and bk % 4 == 0 and 0 < cap_p <= 128
        and pts_table.data_ptr() % 16 == 0 and aux_table.data_ptr() % 16 == 0)
    if not shapes_ok:
        raise ValueError(f"merge_rows: shapes {[tuple(a.shape) for a in args]}"
                         f" (Bk a multiple of 4 up to 128, P <= 128, tables "
                         f"16-byte aligned)")
    stats = torch.empty((3, bsz, cap_c), dtype=i32, device=ppx.device)
    _build.launch("aloam_merge_rows", ppx.device,
                  *(t.data_ptr() for t in args), stats.data_ptr(),
                  bsz * cap_c, h_rows, cap_c, bk, cap_p,
                  float(1.0 / cell_size), float(1.0 / leaf))
    global launches
    launches += 1
    return stats[0], stats[1], stats[2]
