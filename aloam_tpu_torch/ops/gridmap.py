"""Persistent spatial-hash map grid (port of ``aloam_tpu/ops/gridmap.py``).

The reference keeps the world map as 21×21×11 cubes of PCL clouds that it
re-gathers, KD-trees, appends to and re-voxelizes every frame
(laserMapping.cpp:74-108, 531-559, 736-801). Here, as in the JAX package,
the map is one persistent hash table of 2 m cells per feature class whose
entries are voxel centroids, query-ready at all times:

* insert merges a point into the entry of its voxel (the midpoint: the
  iterated centroid of the reference's re-voxelization) or appends it;
* entries outside the rolling window (21×21×11×50 m around the pose) are
  cleared at the top of each mapping step, and bucket overflow evicts
  empty, then out-of-window, then in-window slots, farthest first;
* a gated 5-NN query reads the 2×2×2 block of cells around it.

Layout, unchanged from the JAX package so states compare bit for bit:
``pts (B, H, 3·Bk)`` f32 bucket-planar [x0..|y0..|z0..] and ``aux (B, H,
5·Bk)`` i32 planar [intensity bits | cx | cy | cz | voxel id].

The port updates the tables in place (``evict_and_count``'s clear,
``ops/evict``, and the insert's merge, ``ops/insert.merge_rows``): a state
passed to the mapping step is consumed.

A table may be partitioned over its bucket axis (:class:`TableShard`): a
rank then holds rows [index·H/count, (index+1)·H/count) of every stream's
H-row table, and the functions that take a ``shard`` hash with the whole
table's size, touch only the rows this rank owns, and sum their counts
over the group. Every other input (queries, points, poses) is the same on
every rank of the group.

``empty(batch, table_size, bucket_cap, device)`` keeps the port's batched
signature (the JAX package's ``empty`` makes one stream's table); a
single-stream table, as :func:`insert` and :func:`extract` take it, is
``drop_stream_axis(empty(1, ...))``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from aloam_tpu_torch.ops import evict as evict_op
from aloam_tpu_torch.ops import gather as gather_op
from aloam_tpu_torch.ops import insert as insert_op
from aloam_tpu_torch.ops import knn as knn_op
from aloam_tpu_torch.ops.linalg3 import true_div
from aloam_tpu_torch.utils.batch import drop_stream_axis

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # spatial-hash primes
_EMPTY = 32767                                 # cell-coordinate sentinel
_FAR = 1e9            # empty-slot position: fails every distance gate
_AUX_CLEAR = (0, _EMPTY, _EMPTY, _EMPTY, 0)    # aux planes of a clear slot

# Tile height of the association kernel's query tiles; ASSOC_PAD rows
# appended to each stream's candidate rows keep every tile's cell window
# [align8(cid0), align8(cid0) + TQ + 8) in bounds.
ASSOC_TQ = 256
ASSOC_PAD = ASSOC_TQ + 8


class GridMap(NamedTuple):
    """One feature class's table: pts (B, H, 3·Bk) f32, aux (B, H, 5·Bk)
    i32 (see the module docstring)."""
    pts: torch.Tensor
    aux: torch.Tensor

    @property
    def bucket_cap(self) -> int:
        return self.aux.shape[-1] // 5

    def _auxv(self) -> torch.Tensor:
        return self.aux.view(self.aux.shape[:-1] + (5, self.bucket_cap))

    @property
    def inten(self) -> torch.Tensor:   # (..., Bk) f32 averaged intensity
        return self._auxv()[..., 0, :].contiguous().view(torch.float32)

    @property
    def cell(self) -> torch.Tensor:    # (..., 3·Bk) i32 cell coordinates
        return self._auxv()[..., 1:4, :].reshape(
            self.aux.shape[:-1] + (3 * self.bucket_cap,))


class TableShard(NamedTuple):
    """This rank's part of tables partitioned over their bucket axis: rows
    [index·h, (index+1)·h) of H = h·count, where h is the leaves' own
    dim 1. Counts and exchanged rows are summed over ``group``; with group
    None nothing is exchanged and a function returns this part's own
    partial sums (the CPU tests simulate ranks so). ``None`` in place of a
    TableShard means the whole table."""
    group: object
    index: int
    count: int


def _table_size(rows: int, shard: TableShard | None) -> int:
    """H, the hash modulus, of tables whose leaves hold ``rows`` rows."""
    return rows if shard is None else rows * shard.count


def _group_sum(t: torch.Tensor, shard: TableShard | None) -> torch.Tensor:
    """``t`` summed over the shard's group, in place (nothing to do for a
    whole table or a group of None). ``t`` is a device tensor made in the
    step and the call does not wait on the host, so on an NCCL group the
    ``all_reduce`` is captured with the step into its CUDA graph."""
    if shard is not None and shard.group is not None:
        dist.all_reduce(t, group=shard.group)
    return t


def _owned_rows(table: torch.Tensor, rows: torch.Tensor,
                shard: TableShard) -> torch.Tensor:
    """``bgather(whole table, rows)`` from a partitioned one, rows (B, ...)
    global bucket ids: each rank gathers the rows it owns and zeroes the
    rest, and the group sums the int32 bits, so every row comes from its
    owner bit for bit (a float sum would turn -0.0 into +0.0)."""
    h = table.shape[1]
    lo = shard.index * h
    own = (rows >= lo) & (rows < lo + h)
    got = gather_op.bgather(table, torch.where(own, rows - lo, 0))
    got.masked_fill_(~own[..., None], 0)
    return _group_sum(got.view(torch.int32), shard).view(table.dtype)


def empty(batch: int, table_size: int, bucket_cap: int,
          device=None) -> GridMap:
    # _hash masks with (table_size - 1): anything else would give bucket
    # ids out of range
    if table_size & (table_size - 1):
        raise ValueError(f"table_size must be a power of two, got "
                         f"{table_size}")
    aux = torch.tensor(_AUX_CLEAR, dtype=torch.int32, device=device)
    aux = aux.repeat_interleave(bucket_cap).repeat(batch, table_size, 1)
    pts = torch.full((batch, table_size, 3 * bucket_cap), _FAR,
                     dtype=torch.float32, device=device)
    return GridMap(pts=pts, aux=aux)


def _viewp(a: torch.Tensor) -> torch.Tensor:
    """(..., 3·Bk) bucket-planar -> (..., 3, Bk) view."""
    return a.view(a.shape[:-1] + (3, a.shape[-1] // 3))


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's-complement
    wraparound, which torch's int32 arithmetic does not promise)."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _mix(cx, cy, cz) -> torch.Tensor:
    """(cx·P1) ^ (cy·P2) ^ (cz·P3) with int32 wraparound, as int32. The
    products are exact in int64 and XOR acts bit by bit, so the low 32
    bits are those of the int32 arithmetic."""
    h = (cx.to(torch.int64) * _P1) ^ (cy.to(torch.int64) * _P2) \
        ^ (cz.to(torch.int64) * _P3)
    return _wrap32(h)


def _cells_of(pts: torch.Tensor, cell_size: float) -> torch.Tensor:
    return torch.floor(true_div(pts, cell_size)).to(torch.int32)


def _hash(cells: torch.Tensor, table_size: int) -> torch.Tensor:
    return _mix(cells[..., 0], cells[..., 1], cells[..., 2]) \
        & (table_size - 1)


def _vox_id(pts: torch.Tensor, leaf: float) -> torch.Tensor:
    """Hashed global voxel identity (32-bit; a collision within one cell
    at worst merges two neighbouring voxels once)."""
    v = torch.floor(true_div(pts, leaf)).to(torch.int32)
    return _mix(v[..., 0], v[..., 1], v[..., 2])


@functools.cache
def _offsets8(device=None) -> torch.Tensor:
    """The (8, 3) int32 offsets of a 2×2×2 cell block, made once per
    device: a hash calls it several times a frame, and a host-to-device
    copy cannot be captured into a CUDA graph."""
    g = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                 -1).reshape(8, 3)
    return torch.as_tensor(g, dtype=torch.int32, device=device)


def _block(cells: torch.Tensor, table_size: int):
    """The bucket rows of the 2×2×2 cell blocks at ``cells`` (..., 3): (hh
    (..., 8) in ``_offsets8`` order, dup (..., 8) True where an earlier
    cell of the block hashes to the same bucket)."""
    hh = _hash(cells[..., None, :] + _offsets8(cells.device), table_size)
    same = hh[..., :, None] == hh[..., None, :]
    tri = torch.ones((8, 8), dtype=torch.bool, device=cells.device).tril(-1)
    return hh, (same & tri).any(dim=-1)


def block_buckets(query: torch.Tensor, table_size: int, cell_size: float,
                  radius: float):
    """The 2×2×2 bucket block of each query (..., 3): its base cell
    floor((q - radius) / cell) and :func:`_block` of it, (hh, dup)."""
    return _block(_cells_of(query - radius, cell_size), table_size)


def n_valid(grid: GridMap, shard: TableShard | None = None) -> torch.Tensor:
    """Live entries of a table, every leading axis summed (0-dim), over
    the shard's group."""
    return _group_sum((grid._auxv()[..., 1, :] != _EMPTY).sum(), shard)


def count_near(grid: GridMap, center: torch.Tensor, half_cells: torch.Tensor,
               shard: TableShard | None = None) -> torch.Tensor:
    """Live entries within center ± half_cells (cell coordinates): the
    reference's local 5×5×3-cube map-point count that gates the mapping
    solve (laserMapping.cpp:531-554). Grid leaves (H, ·) and center (3,)
    give a 0-dim count; (B, H, ·) and (B, 3) one per stream (B,). Summed
    over the shard's group."""
    c = grid._auxv()[..., 1:4, :]                    # (..., H, 3, Bk)
    near = (c[..., 0, :] != _EMPTY) & (
        (c - center[..., None, :, None]).abs()
        <= half_cells[:, None]).all(dim=-2)
    return _group_sum(near.sum(dim=(-2, -1)), shard)


count_near_b = count_near   # the JAX package's batched name


def _clear(grid: GridMap, out: torch.Tensor) -> None:
    """Clear the slots ``out`` (..., H, Bk) in place."""
    av = grid._auxv()
    av[..., 0, :].masked_fill_(out, 0)
    av[..., 1:4, :].masked_fill_(out[..., None, :], _EMPTY)
    av[..., 4, :].masked_fill_(out, 0)
    _viewp(grid.pts).masked_fill_(out[..., None, :], _FAR)


def invalidate_outside(grid: GridMap, center: torch.Tensor,
                       half_cells: torch.Tensor,
                       shard: TableShard | None = None):
    """Clear every live entry outside center ± half_cells, in place: the
    reference's rolling-window discard (laserMapping.cpp:323-507). Grid
    leaves (H, ·) with center (3,), or (B, H, ·) with (B, 3). Returns
    (grid, n_cleared), n_cleared 0-dim or (B,), summed over the shard's
    group (each rank clears its own rows)."""
    c = grid._auxv()[..., 1:4, :]
    out = (c[..., 0, :] != _EMPTY) & (
        (c - center[..., None, :, None]).abs() > half_cells[:, None]).any(
            dim=-2)
    n_out = out.sum(dim=(-2, -1))
    _clear(grid, out)
    return grid, _group_sum(n_out, shard)


def evict_and_count(grid: GridMap, center: torch.Tensor,
                    window_half: torch.Tensor, local_half: torch.Tensor,
                    evict: bool = True, shard: TableShard | None = None):
    """Rolling-window discard and local-map census in one pass over the
    cell planes: clears every live entry outside center ± window_half (the
    reference's cube shift, laserMapping.cpp:323-507) and counts the live
    entries within center ± local_half after the clear (the 5×5×3-cube
    count that gates the solve, :531-554). center (B, 3) int32 pose cells,
    the halves (3,) int32.

    The pass is ``ops/evict.evict_and_count``: for CUDA tables a kernel
    that reads the cell planes once and writes only the slots it clears,
    for CPU ones the plain version. The clear runs every call, in place
    (the JAX package skips it under a ``lax.cond`` on frames with nothing
    out; the condition would cost a host sync here). With ``evict`` False
    the table is untouched and the census counts stale in-window entries
    too. On a shard each rank clears its own rows and both counts are
    summed over the group. Returns (grid, n_cleared (B,), n_near (B,))."""
    n_out, n_near = _group_sum(evict_op.evict_and_count(
        grid.pts, grid.aux, center, window_half, local_half, evict), shard)
    return grid, n_out, n_near


class KnnCache(NamedTuple):
    """Per-cell candidate blocks and per-query cell slots (see
    knn_cache_b). Reusable across nearby query poses: after a sub-cell
    pose refinement only the queries whose shifted base cell crossed a
    2 m boundary see a different candidate set."""
    cand_flat: torch.Tensor   # (B, C + ASSOC_PAD, 8·3·Bk) candidate xyz
    cid: torch.Tensor         # (B, Q) per-query cell slot (== C: spilled)
    cid_sorted: torch.Tensor  # (B, Q) slots in sorted query order
    n_spilled: torch.Tensor   # (B,) queries beyond cell_cap, per stream
    cell_cap: int


def knn_cache_b(grid: GridMap, query: torch.Tensor, cell_size: float,
                radius: float = 1.0, cell_cap: int = 4096,
                payloads: tuple = (), shard: TableShard | None = None):
    """Group queries (B, Q, 3) by their base cell floor((q - radius) /
    cell) and gather each occupied cell's 2×2×2 bucket block once.

    payloads: (B, Q) tensors carried through the cell sort. Returns the
    cache alone when there are none, else ``(cache, sorted_payloads)``.
    Queries beyond ``cell_cap`` distinct cells per stream go to the spill
    slot and are counted in ``n_spilled`` (per stream; the JAX package
    sums over the batch). On a shard the candidate rows come from their
    owners (:func:`_owned_rows`), so every rank builds the whole-table
    cache."""
    if cell_size < 2 * radius:
        raise ValueError(f"cell_size {cell_size} < 2 * radius {radius}")
    bsz, q_n = query.shape[:2]
    dev = query.device
    table_size = _table_size(grid.pts.shape[1], shard)
    bk = grid.bucket_cap

    # --- group queries by base cell: one stable sort, payloads gathered ---
    qcell = _cells_of(query - radius, cell_size)             # (B, Q, 3)
    rel = (qcell - qcell.amin(dim=1, keepdim=True)).clamp(0, 1023)
    key = (rel[..., 0] << 20) | (rel[..., 1] << 10) | rel[..., 2]
    key_s, order = torch.sort(key, dim=1, stable=True)
    qcell_s = qcell.gather(1, order[..., None].expand(bsz, q_n, 3))
    pay_s = tuple(p.gather(1, order) for p in payloads)
    seg = torch.ones_like(key_s, dtype=torch.bool)
    seg[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
    cid_s = seg.to(torch.int32).cumsum(dim=1, dtype=torch.int32) - 1
    n_spilled = (cid_s >= cell_cap).sum(dim=1)
    cid_sc = cid_s.clamp_max(cell_cap)                       # spill slot

    # cell coordinates per slot, one flat scatter with a spare slot per
    # stream (index cell_cap) sliced off after. Every write to one slot
    # carries the same cell, so the scatter's write order does not matter.
    coff = torch.arange(bsz, device=dev)[:, None] * (cell_cap + 1)
    slot_cell = torch.zeros((bsz * (cell_cap + 1), 3), dtype=torch.int32,
                            device=dev)
    slot_cell[(cid_sc + coff).reshape(-1)] = qcell_s.reshape(-1, 3)
    slot_cell = slot_cell.view(bsz, cell_cap + 1, 3)[:, :cell_cap]
    # ASSOC_PAD zero rows: they hash to cell (0,0,0)'s real block, and only
    # gated (spilled or padding) queries can land on them
    slot_cell = torch.cat([slot_cell, torch.zeros(
        (bsz, ASSOC_PAD, 3), dtype=torch.int32, device=dev)], dim=1)

    # --- per-cell candidate blocks (the deduplicated gather) --------------
    hh, dup = _block(slot_cell, table_size)                  # (B, C+P, 8)
    cand = gather_op.bgather(grid.pts, hh) if shard is None \
        else _owned_rows(grid.pts, hh, shard)                # (B,C+P,8,3Bk)
    # a bucket that two block cells share is read once: the later copy is
    # poisoned at the _FAR sentinel
    cand = cand.masked_fill_(dup[..., None], _FAR)
    cand_flat = cand.view(bsz, cell_cap + ASSOC_PAD, 24 * bk)

    # per-query cell slot in input order (a permutation scatter)
    cid = torch.empty_like(cid_sc)
    cid.scatter_(1, order, cid_sc)
    cache = KnnCache(cand_flat=cand_flat, cid=cid, cid_sorted=cid_sc,
                     n_spilled=n_spilled, cell_cap=cell_cap)
    if payloads:
        return cache, pay_s
    return cache


def knn_from_cache_b(cache: KnnCache, query: torch.Tensor, k: int,
                     query_chunk: int = 0):
    """Gated k-NN of (possibly pose-refined) queries (B, Q, 3) against a
    KnnCache: each query's cell row runs the k-pass select
    (``ops/knn.knn_select``: the kernel for CUDA tensors, the plain version
    for CPU ones, whose row copy ``query_chunk`` bounds); a query at the
    spill slot (cid >= cell_cap) reads the last cell's row with +inf
    distances. Returns (d2 (B, Q, k), nbrs (B, Q, k, 3), n_spilled)."""
    bsz, q_n = query.shape[:2]
    crows = cache.cand_flat.shape[1]
    cid = cache.cid
    poison = cid >= cache.cell_cap
    row = cid.clamp_max(cache.cell_cap - 1) \
        + torch.arange(bsz, device=cid.device)[:, None] * crows
    q4 = torch.cat([query, poison[..., None].to(query.dtype)], dim=-1)
    d2, nbrs = knn_op.knn_select(
        cache.cand_flat.reshape(bsz * crows, -1), row.reshape(-1).int(),
        q4.reshape(-1, 4), k, query_chunk)
    return d2.view(bsz, q_n, k), nbrs.view(bsz, q_n, k, 3), cache.n_spilled


def knn_b(grid: GridMap, query: torch.Tensor, k: int, cell_size: float,
          radius: float = 1.0, query_chunk: int = 0, cell_cap: int = 4096):
    """Batched gated k-NN through the shared-cell cache: grid leaves
    (B, H, ·), query (B, Q, 3). Queries beyond ``cell_cap`` distinct cells
    per stream come back with +inf distances and are counted. Returns
    (d2 (B, Q, k), nbrs (B, Q, k, 3), n_spilled (B,))."""
    cache = knn_cache_b(grid, query, cell_size, radius, cell_cap)
    return knn_from_cache_b(cache, query, k, query_chunk)


def knn(grid: GridMap, query: torch.Tensor, k: int, cell_size: float,
        radius: float = 1.0, query_chunk: int = 0):
    """Gated exact k-NN of one stream: grid leaves (H, ·), query (Q, 3).
    Every map point within ``radius`` of a query lies in the 2×2×2 cell
    block at floor((q - radius) / cell). Returns (d2 (Q, k) ascending,
    +inf where fewer than k candidates are left, nbrs (Q, k, 3)).

    Each query reads its own block from the table (``ops/knn.knn_grid``:
    the kernel for CUDA tensors, for CPU ones the plain version, whose
    block copy ``query_chunk`` bounds), as the JAX package's ``knn`` does;
    no knn cache is built. The two differ only where no gate looks: a
    bucket that two block cells share is read once, its copy at the
    ``_FAR`` sentinel here and at d2 = +inf in JAX's ``knn``."""
    if cell_size < 2 * radius:
        raise ValueError(f"cell_size {cell_size} < 2 * radius {radius}")
    return knn_op.knn_grid(grid.pts, query.contiguous(), k, cell_size,
                           radius, query_chunk)


def insert_b(grid: GridMap, pts: torch.Tensor, inten: torch.Tensor,
             mask: torch.Tensor, leaf: float, cell_size: float,
             center: torch.Tensor, window: torch.Tensor,
             point_cap: int = 16, touched_cap: int = 4096,
             shard: TableShard | None = None):
    """Batched insert of one frame's voxel-downsampled stack per stream:
    pts (B, N, 3), inten and mask (B, N), center (B, 3) pose cells,
    window (3,) half-extent in cells.

    Points are sorted by bucket; each touched bucket's points (≤
    point_cap) are merged or appended against its slots in place
    (ops/insert.merge_rows). Matching is on the
    voxel id; a merge takes the midpoint; appends fill slots in eviction
    order (empty < out-of-window < in-window, farthest first). Returns
    (grid, merged, appended, evicted, dropped), each (B,); dropped counts
    valid points that neither merged nor appended. On a shard each rank
    merges the rows it owns and the counts are summed over the group."""
    table_size = _table_size(grid.aux.shape[1], shard)
    cell = _cells_of(pts, cell_size)
    vox = _vox_id(pts, leaf)
    key = torch.where(mask, _hash(cell, table_size), table_size)
    key_s, order = torch.sort(key, dim=1, stable=True)
    px_s, py_s, pz_s = (pts[..., c].gather(1, order) for c in range(3))
    return _insert_sorted(grid, key_s, px_s, py_s, pz_s,
                          inten.gather(1, order), vox.gather(1, order),
                          mask.sum(dim=1), leaf, cell_size, center, window,
                          point_cap, touched_cap, shard)


def _insert_sorted(grid: GridMap, key_s, px_s, py_s, pz_s, pi_s, vox_s,
                   total_valid, leaf: float, cell_size: float,
                   center: torch.Tensor, window: torch.Tensor,
                   point_cap: int, touched_cap: int,
                   shard: TableShard | None):
    """insert_b after the bucket sort: key_s (B, N) sorted bucket ids with
    invalid rows at the ``table_size`` sentinel, and the sorted payload
    planes. Shared by insert_b and insert_vds_b. On a shard the rows and
    the touched_cap / point_cap cuts are formed on the whole sorted list,
    as for the whole table, so every rank drops the same points; then
    only the owned rows are merged (:func:`_owned_run`)."""
    bsz, n = key_s.shape
    dev = key_s.device
    table_size = _table_size(grid.aux.shape[1], shard)
    cap_c, cap_p = touched_cap, point_cap
    valid_s = key_s < table_size

    seg = valid_s.clone()
    seg[:, 1:] &= key_s[:, 1:] != key_s[:, :-1]
    cid_s = seg.to(torch.int64).cumsum(dim=1) - 1
    iota_n = torch.arange(n, device=dev).expand(bsz, n)
    head = torch.where(seg, iota_n, -1).cummax(dim=1).values
    rank = iota_n - head
    keep = valid_s & (cid_s >= 0) & (cid_s < cap_c) & (rank < cap_p)

    # --- dense per-bucket point lists: flat scatters with one spare slot --
    # at the end, sliced off after; every kept point has its own slot, so
    # no two writes collide outside the spare. Row r of stream b is flat
    # row b * cap_c + r, so the lists come out contiguous.
    n_rows = bsz * cap_c
    coff = torch.arange(bsz, device=dev)[:, None] * cap_c
    brow = torch.where(keep, cid_s + coff, n_rows)           # (B, N)
    flat_np = n_rows * cap_p
    ppos = torch.where(keep, brow * cap_p + rank, flat_np).reshape(-1)

    def scat(vals, dtype):
        buf = torch.zeros((flat_np + 1,), dtype=dtype, device=dev)
        buf[ppos] = vals.reshape(-1)
        return buf[:flat_np].view(bsz, cap_c, cap_p)

    ppx, ppy, ppz, ppi = (scat(v, torch.float32)
                          for v in (px_s, py_s, pz_s, pi_s))
    pvox = scat(vox_s, torch.int32)
    cnt = torch.zeros((n_rows + 1,), dtype=torch.int32, device=dev)
    cnt.index_add_(0, brow.reshape(-1), keep.to(torch.int32).reshape(-1))
    cnt = cnt[:n_rows].view(bsz, cap_c)
    # each kept row of a bucket writes that bucket's id; cids are dense,
    # so the used rows (cnt > 0) are a prefix of each stream's rows and
    # name distinct buckets
    slot_h = torch.zeros((n_rows + 1,), dtype=torch.int32, device=dev)
    slot_h[brow.reshape(-1)] = key_s.reshape(-1)
    slot_h = slot_h[:n_rows].view(bsz, cap_c)
    if shard is not None:
        slot_h, cnt, ppx, ppy, ppz, ppi, pvox = _owned_run(
            slot_h, cnt, (ppx, ppy, ppz, ppi, pvox), grid.aux.shape[1],
            shard.index)

    # --- merge and eviction-priority appends, in place (kernel module) ----
    merged_pb, appended_pb, evicted_pb = insert_op.merge_rows(
        grid.pts, grid.aux, slot_h, cnt, ppx, ppy, ppz, ppi, pvox,
        center.to(torch.int32).contiguous(),
        window.to(torch.int32).contiguous(), cell_size, leaf)

    merged = merged_pb.sum(dim=1)
    appended = appended_pb.sum(dim=1)
    evicted = evicted_pb.sum(dim=1)
    if shard is not None:
        merged, appended, evicted = _group_sum(
            torch.stack([merged, appended, evicted]), shard)
    dropped = total_valid - merged - appended
    return grid, merged, appended, evicted, dropped


def _owned_run(slot_h: torch.Tensor, cnt: torch.Tensor, lists: tuple,
               rows: int, index: int):
    """The insert's bucket rows that part ``index`` of a partitioned table
    (``rows`` rows a part) owns, moved to the front of each stream's rows.

    slot_h and cnt (B, C) as ``_insert_sorted`` builds them: the used rows
    (cnt > 0) a prefix of ascending, distinct global buckets, so the owned
    ones, buckets in [index·rows, (index+1)·rows), are one run of it.
    ``lists`` (B, C, P) follow their rows. Returns (slot_h, cnt, *lists)
    with the run at rows [0, run length), slot_h local, and every row past
    it unused (cnt 0, slot_h 0): the prefix that ``ops/insert.merge_rows``
    takes (its plain version sends unused rows to row 0's place). A stream
    with no owned row gets no used row."""
    lo = index * rows
    used = cnt > 0
    first = (used & (slot_h < lo)).sum(dim=1, keepdim=True)
    n_own = (used & (slot_h >= lo) & (slot_h < lo + rows)).sum(
        dim=1, keepdim=True)
    cap_c = cnt.shape[1]
    j = torch.arange(cap_c, device=cnt.device)
    take = j < n_own
    src = (first + j).clamp_max(cap_c - 1)
    return (torch.where(take, slot_h.gather(1, src) - lo, 0),
            torch.where(take, cnt.gather(1, src), 0),
            *(p.gather(1, src[..., None].expand_as(p)) for p in lists))


def insert_vds_b(grid: GridMap, pts: torch.Tensor, inten: torch.Tensor,
                 mask: torch.Tensor, leaf: float, cell_size: float,
                 center: torch.Tensor, window: torch.Tensor,
                 point_cap: int = 16, touched_cap: int = 4096,
                 shard: TableShard | None = None):
    """Map-frame voxel downsample fused with insert: the same result as
    ``voxel_downsample_masked_b(vals, mask, leaf, out_cap=N)`` followed by
    :func:`insert_b`, one sort cheaper. Each voxel's mean is formed at its
    segment tail, keyed by the bucket of the mean (other rows take the
    ``table_size`` sentinel), and one stable sort groups the means by
    bucket in voxel order. pts (B, N, 3) map-frame points. Returns (grid,
    merged, appended, evicted, dropped), dropped counted against the
    number of occupied voxels; a shard as in :func:`insert_b`."""
    from aloam_tpu_torch.frontend.voxel import voxel_segment_tails
    table_size = _table_size(grid.aux.shape[1], shard)
    vals = torch.cat([pts, inten[..., None]], dim=-1)
    sums, cnts, is_tail = voxel_segment_tails(vals, mask, leaf)
    den = cnts.clamp_min(1.0)       # divide (not * reciprocal): JAX parity
    mx, my, mz, mi = (sums[c] / den for c in range(4))

    # bucket of the voxel mean: floor(x / cell_size), keep the division
    # (floor(x * (1 / cell_size)) can round differently at cell edges)
    h = _hash(torch.stack([_cells_of(m, cell_size) for m in (mx, my, mz)],
                          dim=-1), table_size)
    key = torch.where(is_tail, h, table_size)
    key_s, order = torch.sort(key, dim=1, stable=True)
    px_s, py_s, pz_s, pi_s = (m.gather(1, order) for m in (mx, my, mz, mi))
    vox_s = _vox_id(torch.stack([px_s, py_s, pz_s], dim=-1), leaf)
    return _insert_sorted(grid, key_s, px_s, py_s, pz_s, pi_s, vox_s,
                          is_tail.sum(dim=1), leaf, cell_size, center,
                          window, point_cap, touched_cap, shard)


def insert(grid: GridMap, pts: torch.Tensor, inten: torch.Tensor,
           mask: torch.Tensor, leaf: float, cell_size: float,
           center: torch.Tensor, window: torch.Tensor,
           point_cap: int | None = None, touched_cap: int | None = None):
    """:func:`insert_b` of one stream: grid leaves (H, ·), updated in place
    (a view of the stream axis of 1), pts (N, 3), inten and mask (N,),
    center (3,). The JAX package's default caps: point_cap covers a whole
    bucket (max(bucket_cap, 32)), touched_cap min(N, 8192); the kernel
    takes point_cap up to 128 (``ops/insert.merge_rows``), as many as a
    bucket's slots. Returns (grid, merged, appended, evicted, dropped)."""
    n = pts.shape[0]
    if point_cap is None:
        point_cap = max(grid.bucket_cap, 32)
    if touched_cap is None:
        touched_cap = min(n, 8192)
    out = insert_b(GridMap(grid.pts[None], grid.aux[None]), pts[None],
                   inten[None], mask[None], leaf, cell_size, center[None],
                   window, point_cap=point_cap, touched_cap=touched_cap)
    return drop_stream_axis(out)


def extract(grid: GridMap):
    """Host-side (points (N, 3), intensity (N,)) of all live entries of a
    single-stream grid (leaves (H, ·)), as numpy arrays."""
    bk = grid.bucket_cap
    cell = grid.cell.cpu().numpy()
    cell = cell.reshape(cell.shape[:-1] + (3, bk))
    m = cell[..., 0, :] != _EMPTY
    pts = np.moveaxis(grid.pts.cpu().numpy().reshape(
        grid.pts.shape[:-1] + (3, bk)), -2, -1)
    return pts[m], grid.inten.cpu().numpy()[m]
