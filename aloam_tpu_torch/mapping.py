"""Scan-to-map refinement on the persistent voxel-hash world map (port of
``aloam_tpu/mapping.py``, batched form).

Re-design of laserMapping.cpp, as in the JAX package: the map is the
spatial-hash grid of ops/gridmap.py, query-ready at all times (no
per-frame cube gather, KD-tree build or cube rolling). The associations
keep the reference's math: 5-NN gated at 1.0 m², 3×3 covariance PCA for
lines (λ₂ > 3λ₁, virtual points at ±0.1 m, :577-640), least-squares
planes with the 0.2 m inlier check (:642-705), two rounds of ≤ 4 LM
iterations (:562, :715), and the odom→map correction chain
transformAssociateToMap / transformUpdate (:142-152).

Each association round runs over cell-sorted stacks (the order the knn
cache build produces): the solver and every metric reduce over factors
in any order, and the insert re-sorts by bucket, so nothing is unsorted.
The map tables are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aloam_tpu.config import AloamConfig
from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import solver
from aloam_tpu_torch.frontend.voxel import voxel_downsample_masked_b
from aloam_tpu_torch.ops import assoc as assoc_op
from aloam_tpu_torch.ops import gridmap
from aloam_tpu_torch.solver import lm_solve_b
from aloam_tpu_torch.types import PointCloud


class MapState(NamedTuple):
    """Per-stream mapping state; leaves carry a leading B axis."""
    corner: gridmap.GridMap
    surf: gridmap.GridMap
    q_wmap_wodom: torch.Tensor  # odom-world -> map-world (laserMapping:116)
    t_wmap_wodom: torch.Tensor
    q_w: torch.Tensor           # latest mapped pose (parameters[], :110-112)
    t_w: torch.Tensor


class MapMetrics(NamedTuple):
    """(B,) per stream. ``overflow`` counts capacity losses (stack
    truncation, cell-cap and cell-window spills, full buckets) of each
    stream; the JAX package adds the batch-wide spill sums to every
    stream."""
    from_map_corner: torch.Tensor
    from_map_surf: torch.Tensor
    corner_factors: torch.Tensor
    surf_factors: torch.Tensor
    solved: torch.Tensor
    overflow: torch.Tensor
    evicted: torch.Tensor       # rolling-window discards
    degenerate: torch.Tensor    # clamped / non-finite LM iterations
    # queries whose knn base cell crossed a 2 m boundary between solver
    # rounds: the only deviation of the round-2 cache reuse from the
    # reference's per-round re-search (laserMapping.cpp:562-727)
    cache_crossed: torch.Tensor


def init_state(cfg: AloamConfig, batch: int, device) -> MapState:
    q = geo.qidentity(device).expand(batch, 4).contiguous()
    t = torch.zeros((batch, 3), dtype=torch.float32, device=device)
    return MapState(
        corner=gridmap.empty(batch, cfg.map_table_corner,
                             cfg.map_bucket_corner, device),
        surf=gridmap.empty(batch, cfg.map_table_surf, cfg.map_bucket_surf,
                           device),
        q_wmap_wodom=q, t_wmap_wodom=t, q_w=q.clone(), t_w=t.clone())


def state_from_numpy(tree, device) -> MapState:
    """The port's state from a JAX batched ``MapState`` whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, state)``), bit for bit."""
    def t(x):
        return torch.from_numpy(np.array(x)).to(device)

    def grid(g):
        return gridmap.GridMap(pts=t(g.pts), aux=t(g.aux))
    return MapState(corner=grid(tree.corner), surf=grid(tree.surf),
                    q_wmap_wodom=t(tree.q_wmap_wodom),
                    t_wmap_wodom=t(tree.t_wmap_wodom), q_w=t(tree.q_w),
                    t_w=t(tree.t_w))


def _cells(half_m, cfg: AloamConfig, device) -> torch.Tensor:
    return torch.as_tensor(np.ceil(np.asarray(half_m) / cfg.knn_cell),
                           dtype=torch.int32, device=device)


def _window_cells(cfg: AloamConfig, device=None) -> torch.Tensor:
    """Half-extent of the reference's rolling map window (21×21×11 cubes ×
    50 m, laserMapping.cpp:77-82) in grid cells."""
    return _cells(np.array([cfg.cube_width, cfg.cube_height,
                            cfg.cube_depth]) * cfg.cube_size / 2.0, cfg,
                  device)


def _local_cells(cfg: AloamConfig, device=None) -> torch.Tensor:
    """Half-extent of the reference's local 5×5×3-cube gather around the
    pose cube (laserMapping.cpp:509-529) in grid cells: the neighbourhood
    whose point counts gate the solve (:554)."""
    return _cells(np.array([2.5, 2.5, 1.5]) * cfg.cube_size, cfg, device)


def _eager_evict_count(state: MapState, pose_cell: torch.Tensor,
                       cfg: AloamConfig):
    """Rolling-window discard and local-map census at the top of the
    mapping step (the reference's cube shift, :323-507, with the point
    count that gates the solve, :531-554). Returns (state, n_cleared,
    n_map_corner, n_map_surf), each count (B,)."""
    dev = pose_cell.device
    window, local = _window_cells(cfg, dev), _local_cells(cfg, dev)
    corner, n_c, near_c = gridmap.evict_and_count(
        state.corner, pose_cell, window, local, cfg.eager_window_evict)
    surf, n_s, near_s = gridmap.evict_and_count(
        state.surf, pose_cell, window, local, cfg.eager_window_evict)
    return state._replace(corner=corner, surf=surf), n_c + n_s, near_c, \
        near_s


def _assoc_kw(cfg: AloamConfig) -> dict:
    return dict(plane_tol=cfg.map_plane_tol, eigen_ratio=cfg.map_eigen_ratio,
                half_len=cfg.map_edge_half_len)


def _factors_of(out8, stack_xyz, kind: str):
    """Unpack ops/assoc.py's packed (..., 8) factor columns."""
    if kind == "corner":
        return solver.EdgeFactors(p=stack_xyz, a=out8[..., 0:3],
                                  b=out8[..., 3:6], mask=out8[..., 6] > 0)
    return solver.PlaneFactors(p=stack_xyz, n=out8[..., 0:3],
                               d=out8[..., 3], mask=out8[..., 4] > 0)


def _assoc_out8_b(sel: torch.Tensor, poison: torch.Tensor,
                  cache: gridmap.KnnCache, cfg: AloamConfig, kind: str):
    """One association round over cell-sorted queries.

    sel (B, Q, 3) world-frame queries in the cache's sorted order; poison
    (B, Q) True gates a query. Queries are padded per stream to whole
    TQ-query tiles (pads poisoned, carrying the stream's last cell slot so
    cid stays non-decreasing), flattened with stream offsets so no tile
    straddles two streams, and handed to ``ops.assoc.assoc_cell`` with
    each tile's first cell slot and every query's local offset. Returns
    (out8 (B, Q, 8), n_spilled (B,)): the live queries lost to the
    ``cfg.assoc_cspan`` cell-window cap, which the caller folds into the
    overflow metric."""
    # spilled queries sit at the spill slot, whose rows hold a real bucket
    # block: poison them
    poison = poison | (cache.cid_sorted >= cache.cell_cap)
    bsz, q_n0 = sel.shape[:2]
    tq = gridmap.ASSOC_TQ
    cspan = cfg.assoc_cspan
    if cspan % 8 or not 0 <= cspan <= tq:
        raise ValueError(f"assoc_cspan {cspan}: a multiple of 8 in "
                         f"[0, {tq}]")
    crows = cache.cand_flat.shape[1]                 # cell_cap + ASSOC_PAD
    cid_sorted = cache.cid_sorted
    q_pad = (-q_n0) % tq
    q_n = q_n0 + q_pad
    if q_pad:
        sel = torch.nn.functional.pad(sel, (0, 0, 0, q_pad))
        poison = torch.nn.functional.pad(poison, (0, q_pad), value=True)
        cid_sorted = torch.cat(
            [cid_sorted, cid_sorted[:, -1:].expand(bsz, q_pad)], dim=1)
    cid_flat = (cid_sorted + torch.arange(bsz, device=sel.device)[:, None]
                * crows).reshape(-1)
    cid0 = cid_flat[::tq]
    local = cid_flat - cid0.repeat_interleave(tq)

    n_spilled = torch.zeros((bsz,), dtype=torch.int64, device=sel.device)
    if 0 < cspan < tq:
        # the tile's clipped window starts at align8(cid0): a query whose
        # offset from there reaches cspan + 8 gets no factors
        rem = cid0 - 8 * torch.div(cid0, 8, rounding_mode="floor")
        spill = (local + rem.repeat_interleave(tq) >= cspan + 8).view(
            bsz, q_n) & ~poison
        n_spilled = spill.sum(dim=1)
        poison = poison | spill

    q8 = torch.cat([sel.reshape(-1, 3),
                    poison.reshape(-1, 1).to(torch.float32),
                    local[:, None].to(torch.float32),
                    torch.zeros((bsz * q_n, 3), dtype=torch.float32,
                                device=sel.device)], dim=1)
    out8 = assoc_op.assoc_cell(
        cache.cand_flat.view(bsz * crows, -1), cid0.to(torch.int32), q8,
        kind, cfg.map_knn_gate_sq, tq=tq, cspan=cspan, **_assoc_kw(cfg))
    return out8.view(bsz, q_n, 8)[:, :q_n0], n_spilled


def mapping_step_b(state: MapState, corner_in: PointCloud,
                   surf_in: PointCloud, q_wodom: torch.Tensor,
                   t_wodom: torch.Tensor, cfg: AloamConfig):
    """One mapping frame for B streams (laserMapping.cpp process(),
    :231-888): clouds (B, N, ·), odometry poses (B, 4) / (B, 3). The map
    tables of ``state`` are updated in place. Returns (new_state,
    MapMetrics); the refined pose is new_state.(q_w, t_w)."""
    dev = q_wodom.device
    # initial guess from the odometry pose (transformAssociateToMap)
    q_w = geo.qmul(state.q_wmap_wodom, q_wodom)
    t_w = geo.qrot(state.q_wmap_wodom, t_wodom) + state.t_wmap_wodom

    pose_cell = gridmap._cells_of(t_w, cfg.knn_cell)
    state, cleared, n_map_corner, n_map_surf = _eager_evict_count(
        state, pose_cell, cfg)
    solve_ok = (n_map_corner > cfg.map_min_corner) \
        & (n_map_surf > cfg.map_min_surf)

    # input stack downsample (:542-550), sensor frame like the reference
    def downsample(cloud, leaf, cap):
        vals = torch.cat([cloud.xyz, cloud.intensity[..., None]], dim=-1)
        out, m, dropped = voxel_downsample_masked_b(vals, cloud.mask, leaf,
                                                    cap)
        return out[..., :3], out[..., 3], m, dropped

    corner_stack, c_int, c_mask, dc = downsample(
        corner_in, cfg.line_resolution, cfg.corner_stack_cap)
    surf_stack, s_int, s_mask, ds_ = downsample(
        surf_in, cfg.plane_resolution, cfg.surf_stack_cap)

    def build_cache(grid, stack, inten, m, qq, tt):
        """Cache build and the cell sort, carrying the stack through it."""
        sel0 = geo.qrot(qq[:, None, :], stack) + tt[:, None, :]
        cache, (sx, sy, sz, it, mi) = gridmap.knn_cache_b(
            grid, sel0, cfg.knn_cell, cfg.knn_radius, cfg.map_cell_cap,
            payloads=(stack[..., 0], stack[..., 1], stack[..., 2], inten, m))
        return cache, torch.stack([sx, sy, sz], -1), it, mi

    bsz = q_w.shape[0]
    zeros = torch.zeros((bsz,), dtype=torch.int64, device=dev)
    degen, spills, crossed = zeros, zeros, zeros
    n_edge = n_plane = None
    c_cache = s_cache = cells0 = None
    for rnd in range(cfg.map_outer_rounds):
        # round 2+ reuses round 1's candidate blocks (cfg.map_cache_reuse);
        # the reference re-runs its kd-tree search each round
        if c_cache is None or not cfg.map_cache_reuse:
            c_cache, corner_stack, c_int, c_mask = build_cache(
                state.corner, corner_stack, c_int, c_mask, q_w, t_w)
            s_cache, surf_stack, s_int, s_mask = build_cache(
                state.surf, surf_stack, s_int, s_mask, q_w, t_w)
            spills = spills + c_cache.n_spilled + s_cache.n_spilled
        sel_c = geo.qrot(q_w[:, None, :], corner_stack) + t_w[:, None, :]
        sel_s = geo.qrot(q_w[:, None, :], surf_stack) + t_w[:, None, :]
        live_c = c_mask & solve_ok[:, None]
        live_s = s_mask & solve_ok[:, None]
        if cfg.map_cache_reuse:
            # the reuse deviation: queries whose base cell moved since
            # round 1 (see MapMetrics.cache_crossed)
            cc = gridmap._cells_of(sel_c - cfg.knn_radius, cfg.knn_cell)
            sc = gridmap._cells_of(sel_s - cfg.knn_radius, cfg.knn_cell)
            if rnd == 0:
                cells0 = (cc, sc)
            else:
                crossed = crossed \
                    + ((cc != cells0[0]).any(-1) & live_c).sum(1) \
                    + ((sc != cells0[1]).any(-1) & live_s).sum(1)
        c8, csp = _assoc_out8_b(sel_c, ~live_c, c_cache, cfg, "corner")
        s8, ssp = _assoc_out8_b(sel_s, ~live_s, s_cache, cfg, "surf")
        spills = spills + csp + ssp
        edges = _factors_of(c8, corner_stack, "corner")
        planes = _factors_of(s8, surf_stack, "surf")
        q_w, t_w, stats = lm_solve_b(edges, planes, q_w, t_w,
                                     cfg.map_lm_iters, cfg.huber_delta)
        degen = degen + stats.clamped + stats.nonfinite
        n_edge = edges.mask.sum(dim=1)
        n_plane = planes.mask.sum(dim=1)

    # transformUpdate (:148-152)
    q_wmap_wodom = geo.qmul(q_w, geo.qconj(q_wodom))
    t_wmap_wodom = t_w - geo.qrot(q_wmap_wodom, t_wodom)

    # insert (:736-801): to the map frame, re-voxelize on the map-anchored
    # grid (PCL's origin-anchored leaves), then merge or append
    window = _window_cells(cfg, dev)
    center = gridmap._cells_of(t_w, cfg.knn_cell)

    def ins(grid, stack, inten, m, leaf):
        pts_w = geo.qrot(q_w[:, None, :], stack) + t_w[:, None, :]
        return gridmap.insert_vds_b(
            grid, pts_w, inten, m, leaf, cfg.knn_cell, center, window,
            cfg.map_insert_point_cap, cfg.map_insert_cell_cap)

    corner, _, _, ev1, dr1 = ins(state.corner, corner_stack, c_int, c_mask,
                                 cfg.line_resolution)
    surf, _, _, ev2, dr2 = ins(state.surf, surf_stack, s_int, s_mask,
                               cfg.plane_resolution)

    new_state = MapState(corner=corner, surf=surf,
                         q_wmap_wodom=q_wmap_wodom,
                         t_wmap_wodom=t_wmap_wodom, q_w=q_w, t_w=t_w)
    metrics = MapMetrics(
        from_map_corner=n_map_corner, from_map_surf=n_map_surf,
        corner_factors=n_edge, surf_factors=n_plane, solved=solve_ok,
        overflow=dc + ds_ + dr1 + dr2 + spills,
        evicted=ev1 + ev2 + cleared, degenerate=degen,
        cache_crossed=crossed)
    return new_state, metrics


def extract_map_cloud(state: MapState, cfg: AloamConfig):
    """Host-side full-map extraction, the /laser_cloud_map equivalent
    (laserMapping.cpp:823-836). Returns (corner, surf): per-stream lists
    of (N, 3) numpy arrays."""
    def per_stream(g):
        return [gridmap.extract(gridmap.GridMap(g.pts[b], g.aux[b]))[0]
                for b in range(g.pts.shape[0])]
    return per_stream(state.corner), per_stream(state.surf)
