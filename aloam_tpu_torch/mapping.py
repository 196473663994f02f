"""Scan-to-map refinement on the persistent voxel-hash world map (port of
``aloam_tpu/mapping.py``).

Re-design of laserMapping.cpp, as in the JAX package: the map is the
spatial-hash grid of ops/gridmap.py, query-ready at all times (no
per-frame cube gather, KD-tree build or cube rolling). The associations
keep the reference's math: 5-NN gated at 1.0 m², 3×3 covariance PCA for
lines (λ₂ > 3λ₁, virtual points at ±0.1 m, :577-640), least-squares
planes with the 0.2 m inlier check (:642-705), two rounds of ≤ 4 LM
iterations (:562, :715), and the odom→map correction chain
transformAssociateToMap / transformUpdate (:142-152).

Two mapping steps share everything but the search. ``mapping_step_b``
(B streams, the batched step) builds a per-cell knn cache and runs each
association round through the fused ``assoc_cell`` kernel over
cell-sorted stacks: the solver and every metric reduce over factors in any
order, and the insert re-sorts by bucket, so nothing is unsorted.
``mapping_step`` (one stream, the single-stream step) re-searches every
round exactly, as the reference does, through ``gridmap.knn`` and the
``knn_select`` kernel. The map tables are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import solver
from aloam_tpu_torch.config import AloamConfig
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


def _associations(stack_xyz, stack_mask, grid: gridmap.GridMap, q, t,
                  cfg: AloamConfig, kind: str):
    """Exact-search factors of one stream: the gated 5-NN of every query
    (``gridmap.knn``), distances of masked-out queries set to +inf so the
    shared fit gates and zeroes them, then ``assoc_xla``. stack_xyz (Q, 3)
    sensor frame, stack_mask (Q,), grid leaves (H, ·), pose q (4,),
    t (3,)."""
    sel = geo.qrot(q, stack_xyz) + t
    d2, near = gridmap.knn(grid, sel, 5, cfg.knn_cell, cfg.knn_radius,
                           cfg.map_query_chunk)
    d2 = torch.where(stack_mask[:, None], d2, float("inf"))
    out8 = assoc_op.assoc_xla(d2, near, cfg.map_knn_gate_sq, kind,
                              **_assoc_kw(cfg))
    return _factors_of(out8, stack_xyz, kind)


def corner_associations(stack_xyz, stack_mask, grid: gridmap.GridMap, q, t,
                        cfg: AloamConfig) -> solver.EdgeFactors:
    """Map-frame edge factors of one stream (laserMapping.cpp:577-640):
    where the 5 neighbours' covariance has λ₂ > 3λ₁ the neighbourhood is a
    line, and the factor's virtual points sit at centroid ± 0.1·direction.
    Shapes as :func:`_associations`."""
    return _associations(stack_xyz, stack_mask, grid, q, t, cfg, "corner")


def surf_associations(stack_xyz, stack_mask, grid: gridmap.GridMap, q, t,
                      cfg: AloamConfig) -> solver.PlaneFactors:
    """Map-frame plane factors of one stream (laserMapping.cpp:642-705):
    solve A·n = -1, normalize, keep the plane iff every neighbour lies
    within 0.2 m of it. Shapes as :func:`_associations`."""
    return _associations(stack_xyz, stack_mask, grid, q, t, cfg, "surf")


def _associations_b(stack_xyz, stack_mask, grid, q, t, cfg: AloamConfig,
                    kind: str, cache=None):
    """Batched factors over input-ordered stacks (B, Q, ·) through the
    knn cache (``cfg.map_cell_cap`` cells per stream) and the
    ``knn_select`` kernel; masked-out queries ride the spill slot (+inf
    distances, gated). ``cache`` from an earlier call is reused as is.
    Returns (factors, n_spilled (B,), cache)."""
    sel = geo.qrot(q[:, None, :], stack_xyz) + t[:, None, :]
    if cache is None:
        cache = gridmap.knn_cache_b(grid, sel, cfg.knn_cell, cfg.knn_radius,
                                    cfg.map_cell_cap)
    cid = torch.where(stack_mask, cache.cid, cache.cell_cap)
    d2, near, spilled = gridmap.knn_from_cache_b(cache._replace(cid=cid),
                                                 sel, 5, cfg.map_query_chunk)
    out8 = assoc_op.assoc_xla(d2, near, cfg.map_knn_gate_sq, kind,
                              **_assoc_kw(cfg))
    return _factors_of(out8, stack_xyz, kind), spilled, cache


def corner_associations_b(stack_xyz, stack_mask, grid: gridmap.GridMap, q, t,
                          cfg: AloamConfig, cache=None):
    """Batched :func:`corner_associations` (see :func:`_associations_b`)."""
    return _associations_b(stack_xyz, stack_mask, grid, q, t, cfg, "corner",
                           cache)


def surf_associations_b(stack_xyz, stack_mask, grid: gridmap.GridMap, q, t,
                        cfg: AloamConfig, cache=None):
    """Batched :func:`surf_associations` (see :func:`_associations_b`)."""
    return _associations_b(stack_xyz, stack_mask, grid, q, t, cfg, "surf",
                           cache)


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


def _world(q_w, t_w, stack: PointCloud):
    """A (B, N) stack in the map frame at the poses (B, 4) / (B, 3)."""
    return geo.qrot(q_w[:, None, :], stack.xyz) + t_w[:, None, :]


class _Start(NamedTuple):
    """A mapping frame up to its solve (see :func:`_start`)."""
    state: MapState             # after the rolling-window discard
    q_w: torch.Tensor           # initial pose guess (B, 4) / (B, 3)
    t_w: torch.Tensor
    solve_ok: torch.Tensor      # (B,) the map-support gate (:554)
    corner: PointCloud          # downsampled input stacks, sensor frame
    surf: PointCloud
    n_map_corner: torch.Tensor  # (B,) live entries near the pose
    n_map_surf: torch.Tensor
    cleared: torch.Tensor       # (B,) entries discarded by the window
    dropped: torch.Tensor       # (B,) stack-cap truncation


def _start(state: MapState, corner_in: PointCloud, surf_in: PointCloud,
           q_wodom, t_wodom, cfg: AloamConfig) -> _Start:
    """What both mapping steps do before the solve: the initial guess from
    the odometry pose (transformAssociateToMap, :142-146), the
    rolling-window discard and the local-map census that gates the solve
    (:323-554), and the input stack downsample in the sensor frame
    (:542-550)."""
    q_w = geo.qmul(state.q_wmap_wodom, q_wodom)
    t_w = geo.qrot(state.q_wmap_wodom, t_wodom) + state.t_wmap_wodom
    pose_cell = gridmap._cells_of(t_w, cfg.knn_cell)
    state, cleared, n_map_corner, n_map_surf = _eager_evict_count(
        state, pose_cell, cfg)
    solve_ok = (n_map_corner > cfg.map_min_corner) \
        & (n_map_surf > cfg.map_min_surf)

    def downsample(cloud, leaf, cap):
        vals = torch.cat([cloud.xyz, cloud.intensity[..., None]], dim=-1)
        out, m, dropped = voxel_downsample_masked_b(vals, cloud.mask, leaf,
                                                    cap)
        return PointCloud(xyz=out[..., :3], intensity=out[..., 3],
                          mask=m), dropped

    corner, dc = downsample(corner_in, cfg.line_resolution,
                            cfg.corner_stack_cap)
    surf, ds_ = downsample(surf_in, cfg.plane_resolution, cfg.surf_stack_cap)
    return _Start(state=state, q_w=q_w, t_w=t_w, solve_ok=solve_ok,
                  corner=corner, surf=surf, n_map_corner=n_map_corner,
                  n_map_surf=n_map_surf, cleared=cleared, dropped=dc + ds_)


def _finish(st: _Start, corner: PointCloud, surf: PointCloud, q_w, t_w,
            q_wodom, t_wodom, cfg: AloamConfig, n_edge, n_plane, degen,
            spills, crossed):
    """What both mapping steps do after the solve: transformUpdate
    (:148-152), then the insert (:736-801) of both stacks at the refined
    pose: to the map frame, re-voxelized on the map-anchored grid (PCL's
    origin-anchored leaves), merged or appended (``insert_vds_b``). Returns
    (new MapState, MapMetrics)."""
    q_wmap_wodom = geo.qmul(q_w, geo.qconj(q_wodom))
    t_wmap_wodom = t_w - geo.qrot(q_wmap_wodom, t_wodom)
    window = _window_cells(cfg, q_w.device)
    center = gridmap._cells_of(t_w, cfg.knn_cell)

    def ins(grid, stack, leaf):
        return gridmap.insert_vds_b(
            grid, _world(q_w, t_w, stack), stack.intensity, stack.mask, leaf,
            cfg.knn_cell, center, window, cfg.map_insert_point_cap,
            cfg.map_insert_cell_cap)

    corner_g, _, _, ev1, dr1 = ins(st.state.corner, corner,
                                   cfg.line_resolution)
    surf_g, _, _, ev2, dr2 = ins(st.state.surf, surf, cfg.plane_resolution)
    new_state = MapState(corner=corner_g, surf=surf_g,
                         q_wmap_wodom=q_wmap_wodom,
                         t_wmap_wodom=t_wmap_wodom, q_w=q_w, t_w=t_w)
    metrics = MapMetrics(
        from_map_corner=st.n_map_corner, from_map_surf=st.n_map_surf,
        corner_factors=n_edge, surf_factors=n_plane, solved=st.solve_ok,
        overflow=st.dropped + dr1 + dr2 + spills,
        evicted=ev1 + ev2 + st.cleared, degenerate=degen,
        cache_crossed=crossed)
    return new_state, metrics


def _n_crossed(cells0, sel_c, sel_s, live_c, live_s, cfg: AloamConfig):
    """Base cells of this round's queries, and how many live queries'
    cells moved since ``cells0`` (round 1's; see
    MapMetrics.cache_crossed)."""
    cells = tuple(gridmap._cells_of(s - cfg.knn_radius, cfg.knn_cell)
                  for s in (sel_c, sel_s))
    if cells0 is None:
        return cells, 0
    return cells0, ((cells[0] != cells0[0]).any(-1) & live_c).sum(1) \
        + ((cells[1] != cells0[1]).any(-1) & live_s).sum(1)


def mapping_step_b(state: MapState, corner_in: PointCloud,
                   surf_in: PointCloud, q_wodom: torch.Tensor,
                   t_wodom: torch.Tensor, cfg: AloamConfig):
    """One mapping frame for B streams (laserMapping.cpp process(),
    :231-888): clouds (B, N, ·), odometry poses (B, 4) / (B, 3). Round 2+
    reuses round 1's knn cache when ``cfg.map_cache_reuse`` (the reference
    re-runs its kd-tree search each round). The map tables of ``state``
    are updated in place. Returns (new_state, MapMetrics); the refined
    pose is new_state.(q_w, t_w)."""
    st = _start(state, corner_in, surf_in, q_wodom, t_wodom, cfg)
    q_w, t_w, corner, surf = st.q_w, st.t_w, st.corner, st.surf

    def build_cache(grid, stack, qq, tt):
        """Cache build and the cell sort, carrying the stack through it."""
        cache, (sx, sy, sz, it, mi) = gridmap.knn_cache_b(
            grid, _world(qq, tt, stack), cfg.knn_cell, cfg.knn_radius,
            cfg.map_cell_cap, payloads=(stack.xyz[..., 0], stack.xyz[..., 1],
                                        stack.xyz[..., 2], stack.intensity,
                                        stack.mask))
        return cache, PointCloud(xyz=torch.stack([sx, sy, sz], -1),
                                 intensity=it, mask=mi)

    zeros = torch.zeros_like(st.solve_ok, dtype=torch.int64)
    degen, spills, crossed = zeros, zeros, zeros
    n_edge = n_plane = None
    c_cache = s_cache = cells0 = None
    for _ in range(cfg.map_outer_rounds):
        if c_cache is None or not cfg.map_cache_reuse:
            c_cache, corner = build_cache(st.state.corner, corner, q_w, t_w)
            s_cache, surf = build_cache(st.state.surf, surf, q_w, t_w)
            spills = spills + c_cache.n_spilled + s_cache.n_spilled
        sel_c, sel_s = _world(q_w, t_w, corner), _world(q_w, t_w, surf)
        live_c = corner.mask & st.solve_ok[:, None]
        live_s = surf.mask & st.solve_ok[:, None]
        if cfg.map_cache_reuse:
            # the reuse deviation: queries whose base cell moved since
            # round 1
            cells0, n = _n_crossed(cells0, sel_c, sel_s, live_c, live_s,
                                   cfg)
            crossed = crossed + n
        c8, csp = _assoc_out8_b(sel_c, ~live_c, c_cache, cfg, "corner")
        s8, ssp = _assoc_out8_b(sel_s, ~live_s, s_cache, cfg, "surf")
        spills = spills + csp + ssp
        edges = _factors_of(c8, corner.xyz, "corner")
        planes = _factors_of(s8, surf.xyz, "surf")
        q_w, t_w, stats = lm_solve_b(edges, planes, q_w, t_w,
                                     cfg.map_lm_iters, cfg.huber_delta)
        degen = degen + stats.clamped + stats.nonfinite
        n_edge = edges.mask.sum(dim=1)
        n_plane = planes.mask.sum(dim=1)
    return _finish(st, corner, surf, q_w, t_w, q_wodom, t_wodom, cfg,
                   n_edge, n_plane, degen, spills, crossed)


def _batch1(factors):
    """Unbatched factors -> the B = 1 factors lm_solve_b takes."""
    return type(factors)(*(x[None] for x in factors))


def mapping_step(state: MapState, corner_in: PointCloud,
                 surf_in: PointCloud, q_wodom: torch.Tensor,
                 t_wodom: torch.Tensor, cfg: AloamConfig):
    """One mapping frame of one stream (laserMapping.cpp process(),
    :231-888) with the reference's exact per-round re-search: every round
    runs :func:`corner_associations` / :func:`surf_associations`
    (``gridmap.knn``) at the current pose, so no query spills and
    ``cfg.map_cache_reuse`` and ``cfg.map_cell_cap`` do not apply.
    ``cache_crossed`` is counted as in :func:`mapping_step_b` (the pose
    moves the same way). state and clouds carry a stream axis of 1: state
    leaves (1, ·), clouds (1, N, ·), poses (1, 4) / (1, 3). The map tables
    are updated in place. Returns (new_state, MapMetrics) with (1,)
    leaves."""
    if q_wodom.shape[0] != 1:
        raise ValueError(f"mapping_step: one stream, got {q_wodom.shape[0]}")
    st = _start(state, corner_in, surf_in, q_wodom, t_wodom, cfg)
    q_w, t_w, corner, surf = st.q_w, st.t_w, st.corner, st.surf
    live_c = corner.mask & st.solve_ok[:, None]
    live_s = surf.mask & st.solve_ok[:, None]
    grid_c, grid_s = (gridmap.GridMap(pts=g.pts[0], aux=g.aux[0])
                      for g in (st.state.corner, st.state.surf))
    degen = crossed = torch.zeros_like(st.solve_ok, dtype=torch.int64)
    n_edge = n_plane = cells0 = None
    for _ in range(cfg.map_outer_rounds):
        cells0, n = _n_crossed(cells0, _world(q_w, t_w, corner),
                               _world(q_w, t_w, surf), live_c, live_s, cfg)
        crossed = crossed + n
        edges = corner_associations(corner.xyz[0], live_c[0], grid_c,
                                    q_w[0], t_w[0], cfg)
        planes = surf_associations(surf.xyz[0], live_s[0], grid_s, q_w[0],
                                   t_w[0], cfg)
        q_w, t_w, stats = lm_solve_b(_batch1(edges), _batch1(planes), q_w,
                                     t_w, cfg.map_lm_iters, cfg.huber_delta)
        degen = degen + stats.clamped + stats.nonfinite
        n_edge = edges.mask.sum()[None]
        n_plane = planes.mask.sum()[None]
    return _finish(st, corner, surf, q_w, t_w, q_wodom, t_wodom, cfg,
                   n_edge, n_plane, degen, torch.zeros_like(degen), crossed)


def _per_stream(grid: gridmap.GridMap):
    """Per stream, the (points (N, 3), intensity (N,)) of the live entries
    (numpy)."""
    return [gridmap.extract(gridmap.GridMap(grid.pts[b], grid.aux[b]))
            for b in range(grid.pts.shape[0])]


def extract_map_cloud(state: MapState, cfg: AloamConfig):
    """Host-side full-map extraction, the /laser_cloud_map equivalent
    (laserMapping.cpp:823-836). Returns (corner, surf): per-stream lists
    of (N, 3) numpy arrays."""
    return tuple([p for p, _ in _per_stream(g)]
                 for g in (state.corner, state.surf))


def extract_surround(state: MapState, cfg: AloamConfig):
    """Host-side local-neighbourhood extraction around the latest pose,
    the /laser_cloud_surround equivalent (laserMapping.cpp:806-821): the
    live entries within the 5×5×3-cube neighbourhood of each stream's
    pose. Returns (corner, surf): per-stream lists of (N, 3) numpy
    arrays."""
    half = np.array([2.5, 2.5, 1.5]) * cfg.cube_size
    t = state.t_w.cpu().numpy()
    return tuple([p[np.all(np.abs(p - t[b]) <= half, axis=1)]
                  for b, (p, _) in enumerate(_per_stream(g))]
                 for g in (state.corner, state.surf))
