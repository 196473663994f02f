"""Static configuration of the engine (the port's copy of
``aloam_tpu/config.py``, field for field).

One frozen dataclass collects every knob of the reference pipeline:

* the ROS-parameter surface (``scan_line``, ``minimum_range``,
  ``mapping_skip_frame``, ``mapping_line_resolution``,
  ``mapping_plane_resolution`` — reference ``scanRegistration.cpp:466-468``,
  ``laserOdometry.cpp:191``, ``laserMapping.cpp:902-903``),
* the hard-coded constants that are de-facto config (curvature threshold,
  pick counts, NMS window — ``scanRegistration.cpp:291-390``; distance gates
  — ``laserOdometry.cpp:65-66``; cube grid — ``laserMapping.cpp:74-82``;
  solver schedule — ``laserOdometry.cpp:278,496``), and
* the padded static capacities this engine needs because every buffer is a
  fixed-size array + mask instead of a ``std::vector``.
"""

from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class AloamConfig:
    # --- sensor / launch-file parameters -------------------------------
    scan_lines: int = 64                # `scan_line` (16 | 32 | 64)
    minimum_range: float = 5.0          # `minimum_range` [m]
    mapping_skip_frame: int = 1         # `mapping_skip_frame`
    line_resolution: float = 0.4        # `mapping_line_resolution` [m]
    plane_resolution: float = 0.8       # `mapping_plane_resolution` [m]
    scan_period: float = 0.1            # scanRegistration.cpp:60
    distortion: bool = False            # laserOdometry.cpp:59 (DISTORTION 0)
    emit_registered: bool = False       # /velodyne_cloud_registered output
                                        # (laserMapping.cpp:838-848)

    # --- feature extraction (scanRegistration.cpp) ---------------------
    curvature_threshold: float = 0.1    # :297,:352
    max_sharp: int = 2                  # :301
    max_less_sharp: int = 20            # :307
    max_flat: int = 4                   # :359
    nms_window: int = 5                 # :319,:331 (±5 ring neighbours)
    nms_gap_sq: float = 0.05            # :324 (point-gap early stop, m²)
    n_regions: int = 6                  # :282 (azimuth regions per ring)
    less_flat_leaf: float = 0.2         # :404 (per-ring voxel leaf, m)
    edge_margin: int = 5                # :249-251 ([start+5, end-6] windows)

    # --- odometry (laserOdometry.cpp) -----------------------------------
    dist_sq_threshold: float = 25.0     # :65
    nearby_scan: float = 2.5            # :66
    odom_outer_rounds: int = 2          # :278
    odom_lm_iters: int = 4              # :496
    huber_delta: float = 0.1            # :284

    # --- mapping (laserMapping.cpp) --------------------------------------
    cube_width: int = 21                # :77
    cube_height: int = 21               # :78
    cube_depth: int = 11                # :79
    cube_size: float = 50.0             # :312 (cube side, m)
    map_knn_gate_sq: float = 1.0        # :584,:652 (5th NN gate, m²)
    map_eigen_ratio: float = 3.0        # :611 (line-likeness λ₂ > 3λ₁)
    map_plane_tol: float = 0.2          # :674 (plane-fit inlier tolerance, m)
    map_min_corner: int = 10            # :554
    map_min_surf: int = 50              # :554
    map_outer_rounds: int = 2           # :562
    map_lm_iters: int = 4               # :715
    map_edge_half_len: float = 0.1      # :615 (virtual edge point offset, m)

    # --- padded static capacities (ours, not the reference's) -----------
    # Caps below are sized from measured HDL-64 occupancy maxima at B=16
    # (tools/occupancy_stats.py, round 4: surf stack 2708, corner stack
    # 2090, 694 query cells, 563 touched buckets) with ~1.5x margins —
    # every kernel's cost scales with the CAP, not the content (round-4
    # profile: the insert sort, dense lists, tile gathers, scatter-back
    # and the assoc kernel are all cap-linear), and all cap pressure is
    # surfaced in the overflow/spill metrics, never silent.
    n_raw: int = 131072                 # raw input points per scan (padded)
    ring_cap: int = 2560                # max points per ring after bucketing
    less_flat_cap: int = 32768          # less-flat (surf-last) cloud capacity
    corner_stack_cap: int = 3072        # downsampled input corner stack
    surf_stack_cap: int = 4096          # downsampled input surf stack
    knn_chunk: int = 8192               # streaming top-k chunk (neighbor axis)
    map_query_chunk: int = 0            # gridmap.knn query chunking (0 = off;
                                        # set for batched streams, see knn doc)
    map_cell_cap: int = 1024            # knn_b distinct query cells per
                                        # stream; spills are gated + counted
    assoc_cspan: int = 0                # cap on the assoc kernel's per-tile
                                        # cell-window span (0 = exact full
                                        # TQ window). Queries beyond the
                                        # clipped window lose their factors
                                        # — counted in overflow, never
                                        # silent (gridmap.ASSOC_CSPAN env
                                        # overrides for sweeps). Default
                                        # OFF: tiny scenes can have tile
                                        # spans near TQ; only measured
                                        # workloads (bench.batched_bench_cfg
                                        # sets 128 from tools/assoc_span.py
                                        # histograms) should clip
    eager_window_evict: bool = True     # clear out-of-window map entries at
                                        # the top of every mapping step (the
                                        # reference's rolling-window discard,
                                        # laserMapping.cpp:323-507). False =
                                        # lazy only (insert overflow priority
                                        # reclaims them under bucket
                                        # pressure) — revisits may then
                                        # re-associate against stale points
                                        # the reference would have dropped
    map_cache_reuse: bool = True        # round 2+ reuses round 1's knn
                                        # candidate blocks; queries whose
                                        # base cell moved see a stale block
                                        # (measured ~5-10% while converging,
                                        # ~0 steady-state; the
                                        # map_cache_crossed metric counts
                                        # them). False = re-search every
                                        # round (exact laserMapping.cpp
                                        # :562-727 semantics, ~+8% step)
    map_insert_point_cap: int = 16      # insert_b dense-list points/bucket
                                        # (measured max rank 32: the worst
                                        # single bucket drops points, counted
                                        # in overflow, re-inserted next frame)
    map_insert_cell_cap: int = 1024     # insert_b touched buckets/stream
                                        # (spills -> dropped, counted)
    # persistent spatial-hash map (ops/gridmap.py): the 2x2x2-cell query
    # block is exact iff knn_cell >= 2 * sqrt(map_knn_gate_sq); bucket caps
    # must hold a cell's worst-case voxel count (cell/leaf + 1)^2-ish for
    # surfaces plus clutter
    knn_cell: float = 2.0
    map_table_corner: int = 8192
    map_table_surf: int = 16384
    map_bucket_corner: int = 32
    map_bucket_surf: int = 48

    # --- derived capacities ---------------------------------------------
    @property
    def sharp_cap(self) -> int:
        return _round_up(self.scan_lines * self.n_regions * self.max_sharp, 8)

    @property
    def less_sharp_cap(self) -> int:
        return _round_up(
            self.scan_lines * self.n_regions * self.max_less_sharp, 8)

    @property
    def flat_cap(self) -> int:
        return _round_up(self.scan_lines * self.n_regions * self.max_flat, 8)

    @property
    def region_cap(self) -> int:
        # max points per (ring, region): ceil(ring_cap / n_regions), padded
        return _round_up(-(-self.ring_cap // self.n_regions) + 1, 8)

    @property
    def knn_radius(self) -> float:
        return self.map_knn_gate_sq ** 0.5

    def replace(self, **kw) -> "AloamConfig":
        return dataclasses.replace(self, **kw)


# Per-sensor presets mirroring the three launch files
# (launch/aloam_velodyne_{VLP_16,HDL_32,HDL_64}.launch).
PRESETS: dict[str, AloamConfig] = {
    "VLP-16": AloamConfig(
        scan_lines=16, minimum_range=0.3,
        line_resolution=0.2, plane_resolution=0.4,
        n_raw=32768, ring_cap=2048, less_flat_cap=16384,
    ),
    "HDL-32": AloamConfig(
        scan_lines=32, minimum_range=0.3,
        line_resolution=0.2, plane_resolution=0.4,
        n_raw=65536, ring_cap=2560, less_flat_cap=32768,
    ),
    "HDL-64": AloamConfig(
        scan_lines=64, minimum_range=5.0,
        line_resolution=0.4, plane_resolution=0.8,
        # less_flat_cap derivation: the cap must hold ANY scene the PRESET
        # serves (the reference's static 400k arrays never drop points,
        # scanRegistration.cpp:66-69).  Worst case observed across repo
        # scenes is the frontend golden scene (seed 3, 1200 azimuth):
        # 36864 drops 2 points there; 40960 = 64 rings x 640 passes every
        # scene with headroom and is the round-3 value.  The bench scene's
        # tighter measured occupancy (30536 at B=16) belongs in
        # bench.batched_bench_cfg(), NOT here — bench-scene sizing leaking
        # into the PRESET broke the golden suite in round 4.
        n_raw=131072, ring_cap=2560, less_flat_cap=40960,
    ),
}
