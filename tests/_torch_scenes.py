"""Seeded scenes for the port's kernel tests (numpy only)."""

import numpy as np


def segmented_reference(rng, bsz: int, rings: int, seg: int, pad: int,
                        fill: float = 0.8):
    """A ring-segmented odometry reference in the frontend's ring_heads
    layout, planar and poisoned as window_mins takes it: (B, 4, M) f32
    [x | y | z | ring], M = rings·seg + pad; ring r's valid points first
    in rows [r·seg, (r+1)·seg), on a cone at height 0.4 r - 12.8 around
    the sensor; padding at 1e9."""
    m = rings * seg + pad
    ref = np.full((bsz, 4, m), 1e9, np.float32)
    for b in range(bsz):
        for r in range(rings):
            cnt = int(seg * fill) - int(rng.integers(0, 8))
            th = rng.uniform(-np.pi, np.pi, cnt)
            rad = rng.uniform(6, 40, cnt)
            rows = slice(r * seg, r * seg + cnt)
            ref[b, 0, rows] = rad * np.cos(th)
            ref[b, 1, rows] = rad * np.sin(th)
            ref[b, 2, rows] = 0.4 * r - 12.8 + rng.normal(0, 0.02, cnt)
            ref[b, 3, rows] = r
    return ref


def queries_near(rng, ref, q: int, rings=None):
    """(B, Q, 3) f32 queries 0.3 m off valid reference points (of the
    given rings only, if any)."""
    sel = np.zeros((ref.shape[0], q, 3), np.float32)
    for b in range(ref.shape[0]):
        ok = ref[b, 3] < 1e8
        if rings is not None:
            ok &= np.isin(ref[b, 3], rings)
        pick = rng.choice(np.flatnonzero(ok), q)
        sel[b] = ref[b, :3, pick] + rng.normal(0, 0.3, (q, 3))
    return sel


SELECT_CASES = ("ring_rows", "ties_above", "ties_below", "all_above",
                "all_below", "nonfinite", "whole_row", "disabled",
                "bcum_every", "bcum_never", "region_edges")


def region_windows(cnt, n_regions: int = 6):
    """(sp, ep) (R, n_regions) of the frontend's region windows for ring
    fills cnt (R,): sp_j = 5 + (cnt-11)·j // n, ep_j = 5 + (cnt-11)·(j+1)
    // n - 1; ep = -1 on a ring too short to select from."""
    base = np.asarray(cnt, np.int64)[:, None] - 11
    j = np.arange(n_regions)
    sp = 5 + base * j // n_regions
    ep = np.where(base >= n_regions, 5 + base * (j + 1) // n_regions - 1, -1)
    return sp, ep


def select_case(rng, case: str, rows: int, c: int, n_regions: int = 6):
    """select_rings inputs that press on one rule of the walk: (curv (R, C)
    f32, bcum (R, C) i32, spep (R, 2·n_regions) f32, cnt) where cnt (R,)
    is each row's fill when the windows are the frontend's
    (region_windows), else None. The threshold is 0.1. Cases: ring-like random rows; all
    ties above and below the threshold; every point above, every point
    below; ±inf and NaN; one region over the whole row; disabled regions
    (ep = -1, and sp > ep); bcum stepping at every column, and never;
    peaks at region edges whose marks cross into the next region."""
    cnt = rng.integers(c // 2, c + 1, rows)
    cnt[0] = c
    sp, ep = region_windows(cnt, n_regions)
    curv = rng.uniform(0, 0.4, (rows, c))
    curv[:, 40:44] = 0.3                         # exact ties
    steps = rng.uniform(size=(rows, c - 1)) < 0.07
    bcum = np.concatenate([np.zeros((rows, 1), np.int64),
                           np.cumsum(steps, axis=1)], axis=1)
    standard = True
    if case == "ties_above":
        curv[:] = 0.3
    elif case == "ties_below":
        curv[:] = 0.05
    elif case == "all_above":
        curv = rng.uniform(0.2, 1.0, (rows, c))
    elif case == "all_below":
        curv = rng.uniform(0.0, 0.09, (rows, c))
    elif case == "nonfinite":
        # NaN anywhere; one +inf (no corner pick) or one -inf (no flat
        # pick) in two of every three windows
        curv[rng.uniform(size=(rows, c)) < 0.1] = np.nan
        for r, j in zip(*np.nonzero(ep >= sp)):
            k = rng.integers(sp[r, j], ep[r, j] + 1)
            curv[r, k] = (np.inf, -np.inf, curv[r, k])[(r + j) % 3]
    elif case == "whole_row":
        sp[:], ep[:] = 0, -1
        ep[:, 0] = c - 1
        standard = False
    elif case == "disabled":
        ep[:, ::2] = -1
        sp[:, 1] = ep[:, 1] + 3
        standard = False
    elif case == "bcum_every":
        bcum = np.broadcast_to(np.arange(c), (rows, c))
    elif case == "bcum_never":
        bcum = np.zeros((rows, c), np.int64)
    elif case == "region_edges":
        curv = rng.uniform(0.0, 0.2, (rows, c))
        for j in range(n_regions):
            for r in np.flatnonzero(ep[:, j] >= 0):
                e = ep[r, j]
                curv[r, e] = 0.9                 # the last column's pick
                curv[r, e - 1] = 0.8
                curv[r, e + 1:min(e + 4, c)] = 0.85  # marked from region j
                curv[r, sp[r, j]] = 0.0          # a flat pick at the start
    elif case != "ring_rows":
        raise ValueError(case)
    spep = np.concatenate([sp, ep], axis=1).astype(np.float32)
    return (curv.astype(np.float32), np.ascontiguousarray(bcum, np.int32),
            spep, cnt if standard else None)


MERGE_CASES = ("random", "all_unused", "all_merge", "evictions",
               "prio_ties", "cnt_over_cap")
_EMPTY = 32767


def _vox_hash(p, leaf: float):
    v = np.floor(p / leaf).astype(np.int64)
    h = (v[..., 0, :] * 73856093) ^ (v[..., 1, :] * 19349663) \
        ^ (v[..., 2, :] * 83492791)
    return (h & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def merge_case(rng, case: str, bsz: int = 2, h: int = 512, cap_c: int = 64,
               cap_p: int = 16, bk: int = 48, cell: float = 2.0,
               leaf: float = 0.4):
    """merge_rows inputs, numpy: (pts (B, H, 3·bk) f32, aux (B, H, 5·bk)
    i32, slot_h (B, C) i32, cnt (B, C) i32, px, py, pz, pi (B, C, P) f32,
    pvox (B, C, P) i32, center (B, 3) i32, window (3,) i32). Each stream
    uses a prefix of its rows (the last stream none), each used row its
    own bucket; unused rows name bucket 0, as gridmap builds them. Cases:
    random tables and points (a third of them merging); no row used; every
    point merging; full rows in the window and rows half out of it with
    more points than empty slots (evictions in both priority classes);
    rows whose slots all share one cell (priority ties); cnt above the
    point cap."""
    window = np.array([5, 5, 3], np.int32)
    center = rng.integers(-4, 4, (bsz, 3)).astype(np.int32)
    occ_p = 0.97 if case in ("evictions", "prio_ties") else 0.6
    occ = rng.uniform(size=(bsz, h, bk)) < occ_p
    spread = 14.0 if case == "evictions" else 40.0
    p = (center[:, None, :, None] * cell + rng.uniform(
        -spread, spread, (bsz, h, 3, bk))).astype(np.float32)
    if case == "evictions":      # every other row wholly inside the window
        p[:, ::2] = (center[:, None, :, None] * cell
                     + rng.uniform(-8, 8, (bsz, h // 2, 3, bk))
                     * np.array([1, 1, 0.5])[:, None]).astype(np.float32)
    if case == "prio_ties":      # one cell a row: one priority a row
        p = (np.floor(p[..., :1] / cell) * cell + rng.uniform(
            0.1, 1.9, (bsz, h, 3, bk))).astype(np.float32)
    cells = np.where(occ[:, :, None], np.floor(p / cell), _EMPTY)
    vox = np.where(occ, _vox_hash(p, leaf), 0)
    pts = np.where(occ[:, :, None], p, 1e9).astype(np.float32)
    inten = np.where(occ, rng.uniform(0, 1, (bsz, h, bk)), 0.0)
    aux = np.concatenate([inten.astype(np.float32).view(np.int32)[:, :, None],
                          cells.astype(np.int32), vox[:, :, None]], axis=2)

    n_used = rng.integers(cap_c // 2, cap_c + 1, bsz)
    n_used[-1] = 0
    if case == "all_unused":
        n_used[:] = 0
    slot_h = np.zeros((bsz, cap_c), np.int32)
    cnt = np.zeros((bsz, cap_c), np.int32)
    for b in range(bsz):
        u = n_used[b]
        slot_h[b, :u] = rng.choice(h, u, replace=False)
        cnt[b, :u] = rng.integers(1, cap_p + 1, u)
        if case in ("evictions", "prio_ties"):
            cnt[b, :u] = cap_p
        if case == "cnt_over_cap":
            cnt[b, :u] = cap_p + rng.integers(0, 9, u)
    q = rng.uniform(-40, 40, (3, bsz, cap_c, cap_p)).astype(np.float32)
    qi = rng.uniform(0, 1, (bsz, cap_c, cap_p)).astype(np.float32)
    pvox = _vox_hash(np.moveaxis(q, 0, -2), leaf)
    row_vox = np.take_along_axis(vox, slot_h[..., None].astype(np.int64), 1)
    row_occ = np.take_along_axis(occ, slot_h[..., None].astype(np.int64), 1)
    share = {"random": 0.3, "all_merge": 1.0}.get(case, 0.0)
    pick = rng.integers(0, bk, (bsz, cap_c, cap_p))
    if case == "all_merge":      # each point names an occupied slot's voxel
        for b in range(bsz):
            for r in range(cap_c):
                live = np.flatnonzero(row_occ[b, r])
                pick[b, r] = rng.choice(live, cap_p)
    merge = rng.uniform(size=(bsz, cap_c, cap_p)) < share
    pvox = np.where(merge, np.take_along_axis(row_vox, pick, 2), pvox)
    return (pts.reshape(bsz, h, 3 * bk), aux.reshape(bsz, h, 5 * bk),
            slot_h, cnt, q[0], q[1], q[2], qi, pvox.astype(np.int32), center,
            window)


KNN_CASES = ("random", "tiny_table", "empty", "few", "ties", "negative",
             "boundaries", "far", "single")
_P = (73856093, 19349663, 83492791)
OFFSETS8 = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                    -1).reshape(8, 3).astype(np.int32)


def cell_hash(cells, table_size: int):
    """The map's spatial hash in 32-bit unsigned arithmetic, as the knn
    kernel computes it: (cx·P1) ^ (cy·P2) ^ (cz·P3) mod 2^32, masked to the
    table (table_size a power of two; 0 keeps all 32 bits). cells (..., 3)
    int32; returns uint32."""
    u = np.asarray(cells, np.int32).astype(np.uint32)
    h = (u[..., 0] * np.uint32(_P[0])) ^ (u[..., 1] * np.uint32(_P[1])) \
        ^ (u[..., 2] * np.uint32(_P[2]))
    return h & np.uint32(table_size - 1) if table_size else h


def grid_table(pts, table_size: int, bk: int, cell: float = 2.0):
    """A single-stream map table (table_size, 3·bk) f32, bucket-planar
    [x | y | z], holding ``pts`` (N, 3) f32 in their cells' buckets in
    order (a full bucket drops the rest); empty slots at 1e9 (_FAR)."""
    table = np.full((table_size, 3, bk), 1e9, np.float32)
    fill = np.zeros(table_size, np.int64)
    cells = np.floor(pts / np.float32(cell)).astype(np.int32)
    for p, b in zip(pts, cell_hash(cells, table_size)):
        if fill[b] < bk:
            table[b, :, fill[b]] = p
            fill[b] += 1
    return table.reshape(table_size, 3 * bk)


def knn_case(rng, case: str, bk: int):
    """gridmap.knn inputs that press on one rule of the table search:
    (table (H, 3·bk) f32, queries (Q, 3) f32); cell 2 m, radius 1 m. Cases:
    random points and queries near them (Q = 1001, not a multiple of a
    block's queries); H = 8, so a block's cells share buckets; an empty
    table (every slot at _FAR); 40 points over 400 m (fewer than 5 real
    candidates, ties among the _FAR slots); points repeated in their
    bucket and queries on points (equal distances); only negative
    coordinates; queries exactly on cell boundaries (q - radius a multiple
    of the cell); clusters near ±1e5 m (the 32-bit hash wraps); Q = 1."""
    h, q_n = 4096, 1001
    if case == "tiny_table":
        h = 8
    pts = rng.uniform((-30, -30, -5), (30, 30, 5), (6000, 3))
    if case == "empty":
        pts = pts[:0]
    elif case == "few":
        pts = rng.uniform(-200, 200, (40, 3))
    elif case == "ties":
        pts = np.repeat(rng.uniform(-8, 8, (1500, 3)), 3, axis=0)
    elif case == "negative":
        pts = rng.uniform(-60, -1, (6000, 3))
    elif case == "far":
        signs = rng.choice([-1.0, 1.0], (6000, 3))
        pts = 1e5 * signs + rng.uniform(-10, 10, (6000, 3))
    elif case not in ("random", "tiny_table", "boundaries", "single"):
        raise ValueError(case)
    pts = pts.astype(np.float32)
    if len(pts):
        q = pts[rng.integers(0, len(pts), q_n)] + rng.normal(0, 0.5, (q_n, 3))
    else:
        q = rng.uniform(-30, 30, (q_n, 3))
    if case == "ties":
        q[::3] = pts[rng.integers(0, len(pts), len(q[::3]))]
    elif case == "boundaries":
        q = 2.0 * rng.integers(-15, 15, (q_n, 3)) + 1.0
    elif case == "single":
        q = q[:1]
    return grid_table(pts, h, bk), q.astype(np.float32)


def evict_table(rng, center, window, local, h: int, bk: int,
                rows_used: float = 1.0, fill: float = 0.5,
                edges: bool = True):
    """A map table for the window pass, numpy: (pts (B, H, 3·bk) f32, aux
    (B, H, 5·bk) i32), B = len(center), H >= 3. A share ``rows_used`` of
    each stream's rows holds live slots, each live with probability
    ``fill``, its cell drawn from center ± (window + 2), or center ±
    window without ``edges`` (then none is out of the window). With
    ``edges``: row 0 is empty; row 1 is full, its first slots on the edges
    (one axis at ± local, ± (local + 1), ± window, ± (window + 1), the
    others at the center); row 2 is full of cells at the int32 extremes,
    where the difference to the center wraps. Live slots carry random
    points, intensity bits and voxel ids; empty ones the table's sentinels
    (_EMPTY cells, 1e9 points)."""
    center = np.asarray(center, np.int64)
    window, local = np.asarray(window), np.asarray(local)
    bsz = len(center)
    live = rng.random((bsz, h, bk), np.float32) < fill
    live &= (rng.random((bsz, h, 1), np.float32) < rows_used)
    span = window + 2 if edges else window
    cells = np.stack([(center[:, a, None, None] + rng.integers(
        -span[a], span[a] + 1, (bsz, h, bk))).astype(np.int32)
        for a in range(3)], axis=2)                       # (B, H, 3, bk)
    if edges:
        live[:, 0], live[:, 1:3] = False, True
        on = [np.eye(3, dtype=np.int64)[a] * s * off
              for a in range(3)
              for off in (local[a], local[a] + 1, window[a], window[a] + 1)
              for s in (1, -1)]
        n = min(len(on), bk)
        cells[:, 1, :, :n] = (center[:, :, None]
                              + np.stack(on[:n], axis=1)).astype(np.int32)
        extremes = np.array([-2 ** 31, 2 ** 31 - 1, -2 ** 31 + 1,
                             2 ** 31 - 2], np.int32)
        cells[:, 2] = extremes[rng.integers(0, 4, (bsz, 3, bk))]
    aux = np.empty((bsz, h, 5, bk), np.int32)
    aux[:, :, 0] = np.where(live, rng.random((bsz, h, bk), np.float32),
                            0).astype(np.float32).view(np.int32)
    aux[:, :, 1:4] = np.where(live[:, :, None], cells, _EMPTY)
    aux[:, :, 4] = np.where(live, rng.integers(-2 ** 31, 2 ** 31 - 1,
                                               (bsz, h, bk)), 0)
    pts = np.where(live[:, :, None], rng.uniform(
        -500, 500, (bsz, h, 3, bk)), 1e9).astype(np.float32)
    return pts.reshape(bsz, h, 3 * bk), aux.reshape(bsz, h, 5 * bk)


# the special rings of ring_rows, in the order they take a stream's rings
RING_SPECIALS = ("empty", "cnt16", "cnt17", "full", "one_voxel", "spread")


def ring_rows(rng, streams: int, rings: int, c: int, leaf: float = 0.2,
              specials: bool = True):
    """Ring rows as registration leaves them, for the feature stage:
    (xyz (B·R, C, 3) f32, intensity (B·R, C) f32, cnt (B·R,) i32), slots
    past cnt zero. Each ring sweeps a street canyon (walls 8 m either
    side, ground 1.73 m below, returns past 80 m dropped) at an elevation
    from +2 to -24.9 degrees, 1 cm of noise, its count drawn from [C/2,
    C]; intensity is ring + 0.1 · the slot's share of the sweep. With
    ``specials`` each stream's rings begin, from ring b mod R on, with
    RING_SPECIALS: an empty ring, 16 points (no regions), 17 (the least
    with regions), a full ring, C/8 points in one voxel of ``leaf`` near
    the origin, and C/2 points a leaf and a half apart (a voxel each)."""
    xyz = np.zeros((streams, rings, c, 3), np.float32)
    ins = np.zeros((streams, rings, c), np.float32)
    cnt = rng.integers(c // 2, c + 1, (streams, rings))
    for b in range(streams):
        kinds = {(b + k) % rings: kind
                 for k, kind in enumerate(RING_SPECIALS[:rings])} \
            if specials else {}
        for r in range(rings):
            kind = kinds.get(r, "street")
            n = dict(empty=0, cnt16=16, cnt17=17, full=c, one_voxel=c // 8,
                     spread=c // 2).get(kind, int(cnt[b, r]))
            cnt[b, r] = n
            j = np.arange(n)
            if kind == "one_voxel":
                pts = (np.array([2, 1, 0]) + 0.25
                       + 0.5 * rng.random((n, 3))) * leaf
            elif kind == "spread":
                pts = np.stack([5.0 + 1.5 * leaf * j, 3.0 + 0 * j,
                                -1.0 + 0 * j], -1)
            else:
                el = np.deg2rad(2.0 - 26.9 * r / max(rings - 1, 1))
                th = 2 * np.pi * (j + rng.random()) / max(n, 1)
                d = np.stack([np.cos(th) * np.cos(el),
                              np.sin(th) * np.cos(el),
                              np.full(n, np.sin(el))], -1)
                t = np.full(n, 80.0)
                side = np.abs(d[:, 1]) > 1e-6
                t[side] = np.minimum(t[side], 8.0 / np.abs(d[side, 1]))
                if el < 0:
                    t = np.minimum(t, 1.73 / -np.sin(el))
                pts = d * t[:, None] + rng.normal(0, 0.01, (n, 3))
            xyz[b, r, :n] = pts
            ins[b, r, :n] = r + 0.1 * j / max(n, 1)
    return (xyz.reshape(streams * rings, c, 3), ins.reshape(-1, c),
            cnt.reshape(-1).astype(np.int32))


def ring_labels(rng, rows: int, c: int):
    """Labels as the selection leaves them, and past it: (R', C) i32 with
    2, 1 and -1 at a few percent each, more than a ring's slots of each in
    some rows, and labels the walk never gives (5, -3: a rest class and a
    less-flat one)."""
    u = rng.random((rows, c))
    label = np.select([u < 0.01, u < 0.06, u < 0.09, u < 0.095, u < 0.1],
                      [2, 1, -1, 5, -3], 0)
    dense = rng.random(rows) < 0.25
    label[dense] = rng.choice([2, 1, -1, 0], (int(dense.sum()), c))
    return label.astype(np.int32)
