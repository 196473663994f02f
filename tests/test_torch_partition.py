"""The map tables partitioned over their bucket axis
(``ops/gridmap.TableShard``) in one process, and the census helpers
against the JAX package.

n ranks are simulated by looping over the parts of a table, each with a
TableShard whose group is None: a function then returns its part's own
partial counts and rows, which the tests sum by hand as the group's
``all_reduce`` would. The parts' tables, joined on the bucket axis, must
equal the whole table's bit for bit, and every count summed over the
parts the whole's. The step over real gloo ranks is in
tests/test_torch_parallel.py.

Census helpers: n_valid, count_near, count_near_b and invalidate_outside
exact against JAX's on the same grid (as tests/test_mapping.py:54-130
holds them), single-stream and batched.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aloam_tpu.ops import gridmap as jgrid
from aloam_tpu_torch.ops import gather as gather_op
from aloam_tpu_torch.ops import gridmap
from aloam_tpu_torch.ops.gridmap import TableShard

torch.set_num_threads(1)

H, BK, B = 64, 8, 3         # a small table: many buckets on every part
CELL, LEAF = 2.0, 0.4
WINDOW = torch.tensor([50, 50, 50], dtype=torch.int32)


def _points(seed: int, n: int = 600, spread: float = 40.0):
    """(B, n, 3) points, (B, n) intensities and mask (10% masked out)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-spread / 2, spread / 2, size=(B, n, 3))
    inten = rng.uniform(0, 100, size=(B, n))
    mask = rng.random((B, n)) > 0.1
    return (torch.from_numpy(pts.astype(np.float32)),
            torch.from_numpy(inten.astype(np.float32)),
            torch.from_numpy(mask))


def _parts(grid: gridmap.GridMap, n: int):
    """The n parts of a whole table, copied."""
    h = grid.pts.shape[1] // n
    return [gridmap.GridMap(*(t[:, r * h:(r + 1) * h].clone() for t in grid))
            for r in range(n)]


def _joined(parts) -> gridmap.GridMap:
    return gridmap.GridMap(*(torch.cat(ts, dim=1) for ts in zip(*parts)))


def _grid_equal(got: gridmap.GridMap, want: gridmap.GridMap):
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _map(seed: int = 0) -> gridmap.GridMap:
    """A whole (B, H, ·) table after two inserts (merges, appends and
    evictions on the second)."""
    g = gridmap.empty(B, H, BK)
    center = torch.zeros((B, 3), dtype=torch.int32)
    for s in (seed, seed + 1):
        pts, inten, mask = _points(s)
        g = gridmap.insert_b(g, pts, inten, mask, LEAF, CELL, center, WINDOW,
                             8, 4096)[0]
    return g


# ---- the owned run of the insert's rows --------------------------------

def test_owned_run_moves_the_owned_rows_to_the_front():
    """Rows of 8 a part, part 1 owning buckets [8, 16): stream 0's owned
    run starts at row 2 and moves to rows 0-1, local; stream 1 owns no
    row and gets no used row; stream 2's run starts at row 0. The lists
    follow their rows; every row past the run is unused with slot 0."""
    cap_c, cap_p = 6, 3
    buckets = [[1, 5, 9, 12, 17], [0, 3], [8, 15, 16]]
    slot_h = torch.zeros((3, cap_c), dtype=torch.int32)
    cnt = torch.zeros((3, cap_c), dtype=torch.int32)
    for b, hs in enumerate(buckets):
        slot_h[b, :len(hs)] = torch.tensor(hs)
        cnt[b, :len(hs)] = torch.arange(1, len(hs) + 1)
    pl = torch.arange(3 * cap_c * cap_p, dtype=torch.float32).view(
        3, cap_c, cap_p)
    s, c, p = gridmap._owned_run(slot_h, cnt, (pl,), 8, 1)
    assert s.tolist() == [[1, 4, 0, 0, 0, 0], [0] * 6, [0, 7, 0, 0, 0, 0]]
    assert c.tolist() == [[3, 4, 0, 0, 0, 0], [0] * 6, [1, 2, 0, 0, 0, 0]]
    assert s.dtype == c.dtype == torch.int32
    assert torch.equal(p[0, :2], pl[0, 2:4])
    assert torch.equal(p[2, :2], pl[2, :2])
    # part 0 owns stream 0's first two rows and stream 1's both, in place
    s0, c0, _ = gridmap._owned_run(slot_h, cnt, (pl,), 8, 0)
    assert s0.tolist()[:2] == [[1, 5, 0, 0, 0, 0], [0, 3, 0, 0, 0, 0]]
    assert c0.tolist()[:2] == [[1, 2, 0, 0, 0, 0], [1, 2, 0, 0, 0, 0]]


# ---- the insert, the evict, the knn cache ------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["all_rows", "touched_cap_cut",
                                  "fused_downsample"])
def test_partitioned_insert_matches_whole(n, case):
    """insert_b (or insert_vds_b) into every part of a populated table:
    the parts joined equal the whole-table insert bit for bit (the plain
    merge_rows on each part's owned rows), and merged / appended /
    evicted summed over the parts equal the whole's. With touched_cap 12
    (of ~60 touched buckets a stream) the cut on the whole sorted list
    drops the same points on every part: the sums still match and the
    whole drops points."""
    whole = _map()
    # half the points in voxels of the map (merges), half new
    pts, inten, mask = (torch.cat([a[:, :300], b[:, 300:]], dim=1)
                        for a, b in zip(_points(1), _points(7)))
    center = torch.tensor([[0, 0, 0], [3, -2, 1], [-40, 0, 0]],
                          dtype=torch.int32)
    cap = 12 if case == "touched_cap_cut" else 4096
    insert = gridmap.insert_vds_b if case == "fused_downsample" \
        else gridmap.insert_b
    parts = _parts(whole, n)
    want = insert(whole, pts, inten, mask, LEAF, CELL, center, WINDOW, 8,
                  cap)
    got = [insert(g, pts, inten, mask, LEAF, CELL, center, WINDOW, 8, cap,
                  shard=TableShard(None, r, n))
           for r, g in enumerate(parts)]
    _grid_equal(_joined([g[0] for g in got]), want[0])
    sums = [sum(g[i] for g in got) for i in (1, 2, 3)]
    for name, s, w in zip(("merged", "appended", "evicted"), sums, want[1:4]):
        assert torch.equal(s, w), name
    total = want[4] + want[1] + want[2]
    assert torch.equal(total - sums[0] - sums[1], want[4])
    assert (want[1] > 0).all() and (want[2] > 0).all()
    if case == "touched_cap_cut":
        assert (want[4] > 0).all()
    else:
        assert (want[3] > 0).any()


def test_hash_at_a_part_boundary_goes_to_its_owner():
    """Points whose cells hash to the last row of part 0 and the first row
    of part 1 (global buckets H/2 - 1 and H/2 of 2 parts) land in part 0's
    local row H/2 - 1 and part 1's local row 0, and nowhere else; the
    exchange of the knn cache reads each row from its owner alone."""
    n, h = 2, H // 2
    cells = np.stack(np.meshgrid(*[np.arange(-8, 8)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    hh = gridmap._hash(torch.from_numpy(cells.astype(np.int32)), H).numpy()
    picks = [cells[np.flatnonzero(hh == t)[0]] for t in (h - 1, h)]
    pts = torch.from_numpy((np.stack(picks) * CELL + 0.5).astype(
        np.float32))[None].expand(B, 2, 3).contiguous()
    inten = torch.ones((B, 2))
    mask = torch.ones((B, 2), dtype=torch.bool)
    center = torch.zeros((B, 3), dtype=torch.int32)
    parts = [gridmap.empty(B, h, BK) for _ in range(n)]
    for r, g in enumerate(parts):
        _, merged, appended, *_ = gridmap.insert_b(
            g, pts, inten, mask, LEAF, CELL, center, WINDOW, 8, 4096,
            shard=TableShard(None, r, n))
        assert merged.tolist() == [0] * B and appended.tolist() == [1] * B
    live = [(g._auxv()[:, :, 1, :] != gridmap._EMPTY).sum(-1)
            for g in parts]                                   # (B, h)
    assert live[0][:, h - 1].tolist() == [1] * B
    assert live[1][:, 0].tolist() == [1] * B
    assert int(live[0].sum() + live[1].sum()) == 2 * B
    assert torch.equal(parts[0].pts[:, h - 1, 0], pts[:, 0, 0])
    assert torch.equal(parts[1].pts[:, 0, 0], pts[:, 1, 0])
    rows = torch.tensor([[h - 1, h]]).expand(B, 2)
    got = [gridmap._owned_rows(g.pts, rows, TableShard(None, r, n))
           for r, g in enumerate(parts)]
    assert torch.equal(got[0][:, 0], parts[0].pts[:, h - 1])
    assert torch.equal(got[1][:, 1], parts[1].pts[:, 0])
    assert not got[0][:, 1].any() and not got[1][:, 0].any()


@pytest.mark.parametrize("n", [2, 4])
def test_owned_rows_exchange_is_the_whole_gather(n):
    """_owned_rows on every part (each gathers its own rows and zeroes
    the rest), summed over the parts as int32, is the gather from the
    whole table bit for bit, -0.0 and the empty-slot sentinel
    included."""
    whole = _map()
    whole.pts[0, 3, :4] = -0.0
    rows = torch.randint(0, H, (B, 50, 8), generator=torch.Generator()
                         .manual_seed(0))
    rows[0, 0, :] = 3
    want = gather_op.bgather(whole.pts, rows)
    got = sum(gridmap._owned_rows(g.pts, rows, TableShard(None, r, n))
              .view(torch.int32) for r, g in enumerate(_parts(whole, n)))
    assert torch.equal(got, want.view(torch.int32))


@pytest.mark.parametrize("n", [2, 4])
def test_partitioned_knn_cache_matches_whole(n):
    """knn_cache_b on every part, its candidate rows summed over the parts
    as int32 (the group's all_reduce), equals the whole-table cache where
    a row is read once; a bucket that two cells of a block share is
    poisoned at the _FAR sentinel on every part after the sum, as on the
    whole. The cell slots, sorted payloads and spill counts are the
    whole's on every part."""
    whole = _map()
    pts, inten, _ = _points(3, n=400)
    want, (wpay,) = gridmap.knn_cache_b(whole, pts, CELL, 1.0, 96,
                                        payloads=(inten,))
    caches = [gridmap.knn_cache_b(g, pts, CELL, 1.0, 96, payloads=(inten,),
                                  shard=TableShard(None, r, n))
              for r, g in enumerate(_parts(whole, n))]
    bits = torch.stack([c.cand_flat.view(torch.int32) for c, _ in caches])
    far = torch.tensor(gridmap._FAR, dtype=torch.float32).view(torch.int32)
    bk3 = 3 * BK
    blocks = bits.view(n, B, -1, 8, bk3)
    poisoned = (blocks == far).all(dim=-1).all(dim=0)       # (B, C+P, 8)
    got = torch.where(poisoned[..., None], far, blocks.sum(dim=0))
    assert torch.equal(got.view(want.cand_flat.shape),
                       want.cand_flat.view(torch.int32))
    assert poisoned.any()
    for c, (pay,) in caches:
        for name in ("cid", "cid_sorted", "n_spilled"):
            assert torch.equal(getattr(c, name), getattr(want, name)), name
        assert torch.equal(pay, wpay)
    assert (want.n_spilled > 0).any()


@pytest.mark.parametrize("evict", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_partitioned_evict_and_count_matches_whole(n, evict):
    """evict_and_count on every part: each clears its own rows (joined,
    the whole's clear bit for bit) and the cleared and census counts
    summed over the parts are the whole's."""
    whole = _map()
    center = torch.tensor([[1, 0, 0], [3, -1, 0], [-2, 1, 1]],
                          dtype=torch.int32)
    window = torch.tensor([4, 3, 2], dtype=torch.int32)
    local = torch.tensor([2, 2, 1], dtype=torch.int32)
    parts = _parts(whole, n)
    want = gridmap.evict_and_count(whole, center, window, local, evict)
    got = [gridmap.evict_and_count(g, center, window, local, evict,
                                   TableShard(None, r, n))
           for r, g in enumerate(parts)]
    _grid_equal(_joined([g[0] for g in got]), want[0])
    for i in (1, 2):
        assert torch.equal(sum(g[i] for g in got), want[i])
    assert (want[2] > 0).all()
    assert (want[1] > 0).all() == evict


# ---- the census helpers --------------------------------------------------

def _jax_grid(pts):
    """tests/test_mapping.py's ``_grid``: a (4096, 64) JAX table of the
    points, inserted with JAX's single-stream insert."""
    g = jgrid.empty(4096, 64)
    n = pts.shape[0]
    g, _, _, _, dropped = jgrid.insert(
        g, jnp.asarray(pts), jnp.zeros(n, jnp.float32), jnp.ones(n, bool),
        1e-3, CELL, jnp.zeros(3, jnp.int32), jnp.asarray([500] * 3,
                                                         jnp.int32))
    assert int(dropped) == 0
    return g


def _grid_t(g) -> gridmap.GridMap:
    return gridmap.GridMap(*(torch.from_numpy(np.array(t)) for t in g))


def _census_points(rng):
    return np.concatenate([rng.uniform(-5, 5, size=(30, 3)),      # inside
                           rng.uniform(30, 40, size=(20, 3))]     # outside
                          ).astype(np.float32)


def test_census_helpers_match_jax(rng):
    """n_valid, count_near and invalidate_outside on one stream's table,
    count_near_b and invalidate_outside on a batch of two (stream 1
    centred on the far cluster), against JAX's on the same grid: counts
    exact, the cleared tables bit for bit (tests/test_mapping.py's
    test_invalidate_outside_clears_exactly and
    test_evict_and_count_matches_separate_passes)."""
    jg = _jax_grid(_census_points(rng))
    half = np.array([3, 3, 3], np.int32)
    local = np.array([2, 2, 2], np.int32)
    th, tl = torch.from_numpy(half), torch.from_numpy(local)
    c0 = np.zeros(3, np.int32)
    assert int(gridmap.n_valid(_grid_t(jg))) == int(jgrid.n_valid(jg)) == 50
    assert int(gridmap.count_near(_grid_t(jg), torch.from_numpy(c0), tl)) \
        == int(jgrid.count_near(jg, jnp.asarray(c0), jnp.asarray(local)))
    want, wn = jgrid.invalidate_outside(jg, jnp.asarray(c0),
                                        jnp.asarray(half))
    got, n = gridmap.invalidate_outside(_grid_t(jg), torch.from_numpy(c0),
                                        th)
    assert int(n) == int(wn) == 20
    _grid_equal(got, _grid_t(want))
    assert int(gridmap.n_valid(got)) == 30

    jb = jgrid.GridMap(*(jnp.stack([a, a]) for a in jg))
    centers = np.array([[0, 0, 0], [17, 17, 17]], np.int32)
    tc = torch.from_numpy(centers)
    near = gridmap.count_near_b(_grid_t(jb), tc, tl)
    assert near.shape == (2,)
    np.testing.assert_array_equal(near.numpy(), np.asarray(
        jgrid.count_near_b(jb, jnp.asarray(centers), jnp.asarray(local))))
    want, wn = jgrid.invalidate_outside(jb, jnp.asarray(centers),
                                        jnp.asarray(half))
    got, n = gridmap.invalidate_outside(_grid_t(jb), tc, th)
    assert n.tolist() == np.asarray(wn).tolist() == [20, 30]
    _grid_equal(got, _grid_t(want))


@pytest.mark.parametrize("helper", ["count_near", "count_near_b",
                                    "invalidate_outside"])
def test_census_helpers_are_one_window_pass(monkeypatch, helper):
    """Each census helper is one call of ``ops/evict.evict_and_count``
    (the window kernel on a CUDA table), with ``evict`` off for the counts
    and on for the clear: a counting wrapper sees one call, and the
    results (the cleared table too) equal the unwrapped helper's on a
    copy of the table. count_near runs on one stream's (H, ·) table."""
    from aloam_tpu_torch.ops import evict as evict_op
    grid = _map()
    center = torch.tensor([[0, 0, 0], [2, 2, 0], [-3, 1, 1]],
                          dtype=torch.int32)
    half = torch.tensor([3, 3, 2], dtype=torch.int32)
    if helper == "count_near":
        grid, center = gridmap.GridMap(*(t[0].clone() for t in grid)), \
            center[0]
    fn = getattr(gridmap, helper)
    want = fn(gridmap.GridMap(*(t.clone() for t in grid)), center, half)
    calls, real = [], evict_op.evict_and_count

    def counted(*args):
        calls.append(args[-1])
        return real(*args)
    monkeypatch.setattr(evict_op, "evict_and_count", counted)
    got = fn(grid, center, half)
    assert calls == [helper == "invalidate_outside"]
    if helper == "invalidate_outside":
        _grid_equal(got[0], want[0])
        got, want = got[1], want[1]
    assert got.shape == want.shape and torch.equal(got, want)
    assert (want > 0).all()


@pytest.mark.parametrize("n", [2, 4])
def test_partitioned_census_sums_to_whole(n):
    """n_valid, count_near_b and invalidate_outside on every part: the
    live entries, the census and the cleared counts summed over the parts
    equal the whole table's, and the parts' clears joined are the
    whole's."""
    whole = _map()
    center = torch.tensor([[0, 0, 0], [2, 2, 0], [-3, 1, 1]],
                          dtype=torch.int32)
    half = torch.tensor([3, 3, 2], dtype=torch.int32)
    parts = _parts(whole, n)
    shards = [TableShard(None, r, n) for r in range(n)]
    assert int(sum(gridmap.n_valid(g, s) for g, s in zip(parts, shards))) \
        == int(gridmap.n_valid(whole)) > 0
    assert torch.equal(
        sum(gridmap.count_near_b(g, center, half, s)
            for g, s in zip(parts, shards)),
        gridmap.count_near_b(whole, center, half))
    want, wn = gridmap.invalidate_outside(whole, center, half)
    got = [gridmap.invalidate_outside(g, center, half, s)
           for g, s in zip(parts, shards)]
    assert torch.equal(sum(n_ for _, n_ in got), wn) and (wn > 0).all()
    _grid_equal(_joined([g for g, _ in got]), want)
