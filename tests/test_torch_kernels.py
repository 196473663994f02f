"""The port's kernel modules (aloam_tpu_torch/ops) against the JAX package.

Each port kernel has a CUDA version (run and checked on the card by
chip_smoke.py) and a plain PyTorch version, which is what a CPU tensor
gets. These tests feed the same numpy inputs, made from a seed, to the
plain version and to the JAX side: the Pallas kernel in interpret mode and
its XLA twin, as tests/test_batched_kernels.py and tests/test_pallas_lm.py
run them. Each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aloam_tpu import geometry as jgeo
from aloam_tpu import solver as jsolver
from aloam_tpu import config as jconfig
from aloam_tpu.frontend import features as jfeat
from aloam_tpu.frontend.voxel import _voxel_core as j_voxel_core
from aloam_tpu.neighbors import odom_window_mins_b as j_window_mins_b
from aloam_tpu.ops import pallas_lm
from aloam_tpu.ops.pallas_odom import window_mins as j_window_mins
from aloam_tpu.ops.pallas_select import select_rings as j_select_rings
from aloam_tpu.ops.pallas_voxel import segmented_prefix_sums as j_seg_sums
from aloam_tpu.utils.batch import bgather as j_bgather
from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import solver
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.frontend import features
from aloam_tpu_torch.frontend.voxel import _voxel_core
from aloam_tpu_torch.neighbors import odom_window_mins_b
from aloam_tpu_torch.ops import assoc as assoc_op
from aloam_tpu_torch.ops import gather as gather_op
from aloam_tpu_torch.ops import insert as insert_op
from aloam_tpu_torch.ops import knn as knn_op
from aloam_tpu_torch.ops import lm as lm_op
from aloam_tpu_torch.ops import odom as odom_op
from aloam_tpu_torch.ops import rings as rings_op
from aloam_tpu_torch.ops import select as select_op
from aloam_tpu_torch.ops import voxel as seg_op
from _torch_scenes import (SELECT_CASES, queries_near, segmented_reference,
                           select_case)

torch.set_num_threads(1)

CFG = AloamConfig(scan_lines=16, minimum_range=0.3, n_raw=4096,
                  ring_cap=256, less_flat_cap=2048)


def _jcfg(cfg):
    """The JAX package's config with the same fields: port functions get
    the port's config, JAX functions the JAX package's."""
    return jconfig.AloamConfig(**dataclasses.asdict(cfg))


JCFG = _jcfg(CFG)


def _t(x):
    return torch.from_numpy(np.array(x))


# --- select_rings ----------------------------------------------------------

def _ring_rows(rng, r=24, c=160):
    """Ring-like rows: arcs with occasional range jumps, so the bad-gap
    prefix stops some NMS windows; degenerate rings (empty, too small,
    minimal, full) lead."""
    th = np.cumsum(rng.uniform(0.001, 0.01, size=(r, c)), axis=1)
    rad = 5.0 + np.where(rng.uniform(size=(r, c)) < 0.07,
                         rng.uniform(1, 4, size=(r, c)), 0.0)
    pts = np.stack([rad * np.cos(th), rad * np.sin(th),
                    0.05 * rng.standard_normal((r, c))], -1).astype(np.float32)
    curv = rng.uniform(0, 0.4, size=(r, c)).astype(np.float32)
    curv[:, 40:44] = 0.3            # exact ties: lowest index must win
    cnt = rng.integers(0, c, size=(r,)).astype(np.int32)
    cnt[:4] = [0, 5, 11, c]
    return pts, curv, cnt


@pytest.mark.parametrize("seed", [0, 1])
def test_select_rings_matches_jax(seed):
    """Labels exact against the JAX XLA walk (features._select_rings) and
    the Pallas kernel in interpret mode."""
    pts, curv, cnt = _ring_rows(np.random.default_rng(seed))
    label_t = features._select_labels(_t(pts), _t(curv), _t(cnt), CFG)

    label_x, _, _ = jfeat._select_rings(jnp.asarray(pts), jnp.asarray(curv),
                                        jnp.asarray(cnt), JCFG)
    np.testing.assert_array_equal(label_t.numpy(),
                                  np.asarray(label_x, np.int32))

    # the kernel's inputs as the JAX package builds them
    sp, ep, size, ok = jax.vmap(
        lambda n: jfeat._region_bounds(n, CFG.n_regions))(jnp.asarray(cnt))
    ep_eff = jnp.where((size > 0) & ok[:, None], ep, -1)
    spep = jnp.concatenate([sp, ep_eff], axis=1).astype(jnp.float32)
    d = pts[:, 1:] - pts[:, :-1]
    bad = (np.sum(d * d, axis=-1) > CFG.nms_gap_sq).astype(np.float32)
    bcum = np.concatenate([np.zeros((pts.shape[0], 1), np.float32),
                           np.cumsum(bad, axis=1)], axis=1)
    label_p = j_select_rings(jnp.asarray(curv), jnp.asarray(bcum), spep,
                             CFG.n_regions, CFG.max_sharp,
                             CFG.max_less_sharp, CFG.max_flat,
                             CFG.nms_window, CFG.curvature_threshold, tr=8,
                             interpret=True)
    np.testing.assert_array_equal(label_t.numpy(), np.asarray(label_p))

    args = features._select_args(_t(pts), _t(curv), _t(cnt), CFG)
    np.testing.assert_array_equal(args[1].numpy(), bcum.astype(np.int32))
    np.testing.assert_array_equal(args[2].numpy(), np.asarray(spep))
    assert (label_t.numpy() == 2).sum() > 0 and (label_t.numpy() == -1).any()
    assert label_t.dtype == torch.int32


def _select_all(curv, bcum, spep, cnt, tr=8):
    """Labels of the port's select_rings on CPU tensors (the plain
    version), of JAX's Pallas kernel in interpret mode and, when the
    windows are the frontend's (cnt given), of JAX's XLA walk
    features._select_rings fed points whose gaps reproduce bcum (x =
    0.01 j + 2 bcum: a step is a 2 m gap, no step a 1 cm one)."""
    args = (CFG.n_regions, CFG.max_sharp, CFG.max_less_sharp, CFG.max_flat,
            CFG.nms_window, CFG.curvature_threshold)
    got = select_op.select_rings(_t(curv), _t(bcum), _t(spep), *args)
    assert got.dtype == torch.int32
    want = [np.asarray(j_select_rings(
        jnp.asarray(curv), jnp.asarray(bcum.astype(np.float32)),
        jnp.asarray(spep), *args, tr=tr, interpret=True))]
    if cnt is not None:
        x = 0.01 * np.arange(curv.shape[1]) + 2.0 * bcum
        pts = np.stack([x, np.zeros_like(x), np.zeros_like(x)],
                       -1).astype(np.float32)
        label_x, _, _ = jfeat._select_rings(
            jnp.asarray(pts), jnp.asarray(curv),
            jnp.asarray(cnt.astype(np.int32)), JCFG)
        want.append(np.asarray(label_x, np.int32))
    for w in want:
        np.testing.assert_array_equal(got.numpy(), w)
    return got.numpy()


@pytest.mark.parametrize("case", SELECT_CASES)
def test_select_rings_cases_match_jax(case):
    """Labels exact on rows that press on one rule each
    (_torch_scenes.select_case; C = 77, not a multiple of 32): ties, all
    points above or below the threshold, ±inf and NaN, one window over
    the whole row, disabled windows, bcum stepping at every column and
    never, marks that cross into the next region."""
    rng = np.random.default_rng(SELECT_CASES.index(case))
    curv, bcum, spep, cnt = select_case(rng, case, 12, 77)
    label = _select_all(curv, bcum, spep, cnt)
    n_corner, n_flat = (label > 0).sum(), (label < 0).sum()
    if case in ("ties_above", "all_above"):
        assert n_corner > 0 and n_flat == 0
    if case in ("ties_below", "all_below"):
        assert n_flat > 0 and n_corner == 0
    if case == "ties_above":
        # ties go to the lowest index: the first region's first pick is its
        # first column (later regions may start marked by the one before)
        live = spep[:, CFG.n_regions] >= 0
        sp = spep[live, 0].astype(int)
        np.testing.assert_array_equal(label[live, sp], 2)
    if case == "whole_row":
        assert ((label != 0).sum(axis=1)
                <= CFG.max_less_sharp + CFG.max_flat).all()
    if case == "disabled":
        assert not label[:, 5:].all()
    if case == "region_edges":
        # region j's pick at its last column marks the next region's first
        # columns (equal bcum), so they are never picked there
        sp, ep = spep[:, :CFG.n_regions], spep[:, CFG.n_regions:]
        sp, ep = sp.astype(int), ep.astype(int)
        for r in range(label.shape[0]):
            for j in range(CFG.n_regions - 1):
                e = ep[r, j]
                if e < 0 or ep[r, j + 1] < 0:
                    continue
                if e - sp[r, j] < CFG.nms_window:    # may be marked from j - 1
                    continue
                assert label[r, e] == 2
                marked = bcum[r, e + 1:e + 4] == bcum[r, e]
                assert (label[r, e + 1:e + 4][marked] == 0).all()


@pytest.mark.parametrize("rows, c", [(1, 160), (4096, 40)])
def test_select_rings_row_counts_match_jax(rows, c):
    """One ring row, and 4096 short rows: labels exact as above."""
    rng = np.random.default_rng(rows)
    curv, bcum, spep, cnt = select_case(rng, "ring_rows", rows, c)
    label = _select_all(curv, bcum, spep, cnt, tr=min(rows, 512))
    assert (label == 2).any() and (label == 1).any()


def test_select_check_launch():
    """The kernel stages a row in one block's shared memory (9 bytes a
    column) and gives each region a warp: the path's rows fit, a row too
    wide or too many regions is refused."""
    assert select_op.row_bytes(1856) == 16704
    assert select_op.row_bytes(77) == 704
    select_op.check_launch(2560, 6)
    select_op.check_launch(25000, 16)
    with pytest.raises(ValueError, match="shared memory"):
        select_op.check_launch(30000, 6)
    with pytest.raises(ValueError, match="regions"):
        select_op.check_launch(1856, 17)


# --- segmented_prefix_sums -------------------------------------------------

def test_segmented_prefix_sums_matches_jax(rng):
    """Sums atol 1e-5 against the Pallas kernel (interpret mode, 128-wide
    chunks so the 700-long rows cross chunk boundaries with an open
    segment) and a float64 loop; the count channel exact."""
    heads = rng.uniform(size=(4, 700)) < 0.1
    heads[:, 0] = True
    heads[1, 100:400] = False       # one segment spans several chunks
    chan = rng.uniform(-2, 2, size=(2, 4, 700)).astype(np.float32)
    chan[1] = 1.0                   # a count channel
    got = seg_op.segmented_prefix_sums(_t(chan), _t(heads)).numpy()

    pal = np.stack([np.asarray(o) for o in j_seg_sums(
        (jnp.asarray(chan[0]), jnp.asarray(chan[1])), jnp.asarray(heads),
        chunk=128, interpret=True)])
    ref = np.zeros(chan.shape, np.float64)
    for r in range(4):
        acc = np.zeros(2)
        for j in range(700):
            v = chan[:, r, j].astype(np.float64)
            acc = v if heads[r, j] else acc + v
            ref[:, r, j] = acc
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pal, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[1], pal[1])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("heads_at", ["none", "every_1024", "sparse"])
def test_segmented_prefix_sums_long_rows_match_jax(k, heads_at):
    """Rows of 8192 that span several of the CUDA kernel's tiles: no head
    at all (one segment from the row start carries through every tile),
    heads only at multiples of 1024 (each segment is one whole tile), and
    a few heads far apart. Against the Pallas kernel in interpret mode
    (1024-wide chunks) and a float64 loop. The values are quarters in
    [-2, 2] and the last channel counts ones, so every partial sum is
    exact in f32 and all three agree exactly, whatever the order of
    summation."""
    rng = np.random.default_rng(k)
    n = 8192
    heads = np.zeros((2, n), bool)
    if heads_at == "every_1024":
        heads[:, ::1024] = True
    elif heads_at == "sparse":
        heads[0, [0, 1500, 6000]] = True
        heads[1, [4097]] = True
    chan = (rng.integers(-8, 9, size=(k, 2, n)) / 4).astype(np.float32)
    chan[-1] = 1.0
    got = seg_op.segmented_prefix_sums(_t(chan), _t(heads)).numpy()

    pal = np.stack([np.asarray(o) for o in j_seg_sums(
        tuple(jnp.asarray(c) for c in chan), jnp.asarray(heads), chunk=1024,
        interpret=True)])
    ref = np.zeros(chan.shape, np.float64)
    for r in range(2):
        starts = np.flatnonzero(heads[r]).tolist()
        for a, b in zip([0] + starts, starts + [n]):
            ref[:, r, a:b] = np.cumsum(chan[:, r, a:b], axis=-1,
                                       dtype=np.float64)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("kernel_interpret", [False, True])
def test_voxel_core_matches_jax(rng, kernel_interpret):
    """Through the whole downsample (sort, scan, compaction) against JAX's
    _voxel_core with its XLA scan and with the Pallas scan in interpret
    mode: means atol 2e-5, masks and drop counts exact."""
    r, n, k = 12, 640, 4
    vals = rng.uniform(-20, 20, size=(r, n, k)).astype(np.float32)
    mask = rng.uniform(size=(r, n)) > 0.15
    mask[0] = False                 # an empty row
    out_t = _voxel_core(_t(vals), _t(mask), 0.7, 256)
    out_j = j_voxel_core(jnp.asarray(vals), jnp.asarray(mask), 0.7, 256,
                         force_kernel_interpret=kernel_interpret)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               atol=2e-5, rtol=0)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    assert out_t[2].numpy().max() > 0      # out_cap 256 overflows here


# --- window_mins -----------------------------------------------------------

def _window_inputs(rng, bsz=2, q=96, m=700):
    sel = rng.uniform(-10, 10, size=(bsz, q, 3)).astype(np.float32)
    ref = rng.uniform(-10, 10, size=(bsz, m, 3)).astype(np.float32)
    ring = np.sort(rng.integers(0, 16, size=(bsz, m)), axis=1)
    mask = rng.uniform(size=(bsz, m)) > 0.1
    return sel, ref, ring.astype(np.int32), mask


@pytest.mark.parametrize("want_same", [True, False])
def test_window_mins_matches_jax(rng, want_same):
    """Against the JAX XLA scan (odom_window_mins_b) and the Pallas kernel
    in interpret mode: d2 within rtol/atol 1e-4 (the JAX side expands
    q² − 2q·r + r², the port computes (q − r)² directly), indices exact
    wherever a candidate exists."""
    sel, ref, ring, mask = _window_inputs(rng)
    got = odom_window_mins_b(_t(sel), _t(ref), _t(mask), _t(ring), 2,
                             want_same_ring=want_same)
    xla = j_window_mins_b(jnp.asarray(sel), jnp.asarray(ref),
                          jnp.asarray(mask), jnp.asarray(ring), 2,
                          want_same_ring=want_same, chunk=256)
    assert len(got) == len(xla) == (6 if want_same else 4)

    center = sel.mean(axis=1, keepdims=True)
    ref_p = np.concatenate(
        [np.where(mask[:, None, :], np.moveaxis(ref - center, 1, 2), 1e9),
         np.where(mask, ring, 1e9)[:, None].astype(np.float32)],
        axis=1).astype(np.float32)
    pal = j_window_mins(jnp.asarray(sel - center), jnp.asarray(ref_p), 2.0,
                        tq=32, m_chunk=256, interpret=True)
    for other in (xla, pal):
        for j in range(0, len(got), 2):
            d_t, d_o = got[j].numpy(), np.asarray(other[j])
            has = d_o < 1e17
            np.testing.assert_allclose(d_t[has], d_o[has], rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_array_equal(got[j + 1].numpy()[has],
                                          np.asarray(other[j + 1])[has])
            assert has.mean() > 0.9


def test_window_mins_poisoned_cloud():
    """An all-invalid reference: every d2 is beyond the 25 m² gates and
    the windows stay out of every real ring."""
    rng = np.random.default_rng(3)
    sel, ref, ring, _ = _window_inputs(rng, bsz=1, q=16, m=40)
    got = odom_window_mins_b(_t(sel), _t(ref), torch.zeros(1, 40, dtype=bool),
                             _t(ring), 2, want_same_ring=True)
    assert (got[0].numpy() > 1e17).all()
    assert (got[2].numpy() == np.inf).all()


def _window_cases(rng, seg=24):
    """Ring-segmented references (8 rings of ``seg`` rows and 16 tail
    rows, _torch_scenes.segmented_reference, scaled to a 10 m radius so
    JAX's expanded d2 rounds within the 1e-4 the test allows) and queries
    near them."""
    ref = segmented_reference(rng, 2, 8, seg, 16)
    ref[:, :3] = np.where(ref[:, 3:] < 1e8, 0.25 * ref[:, :3], 1e9)
    cases = {"segmented": (queries_near(rng, ref, 48), ref)}
    # the first and the last ring: the windows are clipped at the ends
    cases["end_rings"] = (queries_near(rng, ref, 32, rings=[0, 7]), ref)
    # duplicate points: exact ties in pass 1 and in both windows
    dup = ref.copy()
    for b in range(dup.shape[0]):
        for r in (2, 5):
            dup[b, :3, r * seg + 3] = dup[b, :3, r * seg + 1]
            dup[b, :3, (r + 1) * seg + 2] = dup[b, :3, r * seg + 1]
            dup[b, 2, (r + 1) * seg + 2] += 0.4
    sel = queries_near(rng, dup, 40, rings=[2, 3, 5, 6])
    sel[:, :4] = dup[:, :3, 2 * seg + 1][:, None, :]        # on the point
    cases["duplicates"] = (sel, dup)
    # frame 0: everything poisoned, pass 1 finds index 0 on ring 1e9
    cases["all_poisoned"] = (queries_near(rng, ref, 24),
                             np.full_like(ref, 1e9))
    return cases, seg


@pytest.mark.parametrize("case", ["segmented", "end_rings", "duplicates",
                                  "all_poisoned"])
def test_window_mins_ring_seg_contract(case):
    """ring_seg only skips rows that no window can reach: the plain
    version with the stride is bit-equal to itself without it, and agrees
    with the Pallas kernel in interpret mode with the same stride (d2
    within 1e-4: JAX expands q² − 2q·r + r²; indices exact wherever a
    candidate exists, ties to the lowest index). On the all-poisoned
    reference every query scans all M: d2_same ≈ 3e18 at index 1."""
    cases, seg = _window_cases(np.random.default_rng(7))
    sel, ref = cases[case]
    for want_same in (False, True):
        got = odom_op.window_mins_plain(_t(sel), _t(ref), 2.5, want_same,
                                        ring_seg=seg)
        full = odom_op.window_mins_plain(_t(sel), _t(ref), 2.5, want_same)
        for g, f in zip(got, full):
            assert torch.equal(g, f)
    pal = j_window_mins(jnp.asarray(sel), jnp.asarray(ref), 2.5, tq=16,
                        m_chunk=32, interpret=True, ring_seg=seg)
    for j in range(0, 6, 2):
        d_t, d_o = got[j].numpy(), np.asarray(pal[j])
        has = np.isfinite(d_o)
        np.testing.assert_allclose(d_t[has], d_o[has], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got[j + 1].numpy()[has],
                                      np.asarray(pal[j + 1])[has])
        np.testing.assert_array_equal(np.isfinite(d_t), has)
    if case == "all_poisoned":
        assert (got[1].numpy() == 0).all() and (got[5].numpy() == 1).all()
        assert (got[4].numpy() > 1e18).all()
        assert np.isinf(got[2].numpy()).all()
    else:
        assert np.isfinite(got[2].numpy()).mean() > 0.9
    if case == "duplicates":
        # the query on the duplicated point: its lower-index copy wins
        np.testing.assert_array_equal(got[1].numpy()[:, :4], 2 * seg + 1)
        assert (got[0].numpy()[:, :4] == 0).all()
        np.testing.assert_array_equal(got[5].numpy()[:, :4], 2 * seg + 3)
    if case == "end_rings":
        br = np.take_along_axis(ref[:, 3], got[1].numpy().astype(int), 1)
        assert {0.0, 7.0} <= set(np.unique(br).tolist())


def test_window_mins_ring_seg_reaches_the_search(monkeypatch):
    """odometry_step_b declares its handoff clouds ring-segmented with the
    JAX package's strides: n_regions · max_less_sharp for corners and
    min(ring_cap, less_flat_cap // scan_lines) for surfaces."""
    seen = []
    real = odom_op.window_mins

    def spy(sel, ref, nearby, want_same, ring_seg=0):
        seen.append((want_same, ring_seg, ref.shape[2]))
        return real(sel, ref, nearby, want_same, ring_seg)

    monkeypatch.setattr(odom_op, "window_mins", spy)
    from aloam_tpu_torch import odometry as tod
    from aloam_tpu_torch.types import PointCloud, ScanFeatures

    def cloud(cap):
        return PointCloud(xyz=torch.zeros(1, cap, 3),
                          intensity=torch.zeros(1, cap),
                          mask=torch.zeros(1, cap, dtype=torch.bool))
    feats = ScanFeatures(sharp=cloud(CFG.sharp_cap),
                         less_sharp=cloud(CFG.less_sharp_cap),
                         flat=cloud(CFG.flat_cap),
                         less_flat=cloud(CFG.less_flat_cap),
                         full=cloud(8), overflow=torch.zeros(1))
    tod.odometry_step_b(tod.init_state(CFG, 1, "cpu"), feats, CFG)
    seg_p = min(CFG.ring_cap, CFG.less_flat_cap // CFG.scan_lines)
    assert seen == [(False, CFG.n_regions * CFG.max_less_sharp,
                     CFG.less_sharp_cap),
                    (True, seg_p, CFG.less_flat_cap)] * CFG.odom_outer_rounds
    assert seg_p == 128


# --- lm_fused ----------------------------------------------------------------

def _factors(rng, b, ne, npl, frac_valid=0.7, offset=0.0, poison=False,
             aligned_normals=False):
    """Edge and plane factors near a recoverable pose (the generator of
    tests/test_pallas_lm.py), as numpy arrays."""
    e_p = rng.normal(scale=8.0, size=(b, ne, 3)).astype(np.float32)
    e_a = e_p + rng.normal(scale=0.05, size=(b, ne, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, ne, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    e_b = e_a + 0.4 * dirs
    e_m = rng.random((b, ne)) < frac_valid
    p_p = rng.normal(scale=8.0, size=(b, npl, 3)).astype(np.float32)
    if aligned_normals:
        n = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (b, npl, 1))
        n = n + rng.normal(scale=0.02, size=(b, npl, 3)).astype(np.float32)
    else:
        n = rng.normal(size=(b, npl, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = (-np.sum(n * p_p, axis=-1) + offset
         + rng.normal(scale=0.02, size=(b, npl))).astype(np.float32)
    p_m = rng.random((b, npl)) < frac_valid
    if poison:
        e_p[~e_m] = np.inf
        p_p[~p_m] = np.nan
    return (e_p, e_a, e_b, e_m), (p_p, n, d, p_m)


def _lm_case(case, rng):
    b = 3 if case == "match" else 2
    if case == "match":
        e, p = _factors(rng, b, 256, 384, poison=True)
        q0 = np.tile([[0.999, 0.02, -0.03, 0.01]], (b, 1)).astype(np.float32)
        q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
        t0 = rng.normal(scale=0.1, size=(b, 3)).astype(np.float32)
    elif case == "clamp":
        # aligned planes offset by 20 m and no edges: the first translation
        # update exceeds the 5 m clamp
        e, p = _factors(rng, b, 128, 256, offset=20.0, aligned_normals=True)
        e = (*e[:3], np.zeros_like(e[3]))
        q0 = np.tile([[1.0, 0, 0, 0]], (b, 1)).astype(np.float32)
        t0 = np.zeros((b, 3), np.float32)
    else:  # empty problem: the pose comes back unchanged
        e, p = _factors(rng, b, 128, 128, frac_valid=0.0)
        q0 = rng.normal(size=(b, 4)).astype(np.float32)
        q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
        t0 = rng.normal(size=(b, 3)).astype(np.float32)
    return e, p, q0, t0


@pytest.mark.parametrize("case", ["match", "clamp", "empty"])
def test_lm_matches_jax(case):
    """solver.lm_solve_b (the plain version of the one-launch solve) against
    the Pallas kernel in interpret mode and JAX's vmapped lm_solve: q atol
    2e-5, t atol 2e-4 (2e-3 when the clamp engages), cost0 rtol 2e-4, cost
    rtol 2e-3; n_factors, clamped and nonfinite exact."""
    rng = np.random.default_rng(7)
    e, p, q0, t0 = _lm_case(case, rng)
    edges = solver.EdgeFactors(*map(_t, e))
    planes = solver.PlaneFactors(*map(_t, p))
    q, t, st = solver.lm_solve_b(edges, planes, _t(q0), _t(t0), 4, 0.1)

    je = jsolver.EdgeFactors(*map(jnp.asarray, e))
    jp = jsolver.PlaneFactors(*map(jnp.asarray, p))
    pose = jnp.concatenate([q0, t0, np.zeros((len(q0), 1), np.float32)], 1)
    pal = np.asarray(pallas_lm.lm_fused(
        pallas_lm.pack_edge_channels(je), pallas_lm.pack_plane_channels(jp),
        pose, 4, 0.1, interpret=True))
    q_r, t_r, st_r = jax.vmap(lambda a, b_, qq, tt: jsolver.lm_solve(
        (a, b_), qq, tt, 4, 0.1))(je, jp, jnp.asarray(q0), jnp.asarray(t0))
    t_tol = 2e-3 if case == "clamp" else 2e-4
    for q_o, t_o, c0, c, nf, cl, nn in (
            (pal[:, 0:4], pal[:, 4:7], pal[:, 7], pal[:, 8], pal[:, 9],
             pal[:, 10], pal[:, 11]),
            (q_r, t_r, st_r.cost0, st_r.cost, st_r.n_factors, st_r.clamped,
             st_r.nonfinite)):
        np.testing.assert_allclose(q.numpy(), np.asarray(q_o), atol=2e-5,
                                   rtol=0)
        np.testing.assert_allclose(t.numpy(), np.asarray(t_o), atol=t_tol,
                                   rtol=0)
        np.testing.assert_allclose(st.cost0.numpy(), np.asarray(c0),
                                   rtol=2e-4)
        np.testing.assert_allclose(st.cost.numpy(), np.asarray(c), rtol=2e-3)
        for a_, b_ in ((st.n_factors, nf), (st.clamped, cl),
                       (st.nonfinite, nn)):
            np.testing.assert_array_equal(a_.numpy(),
                                          np.asarray(b_).astype(np.int32))
    if case == "clamp":
        assert (st.clamped.numpy() >= 1).all()
    if case == "empty":
        np.testing.assert_allclose(q.numpy(), q0, atol=1e-6)
        np.testing.assert_allclose(t.numpy(), t0, atol=1e-6)
        assert (st.n_factors.numpy() == 0).all()


def test_lm_any_factor_count(rng):
    """Factor caps need not be multiples of 128 (a TPU layout rule the port
    drops): 100 edges and 77 planes solve like the padded 128 / 128."""
    e, p = _factors(rng, 2, 100, 77)
    q0 = np.tile([[1.0, 0, 0, 0]], (2, 1)).astype(np.float32)
    t0 = np.zeros((2, 3), np.float32)
    pad = [lambda x, k=k: np.concatenate(
        [x, np.zeros((2, k) + x.shape[2:], x.dtype)], 1)
        for k in (28, 51)]
    q, t, st = solver.lm_solve_b(solver.EdgeFactors(*map(_t, e)),
                                 solver.PlaneFactors(*map(_t, p)),
                                 _t(q0), _t(t0), 4, 0.1)
    q2, t2, st2 = solver.lm_solve_b(
        solver.EdgeFactors(*(_t(pad[0](x)) for x in e)),
        solver.PlaneFactors(*(_t(pad[1](x)) for x in p)), _t(q0), _t(t0),
        4, 0.1)
    np.testing.assert_allclose(q.numpy(), q2.numpy(), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), t2.numpy(), atol=1e-5)
    np.testing.assert_array_equal(st.n_factors.numpy(), st2.n_factors.numpy())


@pytest.mark.parametrize("bsz", [1, 16, 32])
def test_lm_launch_plan_covers_every_row(bsz):
    """ops/lm.launch_plan on a 132-SM card: a cluster of at most 8 blocks
    a stream (8 at B = 1, 6 at B = 16, 3 at B = 32) whose slices, laid out
    on the grid as csrc/lm.cu cuts them (block = stream · cluster + rank),
    cover every edge and plane row of every stream exactly once and fit a
    block's shared memory."""
    counts = (0, 1, 768, 3072, 4096, 7168)
    for ne in counts:
        for np_ in counts:
            cluster = lm_op.launch_plan(bsz, ne, np_, 132)
            assert 1 <= cluster <= lm_op.MAX_CLUSTER == 8
            assert cluster == {1: 8, 16: 6, 32: 3}[bsz]
            assert lm_op._slice_bytes(ne, np_, cluster) <= lm_op.SLICE_BYTES
            for n in (ne, np_):
                seen = np.zeros((bsz, n), int)
                for block in range(bsz * cluster):
                    start, stop = lm_op.slices(n, cluster)[block % cluster]
                    assert 0 <= start <= stop <= n
                    seen[block // cluster, start:stop] += 1
                assert (seen == 1).all()
    assert lm_op.launch_plan(12, 3072, 4096, 132) == 8
    assert lm_op.launch_plan(200, 768, 1536, 132) == 1
    # one block cannot hold a map solve's 254 KB of factors: two can
    assert lm_op.launch_plan(200, 3072, 4096, 132) == 2


def test_lm_launch_plan_raises_past_shared_memory():
    """A stream whose factors overflow 8 blocks' shared memory is refused
    with an error, not cut or sent down another path; a stream whose
    factors need more blocks than the batch leaves per SM gets them."""
    with pytest.raises(ValueError, match="shared memory"):
        lm_op.launch_plan(1, 50000, 50000, 132)
    assert lm_op.launch_plan(200, 12000, 12000, 132) == 5


# --- primitives and the wrappers' dispatch ----------------------------------

def test_geometry_matches_jax(rng):
    """qmul, qrot, qrot_inv, exp_so3, retract and compose: atol 1e-6."""
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = np.roll(q, 1, axis=0)
    v = rng.normal(scale=10, size=(5, 3)).astype(np.float32)
    phi = np.concatenate([rng.normal(scale=0.3, size=(4, 3)),
                          np.full((1, 3), 1e-6)]).astype(np.float32)
    pairs = [
        (geo.qmul(_t(q), _t(q2)), jgeo.qmul(q, q2)),
        (geo.qrot(_t(q), _t(v)), jgeo.qrot(q, v)),
        (geo.qrot_inv(_t(q), _t(v)), jgeo.qrot_inv(q, v)),
        (geo.exp_so3(_t(phi)), jgeo.exp_so3(phi)),
        (geo.retract(_t(q), _t(phi)), jgeo.retract(q, phi)),
        (geo.compose(_t(q), _t(v), _t(q2), _t(v))[1],
         jgeo.compose(q, v, q2, v)[1]),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-6)


# (row shape, as a view of a 4-wide cloud's [..., :3]): 12, 16, 576 and
# 960 bytes of f32, the strided xyz view of odometry's gathers
BGATHER_ROWS = [((3,), False), ((4,), False), ((8, 18), False),
                ((240,), False), ((3,), True)]


@pytest.mark.parametrize("bsz", [1, 3])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("row, view", BGATHER_ROWS)
def test_bgather_matches_jax(rng, row, view, idx_dtype, bsz):
    """bgather (the plain version on the CPU) against JAX's, bit for bit,
    at every row width and index type its callers give it; the plain
    version called by name agrees."""
    n = 50
    x = rng.normal(size=(bsz, n) + ((4,) if view else row)).astype(
        np.float32)
    xt = _t(x)
    if view:
        x, xt = x[..., :3], xt[..., :3]
    idx = rng.integers(0, n, size=(bsz, 7, 2)).astype(idx_dtype)
    got = gather_op.bgather(xt, _t(idx))
    want = np.asarray(j_bgather(x, idx.astype(np.int32)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather_op.bgather_plain(xt, _t(idx)).numpy(), want)


@pytest.mark.parametrize("bsz", [1, 3])
def test_bgather_empty_index_matches_jax(rng, bsz):
    x = rng.normal(size=(bsz, 50, 4)).astype(np.float32)
    idx = np.zeros((bsz, 0), np.int32)
    got = gather_op.bgather(_t(x), _t(idx))
    want = np.asarray(j_bgather(x, idx))
    assert got.shape == want.shape == (bsz, 0, 4)


@pytest.mark.parametrize("row_bytes, offsets, width", [
    (16, (0, 256, 16, 64), 16), (12, (0, 256, 16, 64), 4),
    (576, (0, 256, 576, 0), 16), (960, (0, 512, 0, 960), 16),
    (16, (8, 256, 16, 0), 8), (16, (0, 256, 20, 0), 4),
    (6, (0, 256, 6, 0), None), (12, (2, 256, 12, 0), None)])
def test_bgather_vector_width(row_bytes, offsets, width):
    """The kernel's vector is the widest that divides the row's bytes,
    both base addresses and both strides; rows that are not whole 4-byte
    words raise."""
    if width is None:
        with pytest.raises(ValueError):
            gather_op.vector_bytes(row_bytes, *offsets)
    else:
        assert gather_op.vector_bytes(row_bytes, *offsets) == width


@pytest.mark.parametrize("total, blocks", [
    (1, 1), (256, 1), (257, 2), (32768, 128), (5_242_880, 8 * 132),
    (2**31 - 1, 8 * 132)])
def test_bgather_launch_plan(total, blocks):
    """A thread a vector up to eight blocks on each of 132 SMs, the
    grid-stride loop past that."""
    assert gather_op.launch_plan(total, 132) == blocks


def test_bgather_reads_rows_in_place():
    """Which views the kernel reads without a copy: each row contiguous,
    whatever the stream and row strides."""
    cloud = torch.zeros(2, 5, 4)
    assert gather_op._rows_contiguous(cloud)
    assert gather_op._rows_contiguous(cloud[..., :3])
    assert gather_op._rows_contiguous(cloud[:, ::2])
    assert gather_op._rows_contiguous(cloud[:, :, None, :3])
    assert not gather_op._rows_contiguous(cloud[..., ::2])
    assert not gather_op._rows_contiguous(cloud.transpose(1, 2))
    assert gather_op._rows_contiguous(torch.zeros(2, 5))


def test_wrappers_refuse_non_cuda_devices():
    """A wrapper runs the plain version only for CPU tensors; any other
    device must be a CUDA tensor for the kernel, or it raises (no silent
    fallback). The meta device stands in for a non-CPU, non-CUDA one."""
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        seg_op.segmented_prefix_sums(torch.empty(2, 3, 8, **meta),
                                     torch.empty(3, 8, dtype=bool, **meta))
    with pytest.raises(ValueError):
        select_op.select_rings(torch.empty(4, 8, **meta),
                               torch.empty(4, 8, dtype=torch.int32, **meta),
                               torch.empty(4, 12, **meta), 6, 2, 20, 4, 5,
                               0.1)
    with pytest.raises(ValueError):
        odom_op.window_mins(torch.empty(1, 4, 3, **meta),
                            torch.empty(1, 4, 9, **meta), 2.0, True)
    with pytest.raises(ValueError):
        lm_op.lm_fused(torch.empty(1, 10, 8, **meta),
                       torch.empty(1, 8, 8, **meta),
                       torch.empty(1, 8, **meta), 4, 0.1)
    with pytest.raises(ValueError):
        assoc_op.assoc_cell(torch.empty(300, 768, **meta),
                            torch.empty(1, dtype=torch.int32, **meta),
                            torch.empty(256, 8, **meta), "surf", 1.0)
    i32 = dict(dtype=torch.int32, **meta)
    with pytest.raises(ValueError):
        insert_op.merge_rows(
            torch.empty(1, 64, 96, **meta), torch.empty(1, 64, 160, **i32),
            torch.empty(1, 4, **i32), torch.empty(1, 4, **i32),
            *(torch.empty(1, 4, 16, **meta) for _ in range(4)),
            torch.empty(1, 4, 16, **i32), torch.empty(1, 3, **i32),
            torch.empty(3, **i32), 2.0, 0.4)
    with pytest.raises(ValueError):
        knn_op.knn_select(torch.empty(300, 768, **meta),
                          torch.empty(256, dtype=torch.int32, **meta),
                          torch.empty(256, 4, **meta), 5)
    with pytest.raises(ValueError):
        knn_op.knn_grid(torch.empty(64, 144, **meta),
                        torch.empty(256, 3, **meta), 5, 2.0, 1.0)
    with pytest.raises(ValueError):
        gather_op.bgather(torch.empty(2, 50, 4, **meta),
                          torch.empty(2, 7, dtype=torch.int32, **meta))
    with pytest.raises(ValueError):
        gather_op.bgather(torch.empty(2, 50, 4),
                          torch.empty(2, 7, dtype=torch.int32, **meta))
    with pytest.raises(ValueError):
        rings_op.ring_clouds(torch.empty(8, 256, 3, **meta),
                             torch.empty(8, 256, **meta),
                             torch.empty(8, 256, **i32),
                             torch.empty(8, **i32), 1, 6, (12, 120, 24, 64),
                             (96, 960, 192, 512), 0.2)
    assert seg_op.launches == select_op.launches == 0
    assert gather_op.launches == rings_op.launches == 0
    assert odom_op.launches == lm_op.launches == 0
    assert assoc_op.launches == insert_op.launches == knn_op.launches == 0
    assert knn_op.grid_launches == 0


def test_kernel_table_is_complete():
    """Every entry of ``ops/kernels.KERNELS`` resolves (module, wrapper,
    plain twin, counter), its source exists, every ``csrc/*.cu`` but the
    stamp and the error helpers is some entry's source, and the paths
    name only entries, the front half's kernels among step_b's."""
    import os

    from aloam_tpu_torch.ops import _build, kernels
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, spec in kernels.KERNELS.items():
        mod = kernels.module(name)
        assert callable(getattr(mod, spec.wrapper)), name
        assert callable(getattr(mod, spec.plain)), name
        assert isinstance(kernels.launches(name), int), name
        assert os.path.isfile(os.path.join(repo, spec.source)), name
        assert spec.in_place >= 0 and callable(spec.check), name
    assert {src.name for src in _build.sources()} - {"stamp.cu", "errors.cu"} \
        == {os.path.basename(k.source) for k in kernels.KERNELS.values()}
    assert set(kernels.FRONT) < set(kernels.STEP_B)
    assert set(kernels.STEP_B) | set(kernels.STEP) <= set(kernels.KERNELS)


def test_c_signatures_match_the_sources():
    """Every kernel entry point of csrc/*.cu (``extern "C" int``) has a
    ctypes signature in _build.SIGNATURES with as many arguments, and
    every signature names one: a missing or short signature would pass
    pointers as 32-bit ints."""
    import re

    from aloam_tpu_torch.ops import _build
    found = {}
    for src in _build.sources():
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                             src.read_text()):
            found[m.group(1)] = len(m.group(2).split(","))
    assert found == {n: len(a) for n, a in _build.SIGNATURES.items()}


def test_build_key_follows_sources(tmp_path, monkeypatch):
    """The kernel library is keyed on the CUDA sources: an edited source
    gets a new library name (so it rebuilds), and building without nvcc
    fails with a clear error instead of falling back."""
    import shutil

    from aloam_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    names = [s.name for s in _build.sources()]
    assert names == sorted(["assoc.cu", "errors.cu", "evict.cu", "gather.cu",
                            "insert.cu", "knn.cu", "lm.cu", "odom_window.cu",
                            "rings.cu", "seg_scan.cu", "select.cu",
                            "stamp.cu"])
    before = _build.library_path()
    assert before == _build.library_path()
    with open(csrc / "lm.cu", "a") as fh:
        fh.write("\n// edited\n")
    edited = _build.library_path()
    assert edited != before
    # a shared header is part of the key too
    with open(csrc / "knn_select.cuh", "a") as fh:
        fh.write("\n// edited\n")
    assert _build.library_path() != edited

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "_build").exists()


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """build() starts one compile per source, then links the objects into
    the keyed library and removes them; a failing compile raises with the
    compiler's message and leaves no library and no objects. A stand-in
    nvcc (a Python script) records what it was asked to do."""
    import shutil
    import stat
    import sys

    from aloam_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    build_dir = tmp_path / "_build"
    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(f"""#!{sys.executable}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({str(log)!r}, "a") as fh:
    fh.write(("link " if "-shared" in args else "compile ") + out + "\\n")
if "-c" in args and "#error" in open(args[-1]).read():
    sys.stderr.write("broken source " + args[-1])
    sys.exit(2)
open(out, "w").write("built")
""")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))

    lib = _build.build()
    assert lib == _build.library_path() and lib.read_text() == "built"
    calls = log.read_text().split("\n")[:-1]
    n_src = len(_build.sources())
    assert [c.split()[0] for c in calls] == ["compile"] * n_src + ["link"]
    assert sorted(p.name for p in build_dir.iterdir()) == [lib.name]
    assert _build.build() == lib               # keyed: no second build
    assert len(log.read_text().split("\n")[:-1]) == n_src + 1

    with open(csrc / "insert.cu", "a") as fh:
        fh.write("\n#error broken\n")
    with pytest.raises(RuntimeError, match="broken source .*insert.cu"):
        _build.build()
    assert sorted(p.name for p in build_dir.iterdir()) == [lib.name]
