"""The port's single-stream API and its last helpers against the JAX
package.

The single-stream twins (``frontend.register_scan`` / ``bucket_rings`` /
``extract_features`` / ``voxel_downsample_masked``, the odometry's
``transform_to_end`` / ``edge_correspondences`` / ``plane_correspondences``
/ ``odometry_step``, ``neighbors.nn1`` / ``odom_window_mins`` and
``gridmap.insert``) take and return the JAX package's unbatched leaves
and run the port's batched functions at B = 1. The helpers
(``geometry.qinv`` / ``q_to_mat`` / ``mat_to_q`` / ``log_so3`` / ``skew`` /
``inverse_pose`` / ``transform``, ``utils/masked.py``,
``utils/batch.{boffsets, bcompact, bcompact2}``, ``solver.PointFactors`` /
``point_residuals``) are plain tensor functions.

Both packages run on the CPU from the same seeded numpy inputs: JAX under
this suite's conftest, the port through its kernels' plain versions. The
scene is one stream of tests/test_torch_slice.py's 16-line one.

Tolerances, each restated in its test: where the batched functions are
held exact (tests/test_torch_slice.py, test_torch_kernels.py,
test_torch_mapping.py) the twins are held exact (ring counts, masks,
labels, gathers, compactions, the insert's tables); floats of the
registration and features as there (1e-6 / 1e-5 atol); the search's d2
within 1e-4 (the port's kernel computes (q − r)², JAX expands q² − 2q·r +
r²) with indices exact where the two nearest are not a rounding tie;
odometry poses 5e-4 and correspondence counts ±3 (the slice test's
bounds); the geometry at f32 rounding (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aloam_tpu import frontend as jfront
from aloam_tpu import geometry as jgeo
from aloam_tpu import neighbors as jnb
from aloam_tpu import odometry as jod
from aloam_tpu import solver as jsolver
from aloam_tpu.frontend import registration as jreg
from aloam_tpu.ops import gridmap as jgrid
from aloam_tpu.utils import batch as jbatch
from aloam_tpu.utils import masked as jmasked
from aloam_tpu_torch import frontend
from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import neighbors as nb
from aloam_tpu_torch import odometry as od
from aloam_tpu_torch import solver
from aloam_tpu_torch.frontend import registration
from aloam_tpu_torch.io import synthetic as syn
from aloam_tpu_torch.ops import gridmap
from aloam_tpu_torch.types import PointCloud, RingCloud, ScanFeatures
from aloam_tpu_torch.utils import batch
from aloam_tpu_torch.utils import masked
from test_torch_slice import CFG, CLOUDS, _jcfg

torch.set_num_threads(1)

JCFG = _jcfg(CFG)
N_FRAMES = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud_t(pc) -> PointCloud:
    return PointCloud(xyz=_t(pc.xyz), intensity=_t(pc.intensity),
                      mask=_t(pc.mask))


def _feats_t(f) -> ScanFeatures:
    return ScanFeatures(*(_cloud_t(getattr(f, c)) for c in CLOUDS),
                        overflow=_t(f.overflow))


@pytest.fixture(scope="module")
def scans():
    """(F, n_raw, 3) xyz and (F, n_raw) mask of one 16-line stream."""
    frames, _ = syn.make_sequence(N_FRAMES, scan_lines=CFG.scan_lines,
                                  n_azimuth=256, seed=31, speed=1.5)
    pads = [syn.pad_scan(s, CFG.n_raw) for s in frames]
    return (np.stack([p[0] for p in pads]), np.stack([p[1] for p in pads]))


@pytest.fixture(scope="module")
def jax_chain(scans):
    """JAX's single-stream front half under jit: per frame the features,
    the odometry state before and after the frame, and its metrics."""
    reg = jax.jit(lambda x, m: jfront.register_scan(x, m, JCFG))
    ext = jax.jit(lambda rc, cv: jfront.extract_features(rc, cv, JCFG))
    odo = jax.jit(lambda s, f: jod.odometry_step(s, f, JCFG))
    st = jod.init_state(JCFG)
    feats, states, metrics = [], [st], []
    for f in range(N_FRAMES):
        rc, curv, _ = reg(scans[0][f], scans[1][f])
        feats.append(ext(rc, curv))
        st, m = odo(st, feats[-1])
        states.append(st)
        metrics.append(m)
    return feats, states, metrics


def _state_t(st) -> od.OdomState:
    return od.OdomState(
        q_w=_t(st.q_w), t_w=_t(st.t_w), q_lc=_t(st.q_lc), t_lc=_t(st.t_lc),
        corner_last=_cloud_t(st.corner_last),
        surf_last=_cloud_t(st.surf_last), initialized=_t(st.initialized))


def test_frontend_exports_match_jax():
    """The port's frontend package offers the JAX one's names."""
    names = {n for n in dir(jfront) if not n.startswith("_")
             and callable(getattr(jfront, n))}
    assert names <= set(dir(frontend)), names - set(dir(frontend))


# --- the frontend ------------------------------------------------------------

def test_register_scan_matches_jax(scans):
    """Counts and overflow exact; xyz atol 1e-6 / rtol 1e-5, intensity
    atol 1e-5, curvature atol 1e-6 / rtol 1e-5 (JAX eager, as
    tests/test_torch_slice.py holds register_scan_b)."""
    xyz, mask = scans[0][1], scans[1][1]
    rc_j, curv_j, ovf_j = jfront.register_scan(jnp.asarray(xyz),
                                               jnp.asarray(mask), JCFG)
    rc_t, curv_t, ovf_t = frontend.register_scan(_t(xyz), _t(mask), CFG)
    assert rc_t.xyz.shape == rc_j.xyz.shape and curv_t.ndim == 2
    np.testing.assert_array_equal(rc_t.cnt.numpy(), np.asarray(rc_j.cnt))
    np.testing.assert_allclose(rc_t.xyz.numpy(), np.asarray(rc_j.xyz),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(rc_t.intensity.numpy(),
                               np.asarray(rc_j.intensity), atol=1e-5, rtol=0)
    np.testing.assert_allclose(curv_t.numpy(), np.asarray(curv_j),
                               atol=1e-6, rtol=1e-5)
    assert ovf_t.ndim == 0 and int(ovf_t) == int(ovf_j)


def test_bucket_rings_matches_jax(rng):
    """A scan whose rings overflow a ring_cap of 24: the grid, counts and
    the overflow exact (pure permutations of the inputs)."""
    n, lines, cap = 900, 16, 24
    xyz = rng.normal(scale=10, size=(n, 3)).astype(np.float32)
    inten = rng.uniform(0, 16, size=n).astype(np.float32)
    ring = rng.integers(0, lines, size=n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.2
    rc_j, ovf_j = jreg.bucket_rings(*map(jnp.asarray, (xyz, inten, ring,
                                                       valid)), lines, cap)
    rc_t, ovf_t = registration.bucket_rings(*map(_t, (xyz, inten, ring,
                                                       valid)), lines, cap)
    for name in RingCloud._fields:
        np.testing.assert_array_equal(getattr(rc_t, name).numpy(),
                                      np.asarray(getattr(rc_j, name)),
                                      err_msg=name)
    assert int(ovf_t) == int(ovf_j) > 0


def test_extract_features_matches_jax(scans):
    """From JAX's ring grid and curvature: the five clouds in the same
    order (atol 1e-5), masks exact, the scalar overflow equal."""
    rc_j, curv_j, _ = jfront.register_scan(jnp.asarray(scans[0][2]),
                                           jnp.asarray(scans[1][2]), JCFG)
    f_j = jax.jit(lambda rc, cv: jfront.extract_features(rc, cv, JCFG))(
        rc_j, curv_j)
    f_t = frontend.extract_features(
        RingCloud(xyz=_t(rc_j.xyz), intensity=_t(rc_j.intensity),
                  cnt=_t(rc_j.cnt)), _t(curv_j), CFG)
    for name in CLOUDS:
        cj, ct = getattr(f_j, name), getattr(f_t, name)
        assert ct.xyz.shape == cj.xyz.shape, name
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask),
                                      err_msg=name)
        np.testing.assert_allclose(ct.xyz.numpy(), np.asarray(cj.xyz),
                                   atol=1e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(ct.intensity.numpy(),
                                   np.asarray(cj.intensity), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert f_t.overflow.ndim == 0
    assert int(f_t.overflow) == int(f_j.overflow)


def test_voxel_downsample_masked_matches_jax(rng):
    """One cloud of 640 rows into 200 voxels at most: means atol 2e-5
    (test_torch_kernels.py's bound on the batched core), mask and the drop
    count exact."""
    vals = rng.uniform(-20, 20, size=(640, 4)).astype(np.float32)
    mask = rng.uniform(size=640) > 0.15
    got = frontend.voxel_downsample_masked(_t(vals), _t(mask), 0.7, 200)
    want = jax.jit(lambda v, m: jfront.voxel_downsample_masked(
        v, m, 0.7, 200))(vals, mask)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-5, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2].ndim == 0 and int(got[2]) == int(want[2]) > 0


# --- the odometry ------------------------------------------------------------

def test_transform_to_end_matches_jax(rng):
    """A cloud with time fractions in its intensities: xyz atol 1e-5,
    intensity and mask exact."""
    n = 300
    pc = (rng.normal(scale=20, size=(n, 3)).astype(np.float32),
          (rng.integers(0, 16, size=n)
           + rng.uniform(0, 0.099, size=n)).astype(np.float32),
          rng.uniform(size=n) > 0.1)
    q = jgeo.exp_so3(jnp.asarray([0.02, -0.03, 0.05], jnp.float32))
    t = np.asarray([0.8, -0.1, 0.05], np.float32)
    cfg = CFG.replace(distortion=True)
    want = jod.transform_to_end(jod.PointCloud(*map(jnp.asarray, pc)), q,
                                jnp.asarray(t), _jcfg(cfg))
    got = od.transform_to_end(PointCloud(*map(_t, pc)), _t(q), _t(t), cfg)
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.intensity.numpy(),
                                  np.asarray(want.intensity))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("kind", ["edge", "plane"])
def test_correspondences_match_jax(jax_chain, kind):
    """Frame 2's features against the state after frame 1, at that
    state's warm start: at most 3 factor flags differ (a 25 m² gate
    flipped by rounding); on the factors live in both the points exact and
    the neighbours (edges) or the plane (normal, offset) within 1e-5."""
    feats, states, _ = jax_chain
    st, f = states[2], feats[2]
    if kind == "edge":
        args = (f.sharp, st.corner_last)
        jfn, tfn, cols = jod.edge_correspondences, od.edge_correspondences, \
            ("p", "a", "b")
    else:
        args = (f.flat, st.surf_last)
        jfn, tfn, cols = jod.plane_correspondences, \
            od.plane_correspondences, ("p", "n", "d")
    want = jfn(*args, st.q_lc, st.t_lc, JCFG)
    got = tfn(*map(_cloud_t, args), _t(st.q_lc), _t(st.t_lc), CFG)
    m_t, m_j = got.mask.numpy(), np.asarray(want.mask)
    assert m_t.shape == m_j.shape and got.s is None
    assert (m_t != m_j).sum() <= 3 and m_j.sum() > 20
    both = m_t & m_j
    for name in cols:
        np.testing.assert_allclose(getattr(got, name).numpy()[both],
                                   np.asarray(getattr(want, name))[both],
                                   atol=1e-5, rtol=0, err_msg=name)


def test_odometry_step_matches_jax(jax_chain):
    """Each frame from JAX's state before it: poses atol 5e-4, counts ±3,
    the metrics scalars; then the port's own chain over the 3 frames
    within 5e-3 m / 2e-3 (tests/test_torch_slice.py's chain bounds)."""
    feats, states, metrics = jax_chain
    st_t = _state_t(states[0])
    for f in range(N_FRAMES):
        nxt, m_t = od.odometry_step(_state_t(states[f]), _feats_t(feats[f]),
                                    CFG)
        want = states[f + 1]
        for name in ("q_w", "t_w", "q_lc", "t_lc"):
            np.testing.assert_allclose(getattr(nxt, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       atol=5e-4, err_msg=name)
        assert nxt.q_w.shape == (4,) and bool(nxt.initialized)
        for name in ("corner_corr", "plane_corr"):
            got = getattr(m_t, name)
            assert got.ndim == 0
            assert abs(int(got) - int(getattr(metrics[f], name))) <= 3, name
        st_t, _ = od.odometry_step(st_t, _feats_t(feats[f]), CFG)
        np.testing.assert_allclose(st_t.t_w.numpy(), np.asarray(want.t_w),
                                   atol=5e-3)
        np.testing.assert_allclose(st_t.q_w.numpy(), np.asarray(want.q_w),
                                   atol=2e-3)
    assert np.linalg.norm(st_t.t_w.numpy()) > 0.05


# --- the search --------------------------------------------------------------

def _rounding_ties(d2_all, tol=1e-3):
    """Queries whose two nearest candidates are within ``tol``."""
    srt = np.sort(d2_all, axis=-1)
    return (srt[..., 1] - srt[..., 0]) <= tol


def test_nn1_matches_jax(rng):
    """Dense 1-NN: d2 within 1e-4, indices exact where the two nearest
    are not a rounding tie (both sides expand q² − 2q·r + r²)."""
    q = rng.uniform(-10, 10, size=(200, 3)).astype(np.float32)
    r = rng.uniform(-10, 10, size=(500, 3)).astype(np.float32)
    m = rng.uniform(size=500) > 0.2
    d_t, i_t = nb.nn1(_t(q), _t(r), _t(m))
    d_j, i_j = jnb.nn1(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4,
                               rtol=1e-4)
    d2 = np.where(m[None], ((q[:, None] - r[None]) ** 2).sum(-1), np.inf)
    clear = ~_rounding_ties(d2)
    assert i_t.dtype == torch.int32 and clear.mean() > 0.9
    np.testing.assert_array_equal(i_t.numpy()[clear], np.asarray(i_j)[clear])


@pytest.mark.parametrize("want_same", [True, False])
def test_odom_window_mins_matches_jax(rng, want_same):
    """One stream's search against JAX's streamed scan (chunk 256 of 700
    refs): d2 within rtol/atol 1e-4, indices exact wherever a candidate
    exists (tests/test_torch_kernels.py's bounds on the batched form)."""
    sel = rng.uniform(-10, 10, size=(96, 3)).astype(np.float32)
    ref = rng.uniform(-10, 10, size=(700, 3)).astype(np.float32)
    ring = np.sort(rng.integers(0, 16, size=700)).astype(np.int32)
    mask = rng.uniform(size=700) > 0.1
    got = nb.odom_window_mins(_t(sel), _t(ref), _t(mask), _t(ring), 2,
                              want_same_ring=want_same, chunk=256)
    want = jnb.odom_window_mins(jnp.asarray(sel), jnp.asarray(ref),
                                jnp.asarray(mask), jnp.asarray(ring), 2,
                                want_same_ring=want_same, chunk=256)
    assert len(got) == len(want) == (6 if want_same else 4)
    for j in range(0, len(got), 2):
        d_t, d_j = got[j].numpy(), np.asarray(want[j])
        has = np.isfinite(d_j)
        assert d_t.shape == (96,) and has.mean() > 0.9
        np.testing.assert_allclose(d_t[has], d_j[has], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got[j + 1].numpy()[has],
                                      np.asarray(want[j + 1])[has])


# --- the map -----------------------------------------------------------------

def _insert_against_jax(rng, table, bk, leaf, n, half):
    """Two inserts of n points uniform in ±half m (the second jittered by
    5 cm: it merges into the first's voxels and evicts from full buckets)
    into an empty single-stream table, the port's and JAX's insert at
    JAX's default caps: both tables and every count bit-exact. Returns
    the second insert's counts."""
    cell = 2.0
    grid_t = batch.drop_stream_axis(gridmap.empty(1, table, bk))
    grid_j = jgrid.empty(table, bk)
    np.testing.assert_array_equal(grid_t.aux.numpy(), np.asarray(grid_j.aux))
    center = np.asarray([1, 0, 0], np.int32)
    window = np.asarray([3, 3, 2], np.int32)
    base = rng.uniform(-half, half, size=(n, 3)).astype(np.float32)
    insert = jax.jit(lambda g, *a: jgrid.insert(g, *a[:3], leaf, cell,
                                                *a[3:]))
    for step in range(2):
        pts = (base + rng.normal(scale=0.05, size=base.shape)).astype(
            np.float32)
        inten = rng.uniform(0, 16, size=n).astype(np.float32)
        mask = rng.uniform(size=n) > 0.1
        out_t = gridmap.insert(grid_t, _t(pts), _t(inten), _t(mask), leaf,
                               cell, _t(center), _t(window))
        out_j = insert(grid_j, pts, inten, mask, center, window)
        grid_t, grid_j = out_t[0], out_j[0]
        assert grid_t.pts.shape == (table, 3 * bk)
        np.testing.assert_array_equal(grid_t.pts.numpy(),
                                      np.asarray(grid_j.pts))
        np.testing.assert_array_equal(grid_t.aux.numpy(),
                                      np.asarray(grid_j.aux))
        for name, a, b in zip(("merged", "appended", "evicted", "dropped"),
                              out_t[1:], out_j[1:]):
            assert a.ndim == 0 and int(a) == int(b), (step, name)
    return out_t[1:]


def test_insert_matches_jax(rng):
    """Two inserts into an empty single-stream table (the second merges
    into the first's voxels and evicts from full buckets) with JAX's
    default caps: both tables and every count bit-exact, as
    tests/test_torch_mapping.py holds insert_b."""
    merged, _, evicted, _ = _insert_against_jax(rng, 64, 8, 0.4, 400, 6.0)
    assert int(merged) > 0 and int(evicted) > 0


def test_insert_matches_jax_at_the_preset_surf_buckets(rng):
    """The same at Bk 48, the preset's surf buckets, so JAX's default
    point_cap is max(48, 32) = 48, with ~100 points a 2 m cell (voxels of
    10 cm): rows past the 32 points of one kernel word. Bit-exact; the
    card runs the same call in chip_smoke.py (phase 4)."""
    merged, appended, evicted, _ = _insert_against_jax(
        rng, 256, 48, 0.1, 3000, 3.0)
    assert int(merged) > 0 and int(appended) > 0 and int(evicted) > 0


# --- the helpers -------------------------------------------------------------

def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = [1.0, 0.0, 0.0, 0.0]                  # the identity
    q[1] = [-0.8, 0.36, 0.0, 0.48]               # w < 0
    q[2] = [1.0, 1e-9, 0.0, 0.0]                 # a tiny angle
    for axis in range(3):                        # 180° about x, y, z: each
        q[3 + axis] = 0.0                        # Shepperd branch of mat_to_q
        q[3 + axis, 1 + axis] = 1.0
    return q


def test_geometry_helpers_match_jax(rng):
    """qinv, q_to_mat, mat_to_q (every Shepperd branch), log_so3 (w < 0,
    a tiny angle), skew, inverse_pose and transform: atol 1e-5 (f32
    rounding of the same formulas)."""
    q = _unit_quats(rng, 12)
    v = rng.normal(scale=10, size=(12, 3)).astype(np.float32)
    pts = rng.normal(scale=10, size=(12, 7, 3)).astype(np.float32)
    mats = np.asarray(jgeo.q_to_mat(q))
    pairs = [
        (geo.qinv(_t(q)), jgeo.qinv(q)),
        (geo.q_to_mat(_t(q)), mats),
        (geo.mat_to_q(_t(mats)), jgeo.mat_to_q(mats)),
        (geo.log_so3(_t(q)), jgeo.log_so3(q)),
        (geo.skew(_t(v)), jgeo.skew(v)),
        (geo.transform(_t(q)[:, None], _t(v)[:, None], _t(pts)),
         jgeo.transform(q[:, None], v[:, None], pts)),
    ]
    pairs += list(zip(geo.inverse_pose(_t(q), _t(v)),
                      jgeo.inverse_pose(q, v)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-6)
    # mat_to_q inverts q_to_mat up to the sign of q
    back = geo.mat_to_q(geo.q_to_mat(_t(q))).numpy()
    assert np.allclose(np.abs((back * q).sum(-1)), 1.0, atol=1e-5)


@pytest.mark.parametrize("cap", [5, 60, 200])
def test_compact_matches_jax(rng, cap):
    """utils/masked.compact and compact_cloud, with and without drops:
    exact."""
    vals = rng.normal(size=(150, 3)).astype(np.float32)
    inten = rng.uniform(size=150).astype(np.float32)
    mask = rng.uniform(size=150) > 0.5
    for got, want in ((masked.compact(_t(vals), _t(mask), cap),
                       jmasked.compact(jnp.asarray(vals), jnp.asarray(mask),
                                       cap)),
                      (masked.compact_cloud(_t(vals), _t(inten), _t(mask),
                                            cap),
                       jmasked.compact_cloud(jnp.asarray(vals),
                                             jnp.asarray(inten),
                                             jnp.asarray(mask), cap))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("caps", [(4, 6), (40, 50)])
def test_batch_compactions_match_jax(rng, caps):
    """utils/batch.boffsets, bcompact and bcompact2 (disjoint masks), with
    and without drops: exact."""
    cap_a, cap_b = caps
    vals = rng.normal(size=(3, 60, 4)).astype(np.float32)
    pick = rng.integers(0, 3, size=(3, 60))
    mask_a, mask_b = pick == 0, pick == 1
    np.testing.assert_array_equal(batch.boffsets(3, 7, 3).numpy(),
                                  np.asarray(jbatch.boffsets(3, 7, 3)))
    got = batch.bcompact(_t(vals), _t(mask_a), cap_a)
    want = jbatch.bcompact(jnp.asarray(vals), jnp.asarray(mask_a), cap_a)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = batch.bcompact2(_t(vals), _t(mask_a), cap_a, _t(mask_b), cap_b)
    want = jbatch.bcompact2(jnp.asarray(vals), jnp.asarray(mask_a), cap_a,
                            jnp.asarray(mask_b), cap_b)
    for part_g, part_w in zip(got, want):
        for g, w in zip(part_g, part_w):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_point_factors_match_jax(rng):
    """point_residuals of a (1, N) batch against JAX's on (N,) (residual
    and Jacobian atol 1e-5), and lm_solve over point factors that pull a
    cloud onto its moved copy: q atol 2e-5, t atol 2e-4 (tests/
    test_pallas_lm.py's LM bounds), counts exact."""
    n = 64
    p = rng.normal(scale=5, size=(n, 3)).astype(np.float32)
    q_true = np.asarray(jgeo.exp_so3(jnp.asarray([0.05, -0.02, 0.03],
                                                 jnp.float32)))
    t_true = np.asarray([0.3, -0.2, 0.1], np.float32)
    target = np.asarray(jgeo.transform(q_true, t_true, p))
    mask = rng.uniform(size=n) > 0.2
    f_j = jsolver.PointFactors(p=jnp.asarray(p), target=jnp.asarray(target),
                               mask=jnp.asarray(mask))
    f_t = solver.PointFactors(p=_t(p)[None], target=_t(target)[None],
                              mask=_t(mask)[None])
    q0 = np.asarray([0.999, 0.02, 0.0, 0.0], np.float32)
    q0 /= np.linalg.norm(q0)
    t0 = np.zeros(3, np.float32)
    r_j, j_j = jsolver.point_residuals(f_j, jnp.asarray(q0), jnp.asarray(t0))
    r_t, j_t = solver.point_residuals(f_t, _t(q0)[None], _t(t0)[None])
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), atol=1e-5)
    np.testing.assert_allclose(j_t[0].numpy(), np.asarray(j_j), atol=1e-5)
    q_j, t_j, st_j = jsolver.lm_solve((f_j,), jnp.asarray(q0),
                                      jnp.asarray(t0), 4)
    q_t, t_t, st_t = solver.lm_solve((f_t,), _t(q0)[None], _t(t0)[None], 4)
    np.testing.assert_allclose(q_t[0].numpy(), np.asarray(q_j), atol=2e-5)
    np.testing.assert_allclose(t_t[0].numpy(), np.asarray(t_j), atol=2e-4)
    assert int(st_t.n_factors[0]) == int(st_j.n_factors) == mask.sum()
    np.testing.assert_allclose(t_t[0].numpy(), t_true, atol=1e-3)
