"""The PyTorch port's single-stream path against the JAX package: the
``knn_select`` module, ``gridmap.knn`` / ``knn_b``, the association API,
``mapping.mapping_step``, the single-stream ``pipeline.step``, the
checkpoint and the CLI.

Both packages run on the CPU from the same numpy inputs: JAX under this
suite's conftest (Pallas kernels in interpret mode), the port through its
kernels' plain versions. The scene is stream 0 of tests/test_torch_mapping's
16-line one. One JAX ``step`` chain under jit (module fixture, with
``emit_registered``) supplies the states the stage tests start from.

Tolerances, each restated in its test: the select is bit-exact (JAX's own
contract for its kernel); gated 5-NN distances within 1e-5 (JAX's pin of
``knn_b`` to ``knn``); fits to f32 rounding (5e-4 on factor columns); map
poses within the 2.5e-2 that JAX allows between its own batched and single
paths, counts ±8 (the rounding-sensitive gates; see
tests/test_torch_mapping.py).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aloam_tpu import geometry as jgeo
from aloam_tpu import mapping as jmp
from aloam_tpu import pipeline as jpipe
from aloam_tpu import config as jconfig
from aloam_tpu.io import synthetic as syn
from aloam_tpu.ops import gridmap as jgrid
from aloam_tpu.ops.pallas_knn import knn_select as j_knn_select
from aloam_tpu.utils import checkpoint as jckpt
from aloam_tpu_torch import cli
from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import mapping as mp
from aloam_tpu_torch import pipeline as tp
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.frontend.voxel import voxel_downsample_masked_b
from aloam_tpu_torch.ops import assoc as assoc_op
from aloam_tpu_torch.ops import gridmap
from aloam_tpu_torch.ops import knn as knn_op
from aloam_tpu_torch.types import PointCloud
from aloam_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

# the 16-line test scene of tests/test_batched_kernels.py, with the
# registered cloud on (it changes nothing else)
CFG = AloamConfig(
    scan_lines=16, minimum_range=0.3,
    line_resolution=0.2, plane_resolution=0.4,
    n_raw=4096, ring_cap=256, less_flat_cap=2048,
    map_table_corner=1024, map_table_surf=2048,
    corner_stack_cap=256, surf_stack_cap=1024, emit_registered=True,
)


def _jcfg(cfg):
    """The JAX package's config with the same fields: port functions get
    the port's config, JAX functions the JAX package's."""
    return jconfig.AloamConfig(**dataclasses.asdict(cfg))


JCFG = _jcfg(CFG)
N_FRAMES = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _scene():
    """(F, n_raw, 3) xyz, (F, n_raw) mask: stream 0 of the scene of
    tests/test_torch_mapping.py (seed 30, 1 m/s)."""
    scans, _ = syn.make_sequence(N_FRAMES, scan_lines=CFG.scan_lines,
                                 n_azimuth=256, seed=30, speed=1.0)
    pads = [syn.pad_scan(s, CFG.n_raw) for s in scans]
    return np.stack([p[0] for p in pads]), np.stack([p[1] for p in pads])


@pytest.fixture(scope="module")
def jax_run():
    """JAX's single-stream step under jit over the scene: the states
    before and after each frame (numpy leaves) and each frame's outputs."""
    xyz, mask = _scene()
    step = jax.jit(lambda s, x, m: jpipe.step(s, x, m, JCFG))
    st = jpipe.init_state(JCFG)
    states, outs = [_np(st)], []
    for f in range(N_FRAMES):
        st, out = step(st, xyz[f], mask[f])
        states.append(_np(st))
        outs.append(_np(out))
    return xyz, mask, states, outs


def _grid1(g):
    """A JAX single-stream grid (numpy leaves) as the port's (H, ·) one."""
    return gridmap.GridMap(pts=_t(g.pts), aux=_t(g.aux))


def _world(q, t, pts):
    return (geo.qrot(_t(q), _t(pts)) + _t(t)).numpy()


def _queries(jax_run, frame):
    """Frame ``frame``'s live less-flat points, taken to the map frame by
    the chain's mapped pose: queries near the map's entries."""
    _, _, states, outs = jax_run
    surf = states[frame + 1].odom.surf_last
    pts = np.asarray(surf.xyz)[np.asarray(surf.mask)]
    return _world(outs[frame].q_map, outs[frame].t_map, pts)


# --- knn_select -------------------------------------------------------------

def _knn_rows(rng, bw, n_rows=40, n=192):
    """Random block-planar rows with exact ties (repeated candidates, two
    queries on one point) and some _FAR slots; row ids per query, poisoned
    queries among them."""
    cand = rng.uniform(-1.0, 1.0, size=(n_rows, 8, 3, bw)).astype(np.float32)
    cand[:, 3, :, : bw // 2] = cand[:, 0, :, : bw // 2]     # exact ties
    cand[rng.uniform(size=(n_rows, 8)) < 0.15] = 1e9        # _FAR buckets
    row = rng.integers(0, n_rows, size=n).astype(np.int32)
    q = np.zeros((n, 4), np.float32)
    q[:, :3] = rng.uniform(-0.8, 0.8, size=(n, 3))
    q[::7, 3] = 1.0                                         # poisoned
    q[1::11, :3] = cand[row[1::11], 0, :, 0]                # d2 = 0 picks
    q[1::11, 3] = 0.0
    return cand.reshape(n_rows, 24 * bw), row, q


def _select_ref(cand, row, q, k=5):
    """numpy k-pass select with every operation rounded on its own (numpy
    contracts no multiply-add)."""
    crow = cand[row].reshape(len(row), 8, 3, -1)
    xs, ys, zs = (crow[:, :, c].reshape(len(row), -1) for c in range(3))
    dx, dy, dz = xs - q[:, 0:1], ys - q[:, 1:2], zs - q[:, 2:3]
    d2 = (dx * dx + dy * dy) + dz * dz
    d2[q[:, 3] > 0] = np.inf
    ds, nb, ii = [], [], np.arange(len(row))
    for _ in range(k):
        am = np.argmin(d2, axis=1)
        ds.append(d2[ii, am])
        nb.append(np.stack([xs[ii, am], ys[ii, am], zs[ii, am]], -1))
        d2[ii, am] = np.inf
    return np.stack(ds, -1), np.stack(nb, -2)


@pytest.mark.parametrize("bw", [32, 48])
def test_knn_select_plain_matches_jax_kernel(rng, bw):
    """knn_select_plain on seeded rows with poisoned queries (+inf rows
    picking index 0 five times) and exact ties (lowest index first):
    bit-exact against the separately rounded numpy select (what the CUDA
    kernel computes); against JAX's Pallas kernel (interpret mode) the
    picks exact (neighbours bit-equal) and d2 within 2 ulps, because XLA
    on the CPU contracts the two multiply-adds (JAX's own pin of its
    kernel is rtol 1e-6, tests/test_batched_kernels.py:223). The plain version's
    chunking changes nothing."""
    cand, row, q = _knn_rows(rng, bw)
    d2, nb = knn_op.knn_select_plain(_t(cand), _t(row), _t(q), 5)
    rd2, rnb = _select_ref(cand, row, q)
    np.testing.assert_array_equal(d2.numpy(), rd2)
    np.testing.assert_array_equal(nb.numpy(), rnb)
    jd2, jnb = (np.asarray(a) for a in j_knn_select(
        jnp.asarray(cand[row]), jnp.asarray(q), k=5, tq=64, bw=bw,
        interpret=True))
    np.testing.assert_array_equal(nb.numpy(), jnb)
    fin = np.isfinite(jd2)
    np.testing.assert_array_equal(np.isfinite(d2.numpy()), fin)
    np.testing.assert_array_max_ulp(d2.numpy()[fin], jd2[fin], maxulp=2)
    assert np.isinf(d2.numpy()[q[:, 3] > 0]).all()
    assert (d2.numpy()[1::11, 0] == 0).all()
    d2c, nbc = knn_op.knn_select_plain(_t(cand), _t(row), _t(q), 5, chunk=50)
    assert torch.equal(d2c, d2) and torch.equal(nbc, nb)
    # the wrapper takes the plain version for CPU tensors
    d2w, nbw = knn_op.knn_select(_t(cand), _t(row), _t(q), 5)
    assert torch.equal(d2w, d2) and torch.equal(nbw, nb)
    assert knn_op.launches == 0


# --- gridmap.knn / knn_b ---------------------------------------------------

def _gated_match(d2, nb, jd2, jnb, gate=1.0):
    """Gated 5-NN agree: which slots pass the gate exactly, their
    distances and neighbours within 1e-5."""
    d2, nb, jd2, jnb = (np.asarray(a) for a in (d2, nb, jd2, jnb))
    g = d2 < gate
    np.testing.assert_array_equal(g, jd2 < gate)
    np.testing.assert_allclose(d2[g], jd2[g], atol=1e-5, rtol=0)
    np.testing.assert_allclose(nb[g], jnb[g], atol=1e-5, rtol=0)
    return g


def test_knn_and_knn_b_match_jax(jax_run):
    """gridmap.knn (knn_b at B = 1 with cell_cap = Q) and knn_b against
    JAX's knn and knn_b on the map after frame 2, with frame 2's queries
    and some far from any map entry: the gated 5-NN within 1e-5 (JAX's
    pin of knn_b to knn, tests/test_batched_kernels.py:216); knn_b at a
    cell cap of 32 spills as many queries as JAX's. Slots past
    the gate differ by design: a duplicate bucket is +inf in JAX's knn and
    at the _FAR sentinel in knn_b."""
    _, _, states, _ = jax_run
    grid = states[2].map.surf
    q = _queries(jax_run, 2)[:600]
    q = np.concatenate([q, q[:40] + np.float32(30.0)]).astype(np.float32)
    d2, nb = gridmap.knn(_grid1(grid), _t(q), 5, CFG.knn_cell,
                         CFG.knn_radius)
    jd2, jnb = jax.jit(lambda g, qq: jgrid.knn(
        g, qq, 5, CFG.knn_cell, CFG.knn_radius))(grid, q)
    g = _gated_match(d2, nb, jd2, jnb)
    assert g[:, 4].sum() > 100 and not g[-40:].any()

    g1 = jax.tree.map(lambda x: x[None], grid)
    bd2, bnb, bsp = gridmap.knn_b(
        gridmap.GridMap(_t(g1.pts), _t(g1.aux)), _t(q[None]), 5,
        CFG.knn_cell, CFG.knn_radius, cell_cap=32)
    jb = jax.jit(lambda gg, qq: jgrid.knn_b(
        gg, qq, 5, CFG.knn_cell, CFG.knn_radius, cell_cap=32))(g1, q[None])
    _gated_match(bd2[0], bnb[0], jb[0][0], jb[1][0])
    assert int(bsp.sum()) == int(jb[2]) > 0


# --- the association API -----------------------------------------------------

def _plane_err(n, d, nbrs, sel):
    """|residual at the query| of a plane (n, d) against the f64
    least-squares plane A n = -1 through the same five neighbours."""
    n64 = np.stack([np.linalg.lstsq(a, -np.ones(5), rcond=None)[0]
                    for a in nbrs.astype(np.float64)])
    norm = np.linalg.norm(n64, axis=1)
    r64 = (n64 * sel).sum(-1) / norm + 1.0 / norm
    return np.abs((n * sel).sum(-1) + d - r64)


@pytest.mark.parametrize("kind", ["corner", "surf"])
def test_associations_b_match_jax(jax_run, kind):
    """corner_associations_b / surf_associations_b (input-ordered stacks
    through the knn cache) against JAX's at B = 1 on the map after frame
    1, with frame 2's downsampled stack and initial pose guess. The
    neighbours the fits see: gated distances and points within 1e-5.
    Mask flags agree on >= 98% (near-degenerate fits flip on rounding; JAX's
    own kernel and XLA branches agree on 98.7% of surf flags, see
    tests/test_torch_mapping.py).
    Corner factors (a, b) within 5e-4 where live in both. Surf planes: the
    f32 normal equations of A n = -1 are ill-conditioned on map data
    (condition numbers 1e3-1e4 here), so both packages' planes sit up to
    ~0.1 m from the f64 least-squares plane at the query, and from each
    other; the port's is held to JAX's accuracy there: the median, the
    95th percentile and the largest of its errors within 2x JAX's + 5e-4
    (measured 1.2 mm vs 0.75 mm median, 0.126 m vs 0.115 m largest: XLA
    contracts multiply-adds in the normal equations, while the port rounds
    every operation, as its CUDA kernel must to stay bit-equal). At
    map_cell_cap 64 both spill the same queries, which get no factors."""
    _, _, states, _ = jax_run
    prev, st = states[1], states[2]
    cloud = st.odom.corner_last if kind == "corner" else st.odom.surf_last
    leaf, cap = ((CFG.line_resolution, CFG.corner_stack_cap)
                 if kind == "corner" else
                 (CFG.plane_resolution, CFG.surf_stack_cap))
    vals = np.concatenate([cloud.xyz, cloud.intensity[:, None]], -1)[None]
    ds, m, _ = voxel_downsample_masked_b(_t(vals), _t(cloud.mask[None]),
                                         leaf, cap)
    stack, m = ds[..., :3].numpy(), m.numpy()
    qc = _t(prev.map.q_wmap_wodom)
    q = geo.qmul(qc, _t(st.odom.q_w)).numpy()[None]
    t = (geo.qrot(qc, _t(st.odom.t_w))
         + _t(prev.map.t_wmap_wodom)).numpy()[None]
    g1 = jax.tree.map(lambda x: x[None], getattr(prev.map, kind))
    tg = gridmap.GridMap(_t(g1.pts), _t(g1.aux))
    jfn = jmp.corner_associations_b if kind == "corner" \
        else jmp.surf_associations_b
    tfn = mp.corner_associations_b if kind == "corner" \
        else mp.surf_associations_b
    jf, jsp, jc = jax.jit(lambda *a: jfn(*a, JCFG))(stack, m, g1, q, t)
    tf, tsp, cache = tfn(_t(stack), _t(m), tg, _t(q), _t(t), CFG)
    assert int(tsp.sum()) == int(jsp) == 0

    sel = _world(q[0], t[0], stack[0])
    cid = np.where(m, np.asarray(jc.cid), jc.cell_cap)
    jd2, jnb, _ = jgrid.knn_from_cache_b(jc._replace(cid=cid), sel[None], 5)
    td2, tnb, _ = gridmap.knn_from_cache_b(
        cache._replace(cid=torch.where(_t(m), cache.cid, cache.cell_cap)),
        _t(sel[None]), 5)
    _gated_match(td2[0], tnb[0], jd2[0], jnb[0])

    got_m, want_m = tf.mask.numpy()[0], np.asarray(jf.mask)[0]
    assert np.mean(got_m == want_m) >= 0.98
    live = got_m & want_m
    assert live.sum() > 20
    if kind == "corner":
        for c in ("a", "b"):
            np.testing.assert_allclose(getattr(tf, c).numpy()[0][live],
                                       np.asarray(getattr(jf, c))[0][live],
                                       atol=5e-4, err_msg=c)
    else:
        nb = tnb.numpy()[0][live]
        et = _plane_err(tf.n.numpy()[0][live], tf.d.numpy()[0][live], nb,
                        sel[live])
        ej = _plane_err(np.asarray(jf.n)[0][live],
                        np.asarray(jf.d)[0][live], nb, sel[live])
        for qt in (0.5, 0.95, 1.0):
            assert np.quantile(et, qt) <= 2 * np.quantile(ej, qt) + 5e-4, \
                (qt, np.quantile(et, qt), np.quantile(ej, qt))
    # the cache is reusable as it is
    tf2, _, _ = tfn(_t(stack), _t(m), None, _t(q), _t(t), CFG, cache=cache)
    assert torch.equal(tf2.mask, tf.mask)

    cfg = CFG.replace(map_cell_cap=64)
    jf, jsp, _ = jax.jit(lambda *a: jfn(*a, _jcfg(cfg)))(stack, m, g1, q, t)
    tf, tsp, cache = tfn(_t(stack), _t(m), tg, _t(q), _t(t), cfg)
    assert int(tsp.sum()) == int(jsp) > 0
    spilled = cache.cid.numpy()[0] >= 64
    assert not tf.mask.numpy()[0][spilled].any()
    assert not np.asarray(jf.mask)[0][spilled].any()


# --- plain stays plain -------------------------------------------------------

def test_plain_paths_never_reach_the_knn_kernel(jax_run, monkeypatch):
    """The batched path's plain association (assoc_cell_plain) and
    mapping_step_b run the plain select directly, never the dispatching
    knn_select (which would launch the kernel for CUDA tensors); the
    single-stream mapping_step does go through it."""
    xyz, mask, _, _ = jax_run

    def boom(*a, **kw):
        raise AssertionError("knn_select called")

    monkeypatch.setattr(knn_op, "knn_select", boom)
    st = tp.init_state(CFG, 1, "cpu")
    for f in range(2):
        st, out = tp.step_b(st, _t(xyz[f][None]), _t(mask[f][None]), CFG)
    assert out.metrics[0, tp.METRIC_NAMES.index("map_surf_factors")] > 50
    cand = torch.rand(300, 24 * 16)
    q8 = torch.zeros(256, 8)
    assoc_op.assoc_cell_plain(cand, torch.zeros(1, dtype=torch.int32), q8,
                              "surf", 1.0)
    with pytest.raises(AssertionError, match="knn_select called"):
        tp.step(st, _t(xyz[2]), _t(mask[2]), CFG)


# --- mapping_step --------------------------------------------------------------

def test_mapping_step_matches_jax(jax_run):
    """mapping_step from JAX's single-stream map state after frame 1 with
    frame 2's odometry handoff, against the chain's frame-2 map: poses
    within 2.5e-2, factor counts ±8, the solve gate and the overflow count
    exact (no spill term: knn cannot spill), cache_crossed ±16, live map
    entries within ±8 or 3% (see tests/test_torch_mapping.py)."""
    _, _, states, outs = jax_run
    st1, st2 = states[1], states[2]
    o = st2.odom
    clouds = [PointCloud(xyz=_t(c.xyz)[None], intensity=_t(c.intensity)[None],
                         mask=_t(c.mask)[None])
              for c in (o.corner_last, o.surf_last)]
    state = tp.state_from_numpy(st1, "cpu").map
    got, tm = mp.mapping_step(state, *clouds, _t(o.q_w)[None],
                              _t(o.t_w)[None], CFG)
    for name in ("q_w", "t_w", "q_wmap_wodom", "t_wmap_wodom"):
        np.testing.assert_allclose(getattr(got, name).numpy()[0],
                                   getattr(st2.map, name), atol=2.5e-2,
                                   err_msg=name)
    jm = jpipe.metrics_dict(outs[1].metrics)
    assert tm.solved.numpy().tolist() == [True] and jm["map_solved"] == 1
    for name, val in (("map_corner_factors", tm.corner_factors),
                      ("map_surf_factors", tm.surf_factors)):
        assert abs(int(val) - jm[name]) <= 8, (name, int(val), jm[name])
    assert int(tm.overflow) == jm["map_overflow"]
    assert abs(int(tm.cache_crossed) - jm["map_cache_crossed"]) <= 16
    assert int(tm.surf_factors) > 50
    for kind in ("corner", "surf"):
        g = np.asarray(getattr(got, kind).aux)[0]
        w = np.asarray(getattr(st2.map, kind).aux)
        bk = w.shape[-1] // 5
        ng = (g[:, bk:2 * bk] != gridmap._EMPTY).sum()
        nw = (w[:, bk:2 * bk] != gridmap._EMPTY).sum()
        assert abs(ng - nw) <= max(8, 0.03 * nw), (kind, ng, nw)


def test_extract_surround_matches_jax(jax_run):
    """extract_surround of the map after frame 3: the same points as
    JAX's, in the same order."""
    _, _, states, _ = jax_run
    jst = states[-1]
    corner, surf = mp.extract_surround(tp.state_from_numpy(jst, "cpu").map,
                                       CFG)
    jc, js = jmp.extract_surround(jax.tree.map(jnp.asarray, jst.map), JCFG)
    np.testing.assert_array_equal(corner[0], jc)
    np.testing.assert_array_equal(surf[0], js)
    assert len(surf[0]) > 100


# --- the single-stream step ----------------------------------------------------

def test_step_matches_jax_chain(jax_run):
    """The port's step over 3 frames from the initial state against JAX's
    jitted single-stream step: q_odom / t_odom within 5e-4 (the bound JAX
    holds its batched odometry to its single one,
    tests/test_batched_kernels.py:416), q_map / t_map and the
    high-frequency pose within 2.5e-2; the metrics' keys equal JAX's
    metrics_dict; feature counts and map_solved exact, costs rtol 5e-2 +
    atol 1e-3, map_cache_crossed within ±16 (it counts queries whose base
    cell moves between the rounds, and so follows the map pose, as in
    tests/test_torch_mapping.py), every other count within ±8 or 3%. The registered cloud:
    the slot mask exact; frame 0's points (identity map pose in both)
    within 1e-5 of JAX's; later frames' points JAX's taken through the
    pose difference, within 1e-4."""
    xyz, mask, _, outs = jax_run
    st = tp.init_state(CFG, 1, "cpu")
    exact = ("n_sharp", "n_flat", "n_less_sharp", "n_less_flat",
             "map_solved")
    for f in range(N_FRAMES):
        st, out = tp.step(st, _t(xyz[f]), _t(mask[f]), CFG)
        want = outs[f]
        for name, atol in (("q_odom", 5e-4), ("t_odom", 5e-4),
                           ("q_map", 2.5e-2), ("t_map", 2.5e-2),
                           ("q_hf", 2.5e-2), ("t_hf", 2.5e-2)):
            got = getattr(out, name).numpy()
            assert got.shape == np.shape(getattr(want, name))
            np.testing.assert_allclose(got, getattr(want, name), atol=atol,
                                       err_msg=f"{name} {f}")
        got_m, want_m = tp.metrics_dict(out.metrics), \
            jpipe.metrics_dict(want.metrics)
        assert tuple(got_m) == tuple(want_m)
        for name, g in got_m.items():
            w = want_m[name]
            msg = f"frame {f} {name}: {g} vs {w}"
            if name in exact:
                assert g == w, msg
            elif name == "odom_cost":
                np.testing.assert_allclose(g, w, rtol=5e-2, atol=1e-3,
                                           err_msg=msg)
            elif name == "map_cache_crossed":
                assert abs(g - w) <= 16, msg
            else:
                assert abs(g - w) <= max(8, 0.03 * w), msg

        reg, jreg = out.registered.numpy(), want.registered
        np.testing.assert_array_equal(out.registered_mask.numpy(),
                                      want.registered_mask)
        m = want.registered_mask
        if f == 0:
            np.testing.assert_allclose(reg[m], jreg[m], atol=1e-5, rtol=0)
        else:
            p = jgeo.qrot_inv(want.q_map, jreg[m] - want.t_map)
            np.testing.assert_allclose(
                reg[m], _world(out.q_map, out.t_map, np.asarray(p)),
                atol=1e-4, rtol=0)
    assert st.frame == N_FRAMES and st.odom.q_w.shape == (1, 4)
    assert np.linalg.norm(out.t_odom.numpy()) > 0.05
    assert got_m["map_solved"] == 1 and got_m["map_surf_factors"] > 50


def test_run_sequence_and_make_step_fn(jax_run):
    """run_sequence is the host loop of step (outputs stacked along a
    leading frame axis, equal to stepping by hand with make_step_fn's
    closure); scan=True has no counterpart and raises."""
    xyz, mask, _, _ = jax_run
    cfg = CFG.replace(emit_registered=False)
    st, outs = tp.run_sequence(tp.init_state(cfg, 1, "cpu"), _t(xyz[:2]),
                               _t(mask[:2]), cfg)
    assert outs.q_map.shape == (2, 4) and outs.registered is None
    assert outs.metrics.shape == (2, len(tp.METRIC_NAMES))
    fn = tp.make_step_fn(cfg)
    st2 = tp.init_state(cfg, 1, "cpu")
    for f in range(2):
        st2, out = fn(st2, _t(xyz[f]), _t(mask[f]))
    assert torch.equal(out.t_map, outs.t_map[1])
    assert torch.equal(st2.map.surf.pts, st.map.surf.pts)
    with pytest.raises(ValueError, match="scan=True"):
        tp.run_sequence(st, _t(xyz[:1]), _t(mask[:1]), cfg, scan=True)


# --- checkpoint ------------------------------------------------------------------

def test_checkpoint_moves_between_packages(jax_run, tmp_path):
    """A JAX single-path checkpoint (after frame 2) loads into the port
    bit for bit and steps frame 3 to JAX's frame-3 pose (odometry within
    5e-4, map within 2.5e-2); the port's checkpoint of that state is the
    JAX file format (20 leaves, no stream axis) and loads back into JAX
    and into the port unchanged."""
    xyz, mask, states, outs = jax_run
    jst = jax.tree.map(jnp.asarray, states[2])
    path = str(tmp_path / "jax_state.npz")
    jckpt.save(path, jst)
    st = ckpt.load(path, tp.init_state(CFG, 1, "cpu"))
    assert st.frame == 2 and st.odom.initialized.dtype == torch.bool
    ref = tp.state_from_numpy(states[2], "cpu")
    for a, b in zip(ckpt._leaves(st), ckpt._leaves(ref)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)

    path2 = str(tmp_path / "port_state.npz")
    ckpt.save(path2, st)
    with np.load(path2) as z:
        assert int(z["n_leaves"]) == 20
        assert z["leaf_0"].shape == (4,) and z["leaf_19"].shape == ()
    back = jckpt.load(path2, jpipe.init_state(JCFG))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    again = ckpt.load(path2, tp.init_state(CFG, 1, "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(ckpt._leaves(again)[:-1],
                                                 ckpt._leaves(st)[:-1]))

    st, out = tp.step(st, _t(xyz[2]), _t(mask[2]), CFG)
    for name, atol in (("t_odom", 5e-4), ("q_odom", 5e-4),
                       ("t_map", 2.5e-2), ("q_map", 2.5e-2)):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   getattr(outs[2], name), atol=atol,
                                   err_msg=name)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load(path2, tp.init_state(CFG, 1, "cpu")._replace(frame=()))


# --- the CLI -------------------------------------------------------------------

def test_cli_runs_end_to_end_and_resumes(tmp_path):
    """cli.main on the CPU at the VLP-16 preset over 3 synthetic frames:
    every output file written, metrics.jsonl one record per frame with
    JAX's metric names, eval.json's ATE finite and small; a run resumed
    from the frame-2 checkpoint with --skip-first 2 gives frame 3's pose
    exactly; --device cuda without a card exits non-zero."""
    out = tmp_path / "run"
    base = ["--device", "cpu", "--preset", "VLP-16", "--synthetic"]
    cli.main(base + ["--frames", "3", "--checkpoint-every", "2",
                     "--surround-every", "3", "--map-every", "3",
                     "--dump-rings", "0", "--out", str(out)])
    for name in ("metrics.jsonl", "trajectory.npz", "trajectory_tum.txt",
                 "eval.json", "state_000002.npz", "surround_000003.npz",
                 "map_000003.npz", "rings_000000.npz"):
        assert (out / name).exists(), name
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["frame"] for r in recs] == [0, 1, 2]
    assert set(jpipe.METRIC_NAMES) <= set(recs[-1])
    assert recs[-1]["map_solved"] == 1
    ev = json.load(open(out / "eval.json"))
    assert ev["frames"] == 3 and 0 <= ev["ate_rmse_m"] < 0.5
    assert len(open(out / "trajectory_tum.txt").read().splitlines()) == 3
    with np.load(out / "map_000003.npz") as z:
        assert len(z["surf"]) > 100

    res = tmp_path / "resumed"
    cli.main(base + ["--frames", "3", "--skip-first", "2", "--resume",
                     str(out / "state_000002.npz"), "--out", str(res)])
    with np.load(out / "trajectory.npz") as a, \
            np.load(res / "trajectory.npz") as b:
        assert b["t_map"].shape == (1, 3)
        np.testing.assert_array_equal(b["t_map"][0], a["t_map"][2])
        np.testing.assert_array_equal(b["q_map"][0], a["q_map"][2])

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            cli.main(["--device", "cuda", "--synthetic", "--frames", "1",
                      "--out", str(tmp_path / "gpu")])
        assert not os.path.exists(tmp_path / "gpu")
