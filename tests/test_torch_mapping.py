"""The PyTorch port's mapping stage and full ``step_b`` against the JAX
package.

Both packages run on the CPU from the same numpy inputs: JAX under this
suite's conftest (Pallas kernels in interpret mode), the port through its
kernels' plain versions (a CPU tensor never reaches a CUDA kernel). The
scene and config are tests/test_torch_slice.py's 16-line ones (B = 3).
One JAX ``step_b`` chain under jit (module fixture) supplies the map
states and handoff clouds the stage tests start from.

Tolerances, each restated in its test: integer outputs, hashes, tables
and the insert merge are exact; fits agree to f32 rounding through the
closed-form eigen/solve (5e-4 on factor columns); the mapping solve sits
behind three rounding-sensitive gates (1 m² knn gate, eigen ratio, 0.2 m
plane inliers), so poses get the 2.5e-2 that JAX allows between its own
batched and single paths (tests/test_batched_kernels.py) and counts ±8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aloam_tpu import mapping as jmp
from aloam_tpu import pipeline as jpipe
from aloam_tpu import config as jconfig
from aloam_tpu.frontend.voxel import voxel_downsample_masked_b as j_vds_b
from aloam_tpu.io import synthetic as syn
from aloam_tpu.ops import gridmap as jgrid
from aloam_tpu.ops import linalg3 as jlin
from aloam_tpu.ops.pallas_assoc import assoc_cell as j_assoc_cell
from aloam_tpu.ops.pallas_assoc import assoc_xla as j_assoc_xla
from aloam_tpu.ops.pallas_insert import merge_tiles as j_merge_tiles
from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import mapping as mp
from aloam_tpu_torch import pipeline as tp
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.frontend.voxel import voxel_downsample_masked_b
from aloam_tpu_torch.ops import assoc as assoc_op
from aloam_tpu_torch.ops import gridmap
from aloam_tpu_torch.ops import insert as insert_op
from aloam_tpu_torch.ops import linalg3
from aloam_tpu_torch.types import PointCloud

torch.set_num_threads(1)

# the 16-line test scene of tests/test_batched_kernels.py
CFG = AloamConfig(
    scan_lines=16, minimum_range=0.3,
    line_resolution=0.2, plane_resolution=0.4,
    n_raw=4096, ring_cap=256, less_flat_cap=2048,
    map_table_corner=1024, map_table_surf=2048,
    corner_stack_cap=256, surf_stack_cap=1024,
)


def _jcfg(cfg):
    """The JAX package's config with the same fields: port functions get
    the port's config, JAX functions the JAX package's."""
    return jconfig.AloamConfig(**dataclasses.asdict(cfg))


JCFG = _jcfg(CFG)
B = 3
N_FRAMES = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _scene():
    xyz, mask = [], []
    for b in range(B):
        scans, _ = syn.make_sequence(N_FRAMES, scan_lines=CFG.scan_lines,
                                     n_azimuth=256, seed=30 + b,
                                     speed=1.0 + 0.5 * b)
        pads = [syn.pad_scan(s, CFG.n_raw) for s in scans]
        xyz.append(np.stack([p[0] for p in pads]))
        mask.append(np.stack([p[1] for p in pads]))
    return np.stack(xyz, axis=1), np.stack(mask, axis=1)


def _jax_init():
    st = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                      jpipe.init_state(JCFG))
    return st._replace(frame=jnp.zeros((B,), jnp.int32))


@pytest.fixture(scope="module")
def jax_run():
    """JAX step_b under jit over the scene: the states after each frame
    (numpy leaves) and each frame's outputs."""
    xyz, mask = _scene()
    step = jax.jit(lambda s, x, m: jpipe.step_b(s, x, m, JCFG))
    st = _jax_init()
    states, outs = [_np(st)], []
    for f in range(N_FRAMES):
        st, out = step(st, xyz[f], mask[f])
        states.append(_np(st))
        outs.append(_np(out))
    return xyz, mask, states, outs


def _grid_t(g):
    return gridmap.GridMap(pts=_t(g.pts), aux=_t(g.aux))


def _grid_eq(got: gridmap.GridMap, want, msg=""):
    np.testing.assert_array_equal(got.pts.numpy(), np.asarray(want.pts),
                                  err_msg=msg)
    np.testing.assert_array_equal(got.aux.numpy(), np.asarray(want.aux),
                                  err_msg=msg)


def _live(g) -> np.ndarray:
    """Live map entries per stream of a (B, H, 5·Bk) aux table."""
    aux = np.asarray(g.aux)
    bk = aux.shape[-1] // 5
    return (aux[..., bk:2 * bk] != gridmap._EMPTY).sum(axis=(1, 2))


# --- linalg3 ----------------------------------------------------------------

def test_linalg3_matches_jax(rng):
    """eigh3 on seeded covariances (random, line-like and planar 5-point
    neighbourhoods) and solve3 on well-conditioned systems: eigenvalues
    atol 1e-5 + rtol 1e-4, unit eigenvectors atol 1e-4 (acos/cos round
    differently in the two libraries), solutions rtol 1e-5."""
    pts = rng.normal(size=(300, 5, 3)).astype(np.float32)
    pts[100:200] *= np.array([1.0, 0.05, 0.05], np.float32)   # lines
    pts[200:] *= np.array([1.0, 1.0, 0.02], np.float32)       # planes
    d = pts - pts.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", d, d).astype(np.float32)
    vals_t, vec_t = linalg3.eigh3(_t(cov))
    vals_j, vec_j = jlin.eigh3(jnp.asarray(cov))
    np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(vec_t.numpy(), np.asarray(vec_j), atol=1e-4)
    # the trig closed form is accurate to f32 relative to the largest
    # eigenvalue (small ones lose digits to cancellation, in both packages)
    vals_np = np.linalg.eigvalsh(cov.astype(np.float64))
    err = np.abs(vals_t.numpy() - vals_np) / vals_np[:, 2:]
    assert err.max() < 1e-4, err.max()

    a = rng.normal(size=(200, 3, 3)).astype(np.float32) \
        + 4.0 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(200, 3)).astype(np.float32)
    got = linalg3.solve3(_t(a), _t(b), reg=1e-9).numpy()
    np.testing.assert_allclose(got, np.asarray(jlin.solve3(a, b, reg=1e-9)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.linalg.solve(a, b[..., None])[..., 0],
                               rtol=1e-4, atol=1e-5)


# --- assoc_cell ---------------------------------------------------------------

def _assoc_data(rng, tq, bw, n_cells, poison=True, far=True):
    """Cell-sorted queries over random candidate rows
    (tests/test_batched_kernels.py:500-595)."""
    n = 4 * tq
    pad_rows = n_cells + tq + 8
    cand = rng.uniform(-1.0, 1.0, size=(pad_rows, 8, 3, bw)).astype(
        np.float32)
    if far:
        cand = np.where(rng.uniform(size=(pad_rows, 8, 1, bw)) < 0.1, 1e9,
                        cand).astype(np.float32)
    cand_flat = cand.reshape(pad_rows, 24 * bw)
    cid = np.sort(rng.integers(0, n_cells, size=n)).astype(np.int32)
    q = rng.uniform(-0.8, 0.8, size=(n, 3)).astype(np.float32)
    cid0 = cid[::tq].copy()
    local = cid - np.repeat(cid0, tq)
    q8 = np.zeros((n, 8), np.float32)
    q8[:, :3], q8[:, 4] = q, local
    if poison:
        q8[:, 3] = (rng.uniform(size=n) < 0.1).astype(np.float32)
    return cand_flat, cid0, q8, local


def test_assoc_cell_plain_matches_jax(rng):
    """On tie-free random rows: ok flags exact against JAX's kernel
    (interpret mode) and its XLA fit, live factor columns within 5e-4
    (the scalar-expanded and einsum fits round differently), the 5th
    distance within 5e-7 relative (XLA fuses the d2 sum and rounds it
    once less in places)."""
    tq, bw = 64, 16
    cand_flat, cid0, q8, _ = _assoc_data(rng, tq, bw, 40)
    for kind, okc, ncol in (("surf", 4, 4), ("corner", 6, 6)):
        got = assoc_op.assoc_cell(_t(cand_flat), _t(cid0), _t(q8), kind,
                                  1.0, tq=tq).numpy()
        ker = np.asarray(j_assoc_cell(
            jnp.asarray(cand_flat), jnp.asarray(cid0), jnp.asarray(q8), kind,
            1.0, tq=tq, bw=bw, interpret=True))
        np.testing.assert_array_equal(got[:, okc], ker[:, okc], err_msg=kind)
        live = got[:, okc] > 0
        assert live.sum() > 20, kind
        np.testing.assert_allclose(got[live][:, :ncol], ker[live][:, :ncol],
                                   atol=5e-4, err_msg=kind)
        np.testing.assert_allclose(got[:, okc + 1], ker[:, okc + 1],
                                   rtol=5e-7, atol=0)

        # the fit alone, from JAX's own select on the same rows
        row = cid0.repeat(tq) + q8[:, 4].astype(np.int64)
        d2, near, _ = gridmap.knn_from_cache_b(
            gridmap.KnnCache(_t(cand_flat)[None],
                             _t(np.where(q8[:, 3] > 0, len(cand_flat),
                                         row))[None], None, None,
                             len(cand_flat)), _t(q8[None, :, :3]), 5)
        xla = np.asarray(j_assoc_xla(jnp.asarray(d2[0].numpy()),
                                     jnp.asarray(near[0].numpy()), 1.0,
                                     kind))
        np.testing.assert_array_equal(xla[:, okc], got[:, okc])
        np.testing.assert_allclose(got[live][:, :ncol], xla[live][:, :ncol],
                                   atol=5e-4)


def test_assoc_cell_plain_cspan_window(rng):
    """cspan < tq clips each tile's cell window: queries inside it are
    bit-equal to the full-window run, queries past align8(cid0) + cspan +
    8 come back gated; ok flags equal JAX's kernel with the same clip."""
    tq, bw, cspan = 64, 16, 16
    cand_flat, cid0, q8, local = _assoc_data(rng, tq, bw, 200,
                                             poison=False, far=False)
    args = (_t(cand_flat), _t(cid0), _t(q8), "surf", 1.0)
    full = assoc_op.assoc_cell(*args, tq=tq).numpy()
    clip = assoc_op.assoc_cell(*args, tq=tq, cspan=cspan).numpy()
    rem = cid0 - 8 * (cid0 // 8)
    spilled = (local + np.repeat(rem, tq)) >= cspan + 8
    assert spilled.any() and (~spilled).any()
    np.testing.assert_array_equal(clip[~spilled], full[~spilled])
    assert not clip[spilled][:, 4].any(), "cspan spill leaked factors"
    ker = np.asarray(j_assoc_cell(
        jnp.asarray(cand_flat), jnp.asarray(cid0), jnp.asarray(q8), "surf",
        1.0, tq=tq, bw=bw, cspan=cspan, interpret=True))
    np.testing.assert_array_equal(clip[:, 4], ker[:, 4])


# --- merge_tiles ---------------------------------------------------------------

def test_merge_tiles_plain_bit_exact(rng):
    """Bit-exact against gridmap._merge_dense_xla and JAX's merge kernel
    (interpret mode): midpoints (last match wins), eviction-priority slot
    choices with their ties, recomputed cells and voxel ids, and the
    merged / appended / evicted counts (data of
    tests/test_batched_kernels.py:657-705)."""
    bsz, cap_c, cap_p, bk = 2, 40, 16, 48
    cell_size, leaf = 2.0, 0.4
    pts = rng.uniform(-20, 20, size=(bsz, cap_c, 3, bk)).astype(np.float32)
    occ = rng.uniform(size=(bsz, cap_c, bk)) > 0.4
    cell = np.floor(pts / cell_size).astype(np.int32)
    cell = np.where(occ[:, :, None, :], cell, gridmap._EMPTY)
    vox = np.floor(pts / leaf).astype(np.int32)
    vox = ((vox[:, :, 0] * 73856093) ^ (vox[:, :, 1] * 19349663)
           ^ (vox[:, :, 2] * 83492791))
    pts = np.where(occ[:, :, None, :], pts, 1e9).astype(np.float32)
    inten = rng.uniform(0, 1, size=(bsz, cap_c, bk)).astype(np.float32)
    pp = rng.uniform(-20, 20, size=(3, bsz, cap_c, cap_p)).astype(np.float32)
    ppi = rng.uniform(0, 1, size=(bsz, cap_c, cap_p)).astype(np.float32)
    pvox = ((np.floor(pp[0] / leaf).astype(np.int32) * 73856093)
            ^ (np.floor(pp[1] / leaf).astype(np.int32) * 19349663)
            ^ (np.floor(pp[2] / leaf).astype(np.int32) * 83492791))
    copy = rng.uniform(size=(bsz, cap_c, cap_p)) < 0.3
    which = rng.integers(0, bk, size=(bsz, cap_c, cap_p))
    pvox = np.where(copy, np.take_along_axis(vox, which, axis=2), pvox)
    cnt = rng.integers(0, cap_p + 4, size=(bsz, cap_c)).astype(np.int32)
    center = rng.integers(-4, 4, size=(bsz, 3)).astype(np.int32)
    window = np.array([5, 5, 3], np.int32)

    arrays = (pts.reshape(bsz, cap_c, 3 * bk), inten,
              cell.reshape(bsz, cap_c, 3 * bk), vox, pp[0], pp[1], pp[2],
              ppi, pvox, cnt, center, window)
    got = insert_op.merge_tiles(*map(_t, arrays), cell_size, leaf)
    jargs = [jnp.asarray(a) for a in arrays]
    names = ["px", "py", "pz", "int", "cx", "cy", "cz", "vox", "merged",
             "appended", "evicted"]
    for want in (jgrid._merge_dense_xla(*jargs, cell_size, leaf),
                 j_merge_tiles(*jargs, cell_size, leaf, interpret=True)):
        for nm, a, b in zip(names, got, want, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=nm)
    assert got[8].sum() > 0 and got[9].sum() > 0 and got[10].sum() > 0


# --- hashing and the table passes -------------------------------------------

def test_hash_and_vox_id_bit_exact(rng):
    """_hash and _vox_id equal JAX's int32-wraparound arithmetic bit for
    bit, on negative and large cell coordinates where the products
    overflow int32."""
    cells = np.concatenate([
        rng.integers(-40000, 40000, size=(500, 3)),
        rng.integers(-2 ** 31, 2 ** 31 - 1, size=(100, 3)),
        np.array([[0, 0, 0], [-1, -1, -1], [32767, -32768, 1],
                  [2 ** 31 - 1, -2 ** 31, 7]])]).astype(np.int32)
    for ts in (1024, 16384):
        np.testing.assert_array_equal(gridmap._hash(_t(cells), ts).numpy(),
                                      np.asarray(jgrid._hash(cells, ts)))
    pts = rng.uniform(-3000, 3000, size=(600, 3)).astype(np.float32)
    for leaf in (0.2, 0.4, 0.8):
        got = gridmap._vox_id(_t(pts), leaf)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jgrid._vox_id(pts, leaf)))


@pytest.mark.parametrize("evict", [True, False])
def test_evict_and_count_matches_jax(jax_run, evict):
    """On the map after frame 3 with a small window (entries fall out of
    it): tables bit-exact after the in-place clear, cleared and census
    counts exact (the port's per stream equal JAX's)."""
    _, _, states, _ = jax_run
    grid = states[-1].map.surf
    center = np.array([[1, 0, 0], [3, -1, 0], [-2, 1, 1]], np.int32)
    window = np.array([4, 3, 1], np.int32)
    local = np.array([2, 2, 1], np.int32)
    jg, jn, jnear = jgrid.evict_and_count(grid, jnp.asarray(center),
                                          jnp.asarray(window),
                                          jnp.asarray(local), evict)
    tg, tn, tnear = gridmap.evict_and_count(_grid_t(grid), _t(center),
                                            _t(window), _t(local), evict)
    _grid_eq(tg, jg)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tnear.numpy(), np.asarray(jnear))
    if evict:
        assert tn.numpy().min() > 0


def _mapping_inputs(jax_run, frame):
    """Frame ``frame``'s mapping-step inputs from JAX's chain: the
    downsampled surf stack (ds (B, Q, 4), mask), the initial pose guess
    (transformAssociateToMap) and the surf map before the step. The
    stack comes from the port's downsample (held to JAX's in
    test_voxel_downsample_masked_b_matches_jax)."""
    _, _, states, _ = jax_run
    prev, st = states[frame - 1], states[frame]
    surf = st.odom.surf_last
    vals = np.concatenate([surf.xyz, surf.intensity[..., None]], -1)
    ds, m, _ = voxel_downsample_masked_b(_t(vals), _t(surf.mask),
                                         CFG.plane_resolution,
                                         CFG.surf_stack_cap)
    qc = _t(prev.map.q_wmap_wodom)
    q_w = geo.qmul(qc, _t(st.odom.q_w)).numpy()
    t_w = (geo.qrot(qc, _t(st.odom.t_w)) + _t(prev.map.t_wmap_wodom)).numpy()
    return ds.numpy(), m.numpy(), q_w, t_w, prev.map.surf


def _world(q_w, t_w, pts):
    return (geo.qrot(_t(q_w)[:, None], _t(pts)) + _t(t_w)[:, None]).numpy()


@pytest.mark.parametrize("cell_cap", [1024, 192])
def test_knn_cache_b_matches_jax(jax_run, cell_cap):
    """From identical queries and map: cid, cid_sorted, cand_flat and the
    sorted payloads exact; the per-stream n_spilled sums to JAX's
    batch-wide count (192 forces spills)."""
    ds, m, q_w, t_w, grid = _mapping_inputs(jax_run, 2)
    sel = _world(q_w, t_w, ds[..., :3])
    jc, jpay = jax.jit(lambda g, q, p: jgrid.knn_cache_b(
        g, q, CFG.knn_cell, CFG.knn_radius, cell_cap, payloads=(p,)))(
            grid, sel, ds[..., 3])
    tc, tpay = gridmap.knn_cache_b(_grid_t(grid), _t(sel), CFG.knn_cell,
                                   CFG.knn_radius, cell_cap,
                                   payloads=(_t(ds[..., 3]),))
    for name in ("cand_flat", "cid", "cid_sorted"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tpay[0].numpy(), np.asarray(jpay[0]))
    assert tc.n_spilled.shape == (B,)
    assert int(tc.n_spilled.sum()) == int(jc.n_spilled)
    assert (int(jc.n_spilled) > 0) == (cell_cap == 192)


def test_insert_b_matches_jax(jax_run):
    """insert_b of frame 2's less-flat cloud into its surf map (JAX's XLA
    merge): the tables and merged / appended / evicted / dropped counts
    bit-exact (tests/test_batched_kernels.py:797-816)."""
    _, _, states, _ = jax_run
    st = states[2]
    surf = st.odom.surf_last
    center = np.zeros((B, 3), np.int32)
    window = np.array([50, 50, 50], np.int32)
    args = (CFG.plane_resolution, CFG.knn_cell)
    want = jax.jit(lambda *a: jgrid.insert_b(*a[:4], *args, *a[4:], 16,
                                             512))(
        st.map.surf, surf.xyz, surf.intensity, surf.mask, center, window)
    got = gridmap.insert_b(_grid_t(st.map.surf), _t(surf.xyz),
                           _t(surf.intensity), _t(surf.mask), *args,
                           _t(center), _t(window), 16, 512)
    _grid_eq(got[0], want[0])
    for name, a, b in zip(("merged", "appended", "evicted", "dropped"),
                          got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got[1].numpy().min() > 0 and got[2].numpy().min() > 0


def test_insert_vds_b_matches_jax(jax_run):
    """The fused map-frame downsample + insert of frame 2's surf stack:
    live entries per stream and every count exact, cells and voxel ids
    exact, slot coordinates and intensities within 4 ulps (bit-equal on
    this scene; the port's plain segmented scan sums in f64, JAX's in
    f32, which may round a voxel mean one ulp apart)."""
    ds, m, q_w, t_w, grid = _mapping_inputs(jax_run, 2)
    pts_w = _world(q_w, t_w, ds[..., :3])
    center = np.floor(t_w / CFG.knn_cell).astype(np.int32)
    window = np.asarray(jmp._window_cells(JCFG))
    args = (CFG.plane_resolution, CFG.knn_cell)
    want = jax.jit(lambda *a: jgrid.insert_vds_b(*a[:4], *args, *a[4:], 16,
                                                 1024))(
        grid, pts_w, ds[..., 3], m, center, window)
    got = gridmap.insert_vds_b(_grid_t(grid), _t(pts_w), _t(ds[..., 3]),
                               _t(m), *args, _t(center), _t(window), 16, 1024)
    np.testing.assert_array_equal(_live(got[0]), _live(want[0]))
    np.testing.assert_array_equal(got[0].aux.numpy()[..., 48:],
                                  np.asarray(want[0].aux)[..., 48:])
    for g, w in ((got[0].pts, want[0].pts), (got[0].inten, want[0].inten)):
        w = np.asarray(w)
        assert (np.abs(g.numpy() - w) <= 4 * np.spacing(np.abs(w))).all()
    for name, a, b in zip(("merged", "appended", "evicted", "dropped"),
                          got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_voxel_downsample_masked_b_matches_jax(jax_run):
    """The mapping input stack downsample of frame 3's clouds: masks and
    drop counts exact, means atol 2e-5."""
    _, _, states, _ = jax_run
    for cloud, leaf, cap in (
            (states[3].odom.corner_last, CFG.line_resolution,
             CFG.corner_stack_cap),
            (states[3].odom.surf_last, CFG.plane_resolution,
             CFG.surf_stack_cap)):
        vals = np.concatenate([cloud.xyz, cloud.intensity[..., None]], -1)
        got = voxel_downsample_masked_b(_t(vals), _t(cloud.mask), leaf, cap)
        want = jax.jit(lambda v, mk: j_vds_b(v, mk, leaf, cap))(vals,
                                                                cloud.mask)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=2e-5, rtol=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# --- the association round and the mapping step -----------------------------

@pytest.mark.parametrize("cspan", [0, 8])
def test_assoc_out8_b_matches_jax_kernel_branch(jax_run, cspan):
    """The port's _assoc_out8_b (tile padding, cid0 / local windows, spill
    and poison routing, then assoc_cell) against JAX's kernel branch
    (force_kernel_interpret) on pipeline data with map_cell_cap = 192
    (cell-cap spills) and cspan 0 or 8 (cell-window spills): every
    poisoned or spilled query gated in both, spill counts equal, ok flags
    agree on >= 98% (lattice-like near-ties, as JAX's own branches), 5th
    distance within 2e-3 where both are finite."""
    cfg = CFG.replace(map_cell_cap=192, assoc_cspan=cspan)
    ds, m, q_w, t_w, grid = _mapping_inputs(jax_run, 2)
    sel0 = _world(q_w, t_w, ds[..., :3])
    stack = ds[..., :3]
    jc, (sx, sy, sz, mi) = jax.jit(lambda g, q, *p: jgrid.knn_cache_b(
        g, q, cfg.knn_cell, cfg.knn_radius, cfg.map_cell_cap, payloads=p))(
            grid, sel0, stack[..., 0], stack[..., 1], stack[..., 2],
            m.astype(np.int32))
    assert int(jc.n_spilled) > 0
    sel = _world(q_w, t_w, np.stack([sx, sy, sz], -1))
    poison = ~(np.asarray(mi) > 0)
    tc = gridmap.knn_cache_b(_grid_t(grid), _t(sel0), cfg.knn_cell,
                             cfg.knn_radius, cfg.map_cell_cap)
    dead = poison | (np.asarray(jc.cid_sorted) >= cfg.map_cell_cap)
    if cspan:
        # an independent recount of the cell-window spill rule
        tq, q_n = gridmap.ASSOC_TQ, sel.shape[1]
        cid = np.asarray(jc.cid_sorted)
        cid = np.concatenate([cid, np.repeat(cid[:, -1:], (-q_n) % tq, 1)],
                             1)
        cid_f = (cid + np.arange(B)[:, None]
                 * tc.cand_flat.shape[1]).reshape(-1)
        cid0 = cid_f[::tq]
        loc = cid_f - np.repeat(cid0, tq) + np.repeat(cid0 % 8, tq)
        spill = (loc >= cspan + 8).reshape(B, -1)[:, :q_n] & ~dead
        assert spill.any()
        dead = dead | spill
    for kind, okc in (("surf", 4), ("corner", 6)):
        ker, n_k = jax.jit(lambda s_, p_, c_: jmp._assoc_out8_b(
            s_, p_, c_, _jcfg(cfg), kind, force_kernel_interpret=True))(
                sel, poison, jc)
        got, n_t = mp._assoc_out8_b(_t(sel), _t(poison), tc, cfg, kind)
        ker, got = np.asarray(ker), got.numpy()
        assert not ker[dead][:, okc].any() and not got[dead][:, okc].any()
        assert n_t.shape == (B,) and int(n_t.sum()) == int(n_k)
        if cspan:
            assert int(n_k) == int(spill.sum())
        agree = np.mean(got[..., okc] == ker[..., okc])
        assert agree >= 0.98, f"{kind} ok flags agree {agree}"
        assert ((got[..., okc] > 0) & (ker[..., okc] > 0)).sum() > 0
        d5t, d5k = got[..., okc + 1], ker[..., okc + 1]
        fin = np.isfinite(d5t) & np.isfinite(d5k)
        np.testing.assert_allclose(d5t[fin], d5k[fin], atol=2e-3)


def _map_args(st):
    o = st.odom
    clouds = [PointCloud(xyz=_t(c.xyz), intensity=_t(c.intensity),
                         mask=_t(c.mask)) for c in (o.corner_last,
                                                    o.surf_last)]
    return clouds + [_t(o.q_w), _t(o.t_w)]


@pytest.mark.parametrize("reuse", [True, False])
def test_mapping_step_b_matches_jax(jax_run, reuse):
    """mapping_step_b from JAX's map state after frame 1 with frame 2's
    odometry handoff: map poses within 2.5e-2 (JAX's own batched-vs-single
    bound), factor counts ±8, solve gates exact, live map entries per
    stream within ±8 or 3% (a pose ~1 cm apart moves inserted points
    across 0.2 m corner voxels: measured 497 vs 483 corner entries). With map_cache_reuse=False (exact per-round re-search) against
    JAX's mapping_step_b under the same setting; with reuse, against the
    chain's frame-2 map."""
    _, _, states, outs = jax_run
    cfg = CFG.replace(map_cache_reuse=reuse)
    st1, st2 = states[1], states[2]
    if reuse:
        want, jm = st2.map, dict(zip(jpipe.METRIC_NAMES, outs[1].metrics.T))
        want_cf, want_sf = jm["map_corner_factors"], jm["map_surf_factors"]
        want_solved = jm["map_solved"]
    else:
        want, mm = jax.jit(lambda s, c, f, q, t: jmp.mapping_step_b(
            s, c, f, q, t, _jcfg(cfg)))(st1.map, st2.odom.corner_last,
                                 st2.odom.surf_last, st2.odom.q_w,
                                 st2.odom.t_w)
        want_cf, want_sf = mm.corner_factors, mm.surf_factors
        want_solved = mm.solved
        assert not np.asarray(mm.cache_crossed).any()
    got, tm = mp.mapping_step_b(mp.state_from_numpy(st1.map, "cpu"),
                                *_map_args(st2), cfg)
    for name in ("q_w", "t_w", "q_wmap_wodom", "t_wmap_wodom"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=2.5e-2, err_msg=name)
    for a, b in ((tm.corner_factors, want_cf), (tm.surf_factors, want_sf)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 8
    np.testing.assert_array_equal(tm.solved.numpy(),
                                  np.asarray(want_solved) > 0)
    assert tm.solved.numpy().all() and (tm.surf_factors.numpy() > 50).all()
    for kind in ("corner", "surf"):
        g, w = _live(getattr(got, kind)), _live(getattr(want, kind))
        assert (np.abs(g - w) <= np.maximum(8, 0.03 * w)).all(), (kind, g, w)
    if not reuse:
        assert not tm.cache_crossed.numpy().any()


def test_step_b_matches_jax_chain(jax_run):
    """The port's step_b over 3 frames from the initial state against
    JAX's step_b under jit: q_odom / t_odom within 2e-3 / 5e-3 (as
    test_front_step_b_matches_jax_chain), q_map / t_map within 2.5e-2,
    the high-frequency pose likewise; feature counts and map_solved
    exact; costs rtol 5e-2 + atol 1e-3; every other count within ±8 or 3%
    of JAX's, and map_cache_crossed within ±16. The count bounds are the
    surf fits' rounding: on near-degenerate (lattice) neighbourhoods the
    plane test flips on rounding, on 1-3% of the queries between JAX's own
    kernel and XLA branches on this scene, and the map pose (and so the
    queries whose base cell moves between rounds) follows. Overflow: JAX
    broadcasts batch-wide sums to every stream, the port counts per
    stream. frontend_overflow sums to JAX's column; map_overflow holds
    JAX's broadcast spill sum on top of each stream's own drops, which is
    zero here (the surf stack cap equals map_cell_cap and assoc_cspan is
    0), so its columns compare per stream."""
    xyz, mask, _, outs = jax_run
    st = tp.init_state(CFG, B, "cpu")
    exact = ("n_sharp", "n_flat", "n_less_sharp", "n_less_flat",
             "map_solved")
    for f in range(N_FRAMES):
        st, out = tp.step_b(st, _t(xyz[f]), _t(mask[f]), CFG)
        want = outs[f]
        for name, atol in (("q_odom", 2e-3), ("t_odom", 5e-3),
                           ("q_map", 2.5e-2), ("t_map", 2.5e-2),
                           ("q_hf", 2.5e-2), ("t_hf", 2.5e-2)):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       atol=atol, err_msg=f"{name} {f}")
        got_m = dict(zip(tp.METRIC_NAMES, out.metrics.numpy().T))
        want_m = dict(zip(jpipe.METRIC_NAMES, np.asarray(want.metrics).T))
        assert tuple(got_m) == tuple(want_m)
        for name in tp.METRIC_NAMES:
            g, w = got_m[name], want_m[name]
            msg = f"frame {f} {name}: {g} vs {w}"
            if name in exact:
                np.testing.assert_array_equal(g, w, err_msg=msg)
            elif name == "frontend_overflow":
                assert g.sum() == w[0] and (w == w[0]).all(), msg
            elif name == "odom_cost":
                np.testing.assert_allclose(g, w, rtol=5e-2, atol=1e-3,
                                           err_msg=msg)
            elif name == "map_cache_crossed":
                assert (np.abs(g - w) <= 16).all(), msg
            else:
                assert (np.abs(g - w) <= np.maximum(8, 0.03 * w)).all(), msg
    assert st.frame == N_FRAMES
    # the scene moves: the odometry followed it and mapping solved
    assert (np.linalg.norm(out.t_odom.numpy(), axis=1) > 0.05).all()
    assert (out.metrics.numpy()[:, tp.METRIC_NAMES.index("map_solved")]
            == 1).all()


def test_step_b_mapping_skip_frame(jax_run):
    """mapping_skip_frame = 2 (the VLP-16 launch's setting) maps frames 0
    and 2 only: a skipped frame returns the map state unchanged (the same
    tables, the previous mapped pose) and all-zero map metrics, while the
    odometry steps on; the mapped frames equal the unskipped run's first
    frame."""
    xyz, mask, _, outs = jax_run
    cfg = CFG.replace(mapping_skip_frame=2)
    st = tp.init_state(CFG, B, "cpu")
    st, out0 = tp.step_b(st, _t(xyz[0]), _t(mask[0]), cfg)
    corner = st.map.corner.pts.clone()
    st, out1 = tp.step_b(st, _t(xyz[1]), _t(mask[1]), cfg)
    names = tp.METRIC_NAMES
    m1 = dict(zip(names, out1.metrics.numpy().T))
    assert all((m1[n] == 0).all() for n in names if n.startswith("map_"))
    assert (m1["plane_corr"] > 0).all()
    assert torch.equal(st.map.corner.pts, corner)
    assert torch.equal(out1.q_map, out0.q_map)
    assert torch.equal(out1.t_map, out0.t_map)
    np.testing.assert_allclose(out0.t_map.numpy(), np.asarray(outs[0].t_map),
                               atol=1e-6)
    st, out2 = tp.step_b(st, _t(xyz[2]), _t(mask[2]), cfg)
    assert st.frame == 3
    assert (out2.metrics.numpy()[:, names.index("map_solved")] == 1).all()


def test_state_from_numpy_round_trip(jax_run):
    """A JAX SlamState (after frame 3) carried into the port and back:
    every leaf bit for bit, dtypes kept, the frame counter one int."""
    _, _, states, _ = jax_run
    jst = states[-1]
    st = tp.state_from_numpy(jst, "cpu")
    assert st.frame == N_FRAMES
    assert st.odom.initialized.dtype == torch.bool
    assert st.map.corner.aux.dtype == torch.int32

    def leaves(tree):
        if isinstance(tree, tuple):
            return [x for sub in tree for x in leaves(sub)]
        return [tree]

    got = leaves(st._replace(frame=None))
    want = leaves(jst._replace(frame=None))
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        if g is None:
            continue
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # and the port's own init matches JAX's init leaf for leaf
    init = leaves(tp.init_state(CFG, B, "cpu")._replace(frame=None))
    jinit = leaves(_np(_jax_init())._replace(frame=None))
    for g, w in zip(init, jinit):
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_extract_map_cloud(jax_run):
    """Host-side map extraction per stream: the live entries' points, as
    many as the table's live count."""
    _, _, states, _ = jax_run
    st = mp.state_from_numpy(states[-1].map, "cpu")
    corner, surf = mp.extract_map_cloud(st, CFG)
    assert len(corner) == len(surf) == B
    np.testing.assert_array_equal([len(c) for c in surf], _live(st.surf))
    want, _ = jgrid.extract(jax.tree.map(lambda x: x[1], states[-1].map.surf))
    np.testing.assert_array_equal(surf[1], want)
    assert all(np.isfinite(c).all() and np.abs(c).max() < 1e3
               for c in corner + surf)
