"""The PyTorch port's motion-distortion path (``cfg.distortion``, the
reference's ``DISTORTION 1``) against the JAX package: ``geometry.slerp``,
the per-point time fraction and TransformToEnd, the s-scaled residuals,
the solve with an ``s`` channel, and 3 frames of ``odometry_step_b``,
``step_b`` and ``step``.

Both packages run on the CPU from the same numpy inputs: JAX under this
suite's conftest (its ``s`` factors go to its vmapped XLA solve), the port
through its kernels' plain versions. The scene is two motion-distorted
16-line streams (``make_distorted_sequence``: seeds 20 and 21 at 7 and
6 m/s, accelerating at 12 m/s² and turning at 0.3 rad/s, the regime of
tests/test_pipeline.py's distortion tests) at the small config of
tests/test_torch_slice.py.

Every tolerance is the rigid path's, restated in its test: the odometry
stage 5e-4, the solve as tests/test_torch_kernels.py::test_lm_matches_jax,
the 3-frame chains as tests/test_torch_mapping.py (``step_b``) and
tests/test_torch_single.py (``step``). The mapped translation of such a
scene is ill-conditioned in the JAX package itself: nudging every input
coordinate by one ulp moves JAX's t_map by up to 0.155 m on seeds 11
and 12 (tests/_torch_distortion_spread.py measures it). The seeds are
ones on which 20 such nudges move JAX's own chains by at most 2.0e-2 m
(t_map, t_hf), 1.7e-4 m (t_odom) and 1.2e-3 (rotations), under those
bounds; the port sits within 7.6e-3 m of JAX there. In the chains each
package computes its own features, and the time fraction s inherits the
intensity's atan2 rounding (intensity agrees to 1e-5, so s to about
1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aloam_tpu import config as jconfig
from aloam_tpu import geometry as jgeo
from aloam_tpu import odometry as jod
from aloam_tpu import pipeline as jpipe
from aloam_tpu import solver as jsolver
from aloam_tpu.io import synthetic as syn
from aloam_tpu.types import PointCloud as JPointCloud
from aloam_tpu.types import ScanFeatures as JScanFeatures
from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import odometry as tod
from aloam_tpu_torch import pipeline as tp
from aloam_tpu_torch import solver
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.frontend import extract_features_b, register_scan_b
from aloam_tpu_torch.ops import lm as lm_op
from aloam_tpu_torch.types import PointCloud

torch.set_num_threads(1)

# the 16-line test scene's config (tests/test_torch_slice.py), distorted
CFG = AloamConfig(
    scan_lines=16, minimum_range=0.3,
    line_resolution=0.2, plane_resolution=0.4,
    n_raw=4096, ring_cap=256, less_flat_cap=2048,
    map_table_corner=1024, map_table_surf=2048,
    corner_stack_cap=256, surf_stack_cap=1024, distortion=True,
)
JCFG = jconfig.AloamConfig(**dataclasses.asdict(CFG))
B = 2
N_FRAMES = 3
# the streams' seeds and speeds (m/s): scenes on which the JAX package's
# own 3-frame chains move by less than the rigid path's bounds under
# one-ulp input nudges (tests/_torch_distortion_spread.py)
SEEDS = (20, 21)
SPEEDS = (7.0, 6.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _unit(rng, n, scale=0.3):
    """n unit quaternions a rotation of ~scale rad off the identity."""
    return np.array(jgeo.exp_so3(jnp.asarray(
        rng.normal(scale=scale, size=(n, 3)), jnp.float32)))


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def make_scene():
    """(F, B, n_raw, 3) xyz and (F, B, n_raw) mask of B distorted streams
    (SEEDS, SPEEDS)."""
    xyz, mask = [], []
    for seed, speed in zip(SEEDS, SPEEDS):
        scans, _ = syn.make_distorted_sequence(
            N_FRAMES, scan_lines=CFG.scan_lines, n_azimuth=256, seed=seed,
            speed=speed, yaw_rate=0.3, accel=12.0)
        pads = [syn.pad_scan(s, CFG.n_raw) for s in scans]
        xyz.append(np.stack([p[0] for p in pads]))
        mask.append(np.stack([p[1] for p in pads]))
    return np.stack(xyz, axis=1), np.stack(mask, axis=1)


@pytest.fixture(scope="module")
def jax_chain(scene):
    """JAX's step_b under jit over the B streams: the states before and
    after each frame (numpy leaves) and each frame's outputs."""
    xyz, mask = scene
    step = jax.jit(lambda s, x, m: jpipe.step_b(s, x, m, JCFG))
    st = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                      jpipe.init_state(JCFG))
    st = st._replace(frame=jnp.zeros((B,), jnp.int32))
    states, outs = [_np(st)], []
    for f in range(N_FRAMES):
        st, out = step(st, xyz[f], mask[f])
        states.append(_np(st))
        outs.append(_np(out))
    return states, outs


# --- geometry, time fractions, TransformToEnd -------------------------------

def test_slerp_matches_jax(rng):
    """geometry.slerp against JAX's on random pairs (half of them with
    dot < 0, the sign flip), the identity to itself and to a pose (the
    LERP branch and its edge), and s in [0, 1] with 0 and 1 exactly:
    atol 1e-6 (acos and sin round differently in the two libraries; the
    weights' ratio cancels most of it). s = 0 gives q0 and s = 1 the
    sign-flipped q1, both within 1e-6."""
    n = 64
    q0, q1 = _unit(rng, n), _unit(rng, n, scale=1.0)
    q1[::2] *= -1.0
    q0[:4] = q1[:4] = [1.0, 0.0, 0.0, 0.0]          # identity to identity
    q0[4:8] = [1.0, 0.0, 0.0, 0.0]                  # identity to a pose
    q1[8] = q0[8]                                    # a pose to itself
    s = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    s[::5], s[1::5] = 0.0, 1.0
    got = geo.slerp(_t(q0), _t(q1), _t(s)).numpy()
    want = np.asarray(jgeo.slerp(q0, q1, s))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    flip = np.where(np.sum(q0 * q1, -1, keepdims=True) < 0, -q1, q1)
    np.testing.assert_allclose(got[::5], q0[::5], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1::5], flip[1::5], atol=1e-6, rtol=0)
    # a scalar s broadcasts, as JAX's does
    np.testing.assert_allclose(geo.slerp(_t(q0), _t(q1), 0.25).numpy(),
                               np.asarray(jgeo.slerp(q0, q1, 0.25)),
                               atol=1e-6, rtol=0)


def _cloud(rng, bsz, n, cfg):
    """A (B, n) cloud whose intensity encodes ring + scan_period·s; the
    last rows are padding (mask off, intensity 0)."""
    ring = rng.integers(0, cfg.scan_lines, size=(bsz, n)).astype(np.float32)
    s = rng.uniform(0.0, 1.0, size=(bsz, n)).astype(np.float32)
    s[:, :3] = [0.0, 1.0, 0.5]
    xyz = rng.uniform(-20, 20, size=(bsz, n, 3)).astype(np.float32)
    inten = (ring + np.float32(cfg.scan_period) * s).astype(np.float32)
    mask = np.ones((bsz, n), bool)
    mask[:, -5:] = False
    inten[:, -5:] = 0.0
    return xyz, inten, mask


def test_point_s_and_transform_to_end_b_match_jax(rng):
    """_point_s exact against JAX's (the same floor, one f32 division, the
    same clip) and transform_to_end_b within 1e-5 m, its intensity
    floored exactly, mask kept; on B = 3 poses, the first the identity
    (every stream's first frame hands off through it)."""
    bsz, n = 3, 200
    xyz, inten, mask = _cloud(rng, bsz, n, CFG)
    q = _unit(rng, bsz, scale=0.1)
    q[0] = [1.0, 0.0, 0.0, 0.0]
    t = rng.normal(scale=1.0, size=(bsz, 3)).astype(np.float32)
    t[0] = 0.0
    pc = PointCloud(xyz=_t(xyz), intensity=_t(inten), mask=_t(mask))
    jpc = JPointCloud(xyz=jnp.asarray(xyz), intensity=jnp.asarray(inten),
                      mask=jnp.asarray(mask))
    np.testing.assert_array_equal(tod._point_s(pc, CFG).numpy(),
                                  np.asarray(jod._point_s(jpc, JCFG)))
    got = tod.transform_to_end_b(pc, _t(q), _t(t), CFG)
    want = jod.transform_to_end_b(jpc, jnp.asarray(q), jnp.asarray(t), JCFG)
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.intensity.numpy(),
                                  np.asarray(want.intensity))
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_allclose(got.xyz[0].numpy(), xyz[0], atol=1e-5)


def test_transform_to_end_matches_physical_model(rng):
    """The port's version of tests/test_odometry.py's pin: a point fired
    at sweep fraction s from the constant-velocity interpolated pose maps
    back to its fixed place in the sweep-start frame (TransformToStart
    with s) and in the sweep-end frame (TransformToEnd), within 1e-4 m;
    the ring survives in the intensity. Two streams, two sweep motions."""
    q_m = geo.exp_so3(_t(np.array([[0.02, -0.03, 0.1], [-0.05, 0.01, -0.2]],
                                  np.float32)))
    t_m = _t(np.array([[1.0, 0.2, -0.05], [-0.4, 0.9, 0.1]], np.float32))
    n = 64
    x_start = _t(rng.uniform(-20, 20, size=(2, n, 3)).astype(np.float32))
    s = _t(rng.uniform(0, 1, size=(2, n)).astype(np.float32))
    # fire-time coordinates: p = R(s)^T (X - s t_m)
    qs, ts = solver._interp_pose(q_m, t_m, s)
    p_fire = geo.qrot_inv(qs, x_start - ts)
    back = tod._transform_to_start_b(q_m, t_m, p_fire, s)
    np.testing.assert_allclose(back.numpy(), x_start.numpy(), atol=1e-4)
    ring = _t(rng.integers(0, 64, size=(2, n)).astype(np.float32))
    pc = PointCloud(xyz=p_fire, intensity=ring + CFG.scan_period * s,
                    mask=torch.ones((2, n), dtype=torch.bool))
    out = tod.transform_to_end_b(pc, q_m, t_m, CFG)
    want = geo.qrot_inv(q_m[:, None], x_start - t_m[:, None])
    np.testing.assert_allclose(out.xyz.numpy(), want.numpy(), atol=1e-4)
    np.testing.assert_allclose(out.intensity.numpy(), ring.numpy(),
                               atol=1e-6)


# --- residuals and the solve ------------------------------------------------

def _factors_s(rng, bsz, ne, npl, live=0.8):
    """Edge and plane factors near the identity with time fractions (0
    and 1 among them), the masked rows' s at NaN: numpy leaves."""
    e_p = rng.normal(scale=8.0, size=(bsz, ne, 3)).astype(np.float32)
    e_a = e_p + rng.normal(scale=0.05, size=(bsz, ne, 3)).astype(np.float32)
    dirs = rng.normal(size=(bsz, ne, 3)).astype(np.float32)
    e_b = e_a + 0.4 * dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    e_m = rng.random((bsz, ne)) < live
    p_p = rng.normal(scale=8.0, size=(bsz, npl, 3)).astype(np.float32)
    nrm = rng.normal(size=(bsz, npl, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = (-np.sum(nrm * p_p, axis=-1)
         + rng.normal(scale=0.02, size=(bsz, npl))).astype(np.float32)
    p_m = rng.random((bsz, npl)) < live
    e_s = rng.uniform(size=(bsz, ne)).astype(np.float32)
    p_s = rng.uniform(size=(bsz, npl)).astype(np.float32)
    e_s[:, :2], p_s[:, :2] = [0.0, 1.0], [0.0, 1.0]
    e_s[~e_m], p_s[~p_m] = np.nan, np.nan
    return (e_p, e_a, e_b.astype(np.float32), e_m, e_s), \
        (p_p, nrm, d, p_m, p_s)


def test_residuals_with_s_match_jax(rng):
    """edge_residuals / plane_residuals with time fractions against JAX's
    on each stream: residuals and Jacobians (the first-order s-scaled
    form) within 1e-5. s ≡ 1 gives the s = None residual and Jacobian
    within 1e-5 (the slerp's normalize rounds q)."""
    bsz, n = 3, 40
    e, p = _factors_s(rng, bsz, n, n, live=1.0)
    q = _unit(rng, bsz, scale=0.1)
    q[1] *= -1.0                                     # qw < 0: the sign flip
    q[2] = [1.0, 0.0, 0.0, 0.0]                      # the identity: LERP
    t = rng.normal(scale=0.5, size=(bsz, 3)).astype(np.float32)
    for fn, jfn, cls, jcls, leaves in (
            (solver.edge_residuals, jsolver.edge_residuals,
             solver.EdgeFactors, jsolver.EdgeFactors, e),
            (solver.plane_residuals, jsolver.plane_residuals,
             solver.PlaneFactors, jsolver.PlaneFactors, p)):
        r, jac = fn(cls(*map(_t, leaves)), _t(q), _t(t))
        for b in range(bsz):
            jr, jj = jfn(jcls(*(jnp.asarray(x[b]) for x in leaves)),
                         jnp.asarray(q[b]), jnp.asarray(t[b]))
            np.testing.assert_allclose(r[b].numpy(), np.asarray(jr),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(jac[b].numpy(), np.asarray(jj),
                                       atol=1e-5, rtol=0)
        ones = cls(*map(_t, leaves[:-1]), s=torch.ones(bsz, n))
        none = cls(*map(_t, leaves[:-1]))
        for a, b_ in zip(fn(ones, _t(q), _t(t)), fn(none, _t(q), _t(t))):
            np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5,
                                       rtol=0)


def test_lm_fused_plain_s_channel_matches_jax():
    """The packed 11 / 9-channel solve (lm_fused, which takes the plain
    version for CPU tensors) against JAX's lm_solve_b, which sends s
    factors to its vmapped XLA solve, from three poses (near the
    identity, qw < 0, the identity itself): q atol 2e-5, t atol 2e-4,
    cost0 rtol 2e-4, cost rtol 2e-3, counts exact (as
    tests/test_torch_kernels.py::test_lm_matches_jax). The masked rows'
    s is NaN and changes nothing. The packing puts s last, after the mask
    at channel 9 / 7."""
    rng = np.random.default_rng(21)
    bsz = 3
    e, p = _factors_s(rng, bsz, 256, 384)
    q0 = _unit(rng, bsz, scale=0.05)
    q0[1] *= -1.0
    q0[2] = [1.0, 0.0, 0.0, 0.0]
    t0 = rng.normal(scale=0.1, size=(bsz, 3)).astype(np.float32)
    edges = solver.EdgeFactors(*map(_t, e))
    planes = solver.PlaneFactors(*map(_t, p))
    ef, pf = lm_op.pack_edge_channels(edges), lm_op.pack_plane_channels(
        planes)
    assert ef.shape == (bsz, 11, 256) and pf.shape == (bsz, 9, 384)
    np.testing.assert_array_equal(ef[:, 9].numpy(), e[3])
    np.testing.assert_array_equal(pf[:, 8].numpy(), p[4])
    q, t, st = solver.lm_solve_b(edges, planes, _t(q0), _t(t0), 4, 0.1)
    jq, jt, jst = jsolver.lm_solve_b(
        jsolver.EdgeFactors(*map(jnp.asarray, e)),
        jsolver.PlaneFactors(*map(jnp.asarray, p)), jnp.asarray(q0),
        jnp.asarray(t0), 4, 0.1)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=2e-5, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=2e-4, rtol=0)
    np.testing.assert_allclose(st.cost0.numpy(), np.asarray(jst.cost0),
                               rtol=2e-4)
    np.testing.assert_allclose(st.cost.numpy(), np.asarray(jst.cost),
                               rtol=2e-3)
    for name in ("n_factors", "clamped", "nonfinite"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)))
    assert (st.cost.numpy() < st.cost0.numpy()).all()
    # the solve moved off the start: the s channel reached the solve
    assert (np.abs(t.numpy() - t0).max(axis=1) > 1e-3).all()


def test_lm_fused_channel_contract():
    """lm_fused takes 10 / 8 or 11 / 9 channels and refuses anything else
    (s on one batch only, a wrong pose) before any device dispatch; the
    launch plan and the slice bytes count 11 / 9 floats a row with s, as
    csrc/lm.cu copies them, so s can raise a stream's cluster size."""
    ef, pf = torch.zeros(2, 10, 8), torch.zeros(2, 8, 8)
    pose = torch.zeros(2, 8)
    pose[:, 0] = 1.0
    es, ps = torch.zeros(2, 11, 8), torch.zeros(2, 9, 8)
    for a, b_, p_ in ((es, pf, pose), (ef, ps, pose), (ef, pf, pose[:1]),
                      (es[:, :10], ps[:, :7], pose),
                      (torch.zeros(2, 12, 8), ps, pose)):
        with pytest.raises(ValueError, match="lm_fused"):
            lm_op.lm_fused(a, b_, p_, 2, 0.1)
    assert lm_op.lm_fused(es, ps, pose, 2, 0.1).shape == (2, lm_op.N_OUT)
    assert lm_op._slice_bytes(768, 1536, 6, True) == 4 * (11 * 128
                                                          + 9 * 256)
    assert lm_op._slice_bytes(768, 1536, 6) == 4 * (10 * 128 + 8 * 256)
    for bsz, want in ((1, 8), (16, 6), (32, 3)):
        assert lm_op.launch_plan(bsz, 768, 1536, 132, True) == want
        assert lm_op.launch_plan(bsz, 3072, 4096, 132, True) == want
    # one block holds 2000 + 3500 rows without s, not with it
    assert lm_op.launch_plan(200, 2000, 3500, 132) == 1
    assert lm_op.launch_plan(200, 2000, 3500, 132, True) == 2
    assert lm_op._slice_bytes(2000, 3500, 2, True) <= lm_op.SLICE_BYTES
    # 8 blocks hold 22000 + 22000 rows without s, not with it
    assert lm_op.launch_plan(1, 22000, 22000, 132) == 8
    with pytest.raises(ValueError, match="shared memory"):
        lm_op.launch_plan(1, 22000, 22000, 132, True)


# --- the odometry stage and the chains --------------------------------------

def test_odometry_step_b_matches_jax(scene, jax_chain):
    """From JAX's state after frame 1 (handoff clouds already undistorted
    by transform_to_end_b) and the same frame-2 features: poses atol 5e-4,
    correspondence counts ±3 (the rigid path's bounds,
    tests/test_torch_slice.py), the new handoff clouds within 1e-3 m of
    JAX's (the pose difference times a ~20 m lever arm) with intensity
    floored exactly."""
    xyz, mask = scene
    states, _ = jax_chain
    rc, curv, _ = register_scan_b(_t(xyz[2]), _t(mask[2]), CFG)
    feats = extract_features_b(rc, curv, CFG)
    jfeats = JScanFeatures(*(JPointCloud(*(jnp.asarray(x.numpy())
                                           for x in getattr(feats, c)))
                             for c in JScanFeatures._fields[:-1]),
                           overflow=jnp.asarray(feats.overflow.numpy()))
    st_j1, m_j = jax.jit(lambda s, f: jod.odometry_step_b(s, f, JCFG))(
        jax.tree.map(jnp.asarray, states[2].odom), jfeats)
    st_t = tod.state_from_numpy(states[2].odom, "cpu")
    st_t1, m_t = tod.odometry_step_b(st_t, feats, CFG)
    for name in ("q_w", "t_w", "q_lc", "t_lc"):
        np.testing.assert_allclose(getattr(st_t1, name).numpy(),
                                   np.asarray(getattr(st_j1, name)),
                                   atol=5e-4, err_msg=name)
    for name in ("corner_corr", "plane_corr"):
        diff = np.abs(getattr(m_t, name).numpy()
                      - np.asarray(getattr(m_j, name)))
        assert diff.max() <= 3, (name, diff)
    for name in ("corner_last", "surf_last"):
        got, want = getattr(st_t1, name), getattr(st_j1, name)
        m = np.asarray(want.mask)
        np.testing.assert_array_equal(got.mask.numpy(), m)
        np.testing.assert_allclose(got.xyz.numpy()[m],
                                   np.asarray(want.xyz)[m], atol=1e-3,
                                   err_msg=name)
        np.testing.assert_array_equal(got.intensity.numpy(),
                                      np.asarray(want.intensity))
    assert (m_t.corner_corr > 0).all() and (m_t.plane_corr > 0).all()


def test_step_b_matches_jax_chain(scene, jax_chain):
    """The port's distorted step_b over 3 frames against JAX's under jit,
    at the rigid path's bounds (tests/test_torch_mapping.py): q_odom /
    t_odom within 2e-3 / 5e-3, the map and high-frequency poses within
    2.5e-2; feature counts and map_solved exact. The per-point slerp moved
    the points: on every frame after the first, each stream's odometry
    translation differs from the rigid model's by more than the 5e-3 it
    is held to against JAX, so a port without the distortion path fails."""
    xyz, mask = scene
    _, outs = jax_chain
    st = tp.init_state(CFG, B, "cpu")
    rigid = tp.init_state(CFG.replace(distortion=False), B, "cpu")
    for f in range(N_FRAMES):
        st, out = tp.step_b(st, _t(xyz[f]), _t(mask[f]), CFG)
        rigid, r_out = tp.front_step_b(rigid, _t(xyz[f]), _t(mask[f]),
                                       CFG.replace(distortion=False))
        want = outs[f]
        for name, atol in (("q_odom", 2e-3), ("t_odom", 5e-3),
                           ("q_map", 2.5e-2), ("t_map", 2.5e-2),
                           ("q_hf", 2.5e-2), ("t_hf", 2.5e-2)):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       getattr(want, name), atol=atol,
                                       rtol=0, err_msg=f"{name} {f}")
        if f:
            moved = np.abs(out.t_odom.numpy()
                           - r_out.t_odom.numpy()).max(axis=1)
            assert (moved > 5e-3).all(), (f, moved)
        got_m = dict(zip(tp.METRIC_NAMES, out.metrics.numpy().T))
        want_m = dict(zip(jpipe.METRIC_NAMES, np.asarray(want.metrics).T))
        for name in ("n_sharp", "n_flat", "n_less_sharp", "n_less_flat",
                     "map_solved"):
            np.testing.assert_array_equal(got_m[name], want_m[name],
                                          err_msg=f"frame {f} {name}")
    assert (got_m["map_solved"] == 1).all()


def test_step_matches_jax_chain(scene):
    """The port's distorted single-stream step over 3 frames of stream 0
    against JAX's jitted step, at the rigid path's bounds
    (tests/test_torch_single.py): q_odom / t_odom within 5e-4, the map and
    high-frequency poses within 2.5e-2; feature counts and map_solved
    exact. On every frame after the first the odometry translation
    differs from the rigid model's (JAX's rigid step on the same frames)
    by more than the 5e-4 it is held to. The mapping stage gets the
    TransformToEnd'd handoff clouds, their time fractions stripped."""
    xyz, mask = scene
    step = jax.jit(lambda s, x, m: jpipe.step(s, x, m, JCFG))
    rigid_cfg = JCFG.replace(distortion=False)
    rigid_step = jax.jit(lambda s, x, m: jpipe.step(s, x, m, rigid_cfg))
    st_j, st_r = jpipe.init_state(JCFG), jpipe.init_state(rigid_cfg)
    st = tp.init_state(CFG, 1, "cpu")
    seen = []
    real = tp.mp.mapping_step

    def spy(map_state, corner, surf, *args):
        seen.append(corner.intensity)
        return real(map_state, corner, surf, *args)

    tp.mp.mapping_step = spy
    try:
        for f in range(N_FRAMES):
            st_j, want = step(st_j, xyz[f, 0], mask[f, 0])
            st_r, rigid = rigid_step(st_r, xyz[f, 0], mask[f, 0])
            st, out = tp.step(st, _t(xyz[f, 0]), _t(mask[f, 0]), CFG)
            want = _np(want)
            for name, atol in (("q_odom", 5e-4), ("t_odom", 5e-4),
                               ("q_map", 2.5e-2), ("t_map", 2.5e-2),
                               ("q_hf", 2.5e-2), ("t_hf", 2.5e-2)):
                np.testing.assert_allclose(getattr(out, name).numpy(),
                                           getattr(want, name), atol=atol,
                                           rtol=0, err_msg=f"{name} {f}")
            if f:
                moved = np.abs(out.t_odom.numpy()
                               - np.asarray(rigid.t_odom)).max()
                assert moved > 5e-4, (f, moved)
            got_m = tp.metrics_dict(out.metrics)
            want_m = jpipe.metrics_dict(want.metrics)
            for name in ("n_sharp", "n_flat", "n_less_sharp",
                         "n_less_flat", "map_solved"):
                assert got_m[name] == want_m[name], (f, name)
    finally:
        tp.mp.mapping_step = real
    assert got_m["map_solved"] == 1
    assert len(seen) == N_FRAMES
    assert all(bool((i == torch.floor(i)).all()) for i in seen)

