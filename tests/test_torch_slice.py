"""The PyTorch port's front half (aloam_tpu_torch) against the JAX package.

Both packages run on the CPU from the same numpy inputs: JAX under this
suite's conftest, the port through its kernels' plain versions (a CPU
tensor never reaches a CUDA kernel). Stages are held one at a time from
identical inputs (registration, features, odometry from the same state),
then the whole ``front_step_b`` against the JAX stages chained under jit.

Tolerances: integer outputs (ring ids, counts, masks, labels) are exact
where both sides do the same arithmetic. Floats differ by f32 rounding
(XLA and PyTorch order sums differently), and a rounding flip of a
threshold gate (the 25 m² correspondence gates) can move a correspondence
or two, so correspondence counts get ±3 and poses a few 1e-4 per
odometry step, as tests/test_batched_kernels.py allows between JAX's own
batched and single paths.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aloam_tpu import odometry as jod
from aloam_tpu.config import AloamConfig
from aloam_tpu.frontend import extract_features_b as j_extract_b
from aloam_tpu.frontend import register_scan_b as j_register_b
from aloam_tpu.frontend.registration import ring_ids as j_ring_ids
from aloam_tpu.io import synthetic as syn
from aloam_tpu_torch import odometry as tod
from aloam_tpu_torch import pipeline as tp
from aloam_tpu_torch.frontend import extract_features_b, register_scan_b
from aloam_tpu_torch.frontend.registration import ring_ids
from aloam_tpu_torch.types import PointCloud, RingCloud, ScanFeatures

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the 16-line test scene of tests/test_batched_kernels.py
CFG = AloamConfig(
    scan_lines=16, minimum_range=0.3,
    line_resolution=0.2, plane_resolution=0.4,
    n_raw=4096, ring_cap=256, less_flat_cap=2048,
    map_table_corner=1024, map_table_surf=2048,
    corner_stack_cap=256, surf_stack_cap=1024,
)
B = 3
N_FRAMES = 3
CLOUDS = ("sharp", "less_sharp", "flat", "less_flat", "full")


def _scene(cfg, n_frames, n_azimuth=256):
    """(F, B, n_raw, 3) xyz, (F, B, n_raw) mask of B synthetic streams."""
    xyz, mask = [], []
    for b in range(B):
        scans, _ = syn.make_sequence(n_frames, scan_lines=cfg.scan_lines,
                                     n_azimuth=n_azimuth, seed=30 + b,
                                     speed=1.0 + 0.5 * b)
        pads = [syn.pad_scan(s, cfg.n_raw) for s in scans]
        xyz.append(np.stack([p[0] for p in pads]))
        mask.append(np.stack([p[1] for p in pads]))
    return np.stack(xyz, axis=1), np.stack(mask, axis=1)


@pytest.fixture(scope="module")
def scene():
    return _scene(CFG, N_FRAMES)


@pytest.fixture(scope="module")
def jax_fns():
    return (jax.jit(lambda x, m: j_register_b(x, m, CFG)),
            jax.jit(lambda rc, cv: j_extract_b(rc, cv, CFG)),
            jax.jit(lambda s, f: jod.odometry_step_b(s, f, CFG)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _feats_to_torch(f) -> ScanFeatures:
    def cloud(pc):
        return PointCloud(xyz=_t(pc.xyz), intensity=_t(pc.intensity),
                          mask=_t(pc.mask))
    return ScanFeatures(*(cloud(getattr(f, c)) for c in CLOUDS),
                        overflow=_t(f.overflow))


def _jax_init(cfg):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                        jod.init_state(cfg))


@pytest.mark.parametrize("lines", [16, 32, 64])
def test_register_scan_b_matches_jax(lines):
    """Ring ids and counts exact; xyz and curvature atol 1e-6 / rtol 1e-5;
    intensity (ring + 0.1 * relTime) atol 1e-5 (atan2 rounds differently
    in the two libraries). JAX runs eagerly here: under jit XLA fuses the
    curvature stencil's chain of adds and rounds it differently (up to
    ~5e-4 relative where the stencil cancels), eager XLA does not."""
    cfg = CFG.replace(scan_lines=lines, n_raw=lines * 256,
                      minimum_range=5.0 if lines == 64 else 0.3)
    xyz, mask = _scene(cfg, 1)
    xyz, mask = xyz[0], mask[0]
    rc_j, curv_j, ovf_j = j_register_b(jnp.asarray(xyz), jnp.asarray(mask),
                                       cfg)
    rc_t, curv_t, ovf_t = register_scan_b(_t(xyz), _t(mask), cfg)

    live = mask & (np.abs(xyz).sum(-1) > 0)
    rid_j, keep_j = j_ring_ids(jnp.asarray(xyz), lines)
    rid_t, keep_t = ring_ids(_t(xyz), lines)
    np.testing.assert_array_equal(rid_t.numpy()[live], np.asarray(rid_j)[live])
    np.testing.assert_array_equal(keep_t.numpy()[live],
                                  np.asarray(keep_j)[live])
    np.testing.assert_array_equal(rc_t.cnt.numpy(), np.asarray(rc_j.cnt))
    np.testing.assert_allclose(rc_t.xyz.numpy(), np.asarray(rc_j.xyz),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(rc_t.intensity.numpy(),
                               np.asarray(rc_j.intensity), atol=1e-5, rtol=0)
    np.testing.assert_allclose(curv_t.numpy(), np.asarray(curv_j),
                               atol=1e-6, rtol=1e-5)
    # JAX reports the batch-wide sum; the port one count per stream
    assert ovf_t.shape == (B,)
    assert int(ovf_t.sum()) == int(ovf_j)


def test_extract_features_b_matches_jax(scene, jax_fns):
    """From the same ring grid and curvature: all five clouds in the same
    order (atol 1e-5), masks exact, overflow sums equal."""
    reg, ext, _ = jax_fns
    rc_j, curv_j, _ = reg(scene[0][0], scene[1][0])
    f_j = ext(rc_j, curv_j)
    rc_t = RingCloud(xyz=_t(rc_j.xyz), intensity=_t(rc_j.intensity),
                     cnt=_t(rc_j.cnt))
    f_t = extract_features_b(rc_t, _t(curv_j), CFG)
    for name in CLOUDS:
        cj, ct = getattr(f_j, name), getattr(f_t, name)
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask),
                                      err_msg=name)
        np.testing.assert_allclose(ct.xyz.numpy(), np.asarray(cj.xyz),
                                   atol=1e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(ct.intensity.numpy(),
                                   np.asarray(cj.intensity), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert f_t.overflow.shape == (B,)
    assert int(f_t.overflow.sum()) == int(f_j.overflow)


def test_odometry_step_b_matches_jax(scene, jax_fns):
    """From the same mid-sequence state (carried over with
    state_from_numpy) and the same features: poses atol 5e-4, counts ±3."""
    reg, ext, odo = jax_fns
    feats = [ext(*reg(scene[0][f], scene[1][f])[:2]) for f in range(2)]
    st_j, _ = odo(_jax_init(CFG), feats[0])
    st_j1, m_j = odo(st_j, feats[1])

    st_t = tod.state_from_numpy(jax.tree.map(np.asarray, st_j), "cpu")
    assert st_t.initialized.dtype == torch.bool
    st_t1, m_t = tod.odometry_step_b(st_t, _feats_to_torch(feats[1]), CFG)
    for name in ("q_w", "t_w", "q_lc", "t_lc"):
        np.testing.assert_allclose(getattr(st_t1, name).numpy(),
                                   np.asarray(getattr(st_j1, name)),
                                   atol=5e-4, err_msg=name)
    for name in ("corner_corr", "plane_corr"):
        diff = np.abs(getattr(m_t, name).numpy()
                      - np.asarray(getattr(m_j, name)))
        assert diff.max() <= 3, (name, diff)
    assert (m_t.corner_corr > 0).all() and (m_t.plane_corr > 0).all()
    np.testing.assert_allclose(m_t.cost.numpy(), np.asarray(m_j.cost),
                               rtol=5e-2)


def test_front_step_b_matches_jax_chain(scene, jax_fns):
    """The port's front_step_b over 3 frames against JAX's
    register_scan_b -> extract_features_b -> odometry_step_b under jit:
    per frame t atol 5e-3 m and q atol 2e-3; feature counts exact and the
    per-stream frontend overflow summing to JAX's batch-wide value."""
    reg, ext, odo = jax_fns
    st_j = _jax_init(CFG)
    st_t = tp.init_state(CFG, B, "cpu")
    for f in range(N_FRAMES):
        rc, curv, ovf = reg(scene[0][f], scene[1][f])
        feats = ext(rc, curv)
        st_j, m_j = odo(st_j, feats)
        st_t, out = tp.front_step_b(st_t, _t(scene[0][f]), _t(scene[1][f]),
                                    CFG)
        np.testing.assert_allclose(out.t_odom.numpy(), np.asarray(st_j.t_w),
                                   atol=5e-3, err_msg=f"frame {f}")
        np.testing.assert_allclose(out.q_odom.numpy(), np.asarray(st_j.q_w),
                                   atol=2e-3, err_msg=f"frame {f}")
        assert tuple(out.metrics) == tp.FRONT_METRIC_NAMES
        for name, cloud in (("n_sharp", "sharp"), ("n_flat", "flat"),
                            ("n_less_sharp", "less_sharp"),
                            ("n_less_flat", "less_flat")):
            np.testing.assert_array_equal(
                out.metrics[name].numpy(),
                np.asarray(getattr(feats, cloud).mask.sum(axis=1)))
        assert float(out.metrics["frontend_overflow"].sum()) == \
            float(ovf + feats.overflow)
    # the scene moves: the odometry must have followed it
    assert (np.linalg.norm(out.t_odom.numpy(), axis=1) > 0.05).all()


def test_port_runs_without_jax():
    """The card's machine has no JAX: the port must import and run one
    front step and one whole step (mapping included) with ``jax``
    unimportable."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        torch.set_num_threads(1)
        from aloam_tpu.config import AloamConfig
        from aloam_tpu.io import synthetic as syn
        from aloam_tpu_torch import pipeline
        cfg = AloamConfig(scan_lines=16, minimum_range=0.3, n_raw=2048,
                          ring_cap=128, less_flat_cap=1024)
        scans, _ = syn.make_sequence(1, scan_lines=16, n_azimuth=128,
                                     seed=1)
        xyz, mask = syn.pad_scan(scans[0], cfg.n_raw)
        st = pipeline.init_state(cfg, 1, "cpu")
        st, out = pipeline.front_step_b(st, torch.from_numpy(xyz)[None],
                                        torch.from_numpy(mask)[None], cfg)
        assert out.q_odom.shape == (1, 4)
        assert out.metrics["n_sharp"].item() > 0
        st, out = pipeline.step_b(st, torch.from_numpy(xyz)[None],
                                  torch.from_numpy(mask)[None], cfg)
        assert out.q_map.shape == (1, 4) and st.frame == 2
        assert out.metrics.shape == (1, len(pipeline.METRIC_NAMES))
        assert sys.modules["jax"] is None
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_port_sources_never_import_jax():
    """No file of the port, and not chip_smoke.py, imports JAX."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "aloam_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for p in paths:
        with open(p) as fh:
            for line in fh:
                s = line.strip()
                assert not (s.startswith("import jax")
                            or s.startswith("from jax")), (p, s)
