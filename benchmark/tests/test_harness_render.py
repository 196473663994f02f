"""The traffic generator: deterministic by seed, the port's synthetic
world and ray cast, rings that the reference's ring formula recovers."""

import math

import numpy as np
import pytest
import torch

from aloam_tpu_torch.io import synthetic as syn
from benchmark import render
from benchmark.reference.aloam.config import AloamConfig
from benchmark.reference.aloam.frontend.registration import register_scan_b

SENSOR = {"scan_lines": 16, "azimuth": 180, "noise": 0.01, "dropout": 0.05}
TRAFFIC = {"pool": 2, "frames": 3,
           "yaw": {"rate": 0.0, "amplitude": 0.05, "period_s": 20.0},
           "speed": {"kind": "ladder", "base": 5.0, "step": 0.25,
                     "block": 16, "offsets": [0.125, 0.0625, 0.1875]}}


def test_same_seed_same_logs_other_seed_other_logs():
    a = render.render_pool(SENSOR, TRAFFIC, 4096, 2**31 + 11, "cpu")
    b = render.render_pool(SENSOR, TRAFFIC, 4096, 2**31 + 11, "cpu")
    c = render.render_pool(SENSOR, TRAFFIC, 4096, 2**31 + 12, "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert not torch.equal(a[0], c[0])


def test_points_at_the_head():
    xyz, mask, gt = render.render_pool(SENSOR, TRAFFIC, 4096, 5, "cpu")
    n = mask.sum(-1)
    assert bool((mask == (torch.arange(4096) < n[..., None])).all())
    assert bool((xyz[~mask] == 0).all())
    # 5% dropout and the sky: most rays of a street canyon hit something
    assert bool((n > 0.6 * 16 * 180).all() and (n <= 16 * 180).all())
    assert gt.shape == (2, 3, 3) and np.allclose(gt[:, 0], 0)


def test_world_is_the_ports_draw_for_draw():
    w = render.street_canyon(np.random.default_rng(9), 150.0)
    ref = syn.street_canyon(seed=9, length=150.0)
    assert np.array_equal(w.walls, ref.walls)
    assert np.array_equal(w.poles, ref.poles)


def test_ray_cast_matches_the_ports():
    rng = np.random.default_rng(3)
    world = syn.street_canyon(seed=4, length=120.0)
    org = np.array([[10.0, 0.5, 1.8]])
    d = rng.normal(size=(2000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = syn._ray_world_hits(np.repeat(org, len(d), 0), d, world)
    got = render._cast(render.World(world.walls, world.poles),
                       torch.tensor(org[None], dtype=torch.float32),
                       torch.tensor(d[None], dtype=torch.float32))[0]
    assert np.allclose(got.numpy(), want, atol=2e-3)


def test_culled_primitives_cannot_be_hit():
    world = render.street_canyon(np.random.default_rng(1), 600.0)
    near = render._near(world, np.array([[0.0, 0.0], [30.0, 1.0]]))
    assert 0 < len(near.walls) < len(world.walls)
    rng = np.random.default_rng(2)
    d = rng.normal(size=(4000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = torch.tensor([[[15.0, 0.5, 1.8]]])
    dirs = torch.tensor(d[None], dtype=torch.float32)
    assert torch.equal(render._cast(near, org, dirs),
                       render._cast(world, org, dirs))


@pytest.mark.parametrize("lines,n_raw,ring_cap",
                         [(16, 4096, 256), (64, 12288, 256)])
def test_rings_come_back_through_the_ring_formula(lines, n_raw, ring_cap):
    """With no noise and no dropout every ray hits or misses in firing
    order; the reference's registration puts ray (a, r)'s point on ring r,
    so each ring holds as many points as hit on that beam (less the
    HDL-64 rings the reference drops)."""
    sensor = dict(SENSOR, scan_lines=lines, noise=0.0, dropout=0.0)
    traffic = dict(TRAFFIC, pool=1, frames=1)
    xyz, mask, _ = render.render_pool(sensor, traffic, n_raw, 7, "cpu")
    cfg = AloamConfig(scan_lines=lines, minimum_range=0.3, n_raw=n_raw,
                      ring_cap=ring_cap)
    rc, _, _ = register_scan_b(xyz[:, 0], mask[:, 0], cfg)
    # the beam of each point from its elevation, as the sensor fired it
    el = np.deg2rad(render.elevation_angles(lines))
    p = xyz[0, 0][mask[0, 0]].double().numpy()
    ang = np.arctan2(p[:, 2], np.hypot(p[:, 0], p[:, 1]))
    beam = np.abs(ang[:, None] - el[None]).argmin(1)
    assert np.abs(ang - el[beam]).max() < math.radians(0.05)
    per_beam = np.bincount(beam, minlength=lines)
    if lines == 64:
        # scanRegistration.cpp drops HDL-64 rings above 50 (angle < -24.33)
        per_beam[51:] = 0
    assert np.array_equal(rc.cnt[0].numpy(), per_beam)


def test_a_full_buffer_keeps_the_first_n_raw_hits():
    """More returns than n_raw: the first n_raw in firing order are kept,
    as the same scan with room for all of them has them."""
    traffic = dict(TRAFFIC, pool=1, frames=2)
    big = render.render_pool(SENSOR, traffic, 4096, 9, "cpu")
    small = render.render_pool(SENSOR, traffic, 1000, 9, "cpu")
    assert bool((big[1].sum(-1) > 1000).all())
    assert bool(small[1].all())
    assert torch.equal(small[0], big[0][:, :, :1000])
