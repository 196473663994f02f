"""The benchmark's traffic generator: synthetic Velodyne logs raytraced on
the card from the run's seed.

A PyTorch copy of ``aloam_tpu_torch/io/synthetic.py`` (``street_canyon``,
``drive_trajectory``, ``elevation_angles``, the ray cast against the ground,
the walls and the poles, range noise, dropout, and the padding to ``n_raw``
with the points at the head). The world (a few hundred primitives) and the
trajectory are laid out on the host from the seed; every ray is cast on the
device, a chunk of frames at a time and only against the primitives within
the sensor's 120 m of that chunk's positions, with the range noise and the
dropout drawn from one ``torch.Generator`` on the device. The reflectance
channel of ``synthetic.render_scan`` is not drawn: the step reads xyz only.

One log is one drive through its own street canyon: ``frames`` scans at
10 Hz, at ``speed`` m/s, its heading from the traffic's ``yaw`` rule
(:func:`drive_trajectory`). Log k of a run gets the world seed (seed, k)
and its speed from the traffic's speed rule (:func:`stream_speed`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

MAX_RANGE = 120.0
PERIOD = 0.1          # the sensor's 10 Hz
HEIGHT = 1.8          # the sensor above the ground, m


def elevation_angles(scan_lines: int) -> np.ndarray:
    """Per-ring elevation angles in degrees, each strictly inside its
    ring's bin of the ring-ID formulas (scanRegistration.cpp:169-205), so
    that rounding never moves a point to another ring."""
    if scan_lines == 16:
        return 2.0 * np.arange(16) - 15.0 + 0.25
    if scan_lines == 32:
        return (np.arange(32) + 0.5) * 4.0 / 3.0 - 92.0 / 3.0
    if scan_lines == 64:
        upper = 2.0 - (np.arange(32) + 0.25) / 3.0
        lower = -8.955 - np.arange(32) / 2.0
        return np.concatenate([upper, lower])
    raise ValueError(f"unsupported scan_lines={scan_lines}")


class World(NamedTuple):
    walls: np.ndarray   # (W, 6) [axis (0: x = coord, 1: y = coord), coord,
                        #         lo, hi, z0, z1], f64
    poles: np.ndarray   # (P, 4) [cx, cy, radius, height], f64


def street_canyon(rng: np.random.Generator, length: float) -> World:
    """Two facades with setbacks along +x, two cross walls, parked boxes
    and lamp poles (``synthetic.street_canyon``, draw for draw)."""
    walls = []
    for side in (-1.0, 1.0):
        x = -20.0
        while x < length:
            seg = rng.uniform(15.0, 35.0)
            y = side * rng.uniform(7.0, 12.0)
            h = rng.uniform(5.0, 15.0)
            walls.append([1, y, x, x + seg, 0.0, h])
            walls.append([0, x + seg, min(y, y + side * 3.0),
                          max(y, y + side * 3.0), 0.0, h])
            x += seg
    for xc in (length + 10.0, -30.0):
        walls.append([0, xc, -15.0, 15.0, 0.0, 8.0])
    x = 5.0
    while x < length:
        side = 1.0 if (int(x / 23) % 2 == 0) else -1.0
        y0 = side * rng.uniform(4.0, 5.5)
        lx = rng.uniform(3.5, 5.0)
        h = rng.uniform(1.4, 2.2)
        ylo, yhi = min(y0, y0 + side * 1.8), max(y0, y0 + side * 1.8)
        walls += [[0, x, ylo, yhi, 0.0, h], [0, x + lx, ylo, yhi, 0.0, h],
                  [1, ylo, x, x + lx, 0.0, h], [1, yhi, x, x + lx, 0.0, h]]
        x += rng.uniform(18.0, 30.0)
    poles = []
    x = 0.0
    while x < length:
        side = 1.0 if (int(x / 17) % 2 == 0) else -1.0
        poles.append([x, side * 5.5, 0.15, 6.0])
        x += 17.0
    return World(np.asarray(walls, np.float64), np.asarray(poles, np.float64))


def drive_trajectory(n_frames: int, speed: float, yaw: dict):
    """(quats (F, 4) wxyz, trans (F, 3)) of a car driving forward at
    ``speed``, the sensor at 1.8 m, its heading ``rate``·t +
    ``amplitude``·sin(2πt / ``period_s``) rad: ``synthetic.drive_trajectory``
    (a steady yaw rate) and ``drift.s_curve_trajectory`` (a slalom that
    stays mid-canyon over hundreds of frames) in one."""
    ts = np.arange(n_frames) * PERIOD
    yaw = yaw.get("rate", 0.0) * ts + yaw.get("amplitude", 0.0) \
        * np.sin(2 * np.pi * ts / yaw.get("period_s", 1.0))
    x = np.concatenate([[0.0], np.cumsum(speed * PERIOD * np.cos(yaw[:-1]))])
    y = np.concatenate([[0.0], np.cumsum(speed * PERIOD * np.sin(yaw[:-1]))])
    quats = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    return quats, np.stack([x, y, np.full(n_frames, HEIGHT)], -1)


def stream_speed(k: int, rule: dict) -> float:
    """Log k's speed in m/s. Rule ``"ladder"`` (the port's bench streams,
    at most 8.94 m/s against the map's 1.0 m gate): ``base + step·k`` for
    k < ``block``, then blocks of ``block`` with offsets ``offsets``
    between those speeds; rule ``"fixed"``: ``base``."""
    if rule["kind"] == "fixed":
        return float(rule["base"])
    base, step, block = rule["base"], rule["step"], rule["block"]
    if k < block:
        return base + step * k
    blk, off = divmod(k - block, block)
    return base + step * off + rule["offsets"][blk % len(rule["offsets"])]


def _rotations(quats: np.ndarray) -> np.ndarray:
    w, x, y, z = quats.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def _near(world: World, xy: np.ndarray) -> World:
    """The primitives whose footprint lies within MAX_RANGE of the box
    around the positions ``xy`` (F, 2): no ray from there can hit the
    others before its range runs out."""
    lo, hi = xy.min(0), xy.max(0)
    w = world.walls
    x0 = np.where(w[:, 0] == 0, w[:, 1], w[:, 2])
    x1 = np.where(w[:, 0] == 0, w[:, 1], w[:, 3])
    y0 = np.where(w[:, 0] == 0, w[:, 2], w[:, 1])
    y1 = np.where(w[:, 0] == 0, w[:, 3], w[:, 1])
    dx = np.maximum(0, np.maximum(x0 - hi[0], lo[0] - x1))
    dy = np.maximum(0, np.maximum(y0 - hi[1], lo[1] - y1))
    p = world.poles
    px = np.maximum(0, np.maximum(p[:, 0] - hi[0], lo[0] - p[:, 0]))
    py = np.maximum(0, np.maximum(p[:, 1] - hi[1], lo[1] - p[:, 1]))
    return World(w[np.hypot(dx, dy) < MAX_RANGE],
                 p[np.hypot(px, py) < MAX_RANGE + p[:, 2]])


def _cast(world: World, org: torch.Tensor, dirs: torch.Tensor):
    """Nearest-hit distance of each ray (``synthetic._ray_world_hits``):
    org (F, 1, 3), dirs (F, N, 3) unit; MAX_RANGE where nothing is hit."""
    ox, oy, oz = org.unbind(-1)
    dx, dy, dz = dirs.unbind(-1)
    t_best = torch.full(dx.shape, MAX_RANGE, dtype=dirs.dtype,
                        device=dirs.device)
    t = -oz / dz                                            # the ground
    t_best = torch.where((dz < -1e-9) & (t > 0.1) & (t < t_best), t, t_best)
    comp = ((ox, dx), (oy, dy))
    for axis, coord, lo, hi, z0, z1 in world.walls.tolist():
        (oa, da), (oo, do) = comp[int(axis)], comp[1 - int(axis)]
        t = (coord - oa) / da
        po, pz = oo + t * do, oz + t * dz
        ok = (da.abs() > 1e-9) & (t > 0.1) & (t < t_best) & (po >= lo) \
            & (po <= hi) & (pz >= z0) & (pz <= z1)
        t_best = torch.where(ok, t, t_best)
    a = dx * dx + dy * dy
    for cx, cy, r, h in world.poles.tolist():
        px, py = ox - cx, oy - cy
        b = 2 * (px * dx + py * dy)
        disc = b * b - 4 * a * (px * px + py * py - r * r)
        t = (-b - disc.clamp_min(0).sqrt()) / (2 * a)
        pz = oz + t * dz
        ok = (disc > 0) & (a > 1e-12) & (t > 0.1) & (t < t_best) \
            & (pz >= 0) & (pz <= h)
        t_best = torch.where(ok, t, t_best)
    return t_best


class Log(NamedTuple):
    xyz: torch.Tensor     # (F, n_raw, 3) f32, sensor frame, firing order
    mask: torch.Tensor    # (F, n_raw) bool, the points at the head
    gt: np.ndarray        # (F, 3) f64 positions from the log's frame 0


def render_log(sensor: dict, frames: int, speed: float, yaw: dict,
               n_raw: int, world_rng: np.random.Generator,
               gen: torch.Generator, device, chunk_rays: int = 1 << 22):
    """One log: ``frames`` scans of the sensor (``scan_lines``,
    ``azimuth`` steps a turn, ``noise`` m, ``dropout``) along a drive at
    ``speed`` through a street canyon drawn from ``world_rng``."""
    lines, az_n = sensor["scan_lines"], sensor["azimuth"]
    n = az_n * lines
    world = street_canyon(world_rng, max(100.0, speed * PERIOD * frames + 60))
    quats, trans = drive_trajectory(frames, speed, yaw)
    rot = torch.tensor(_rotations(quats), dtype=torch.float32, device=device)
    org = torch.tensor(trans, dtype=torch.float32, device=device)
    el = torch.tensor(np.deg2rad(elevation_angles(lines)),
                      dtype=torch.float32, device=device)
    # azimuth sweep: ori = -atan2(y, x) grows with time (clockwise)
    az0 = (torch.rand(frames, generator=gen, device=device) * 2 - 1) * math.pi
    keep = torch.rand((frames, n), generator=gen, device=device) \
        > sensor["dropout"]
    noise = torch.randn((frames, n), generator=gen, device=device) \
        * sensor["noise"]
    steps = torch.arange(az_n, device=device, dtype=torch.float32) \
        * (2 * math.pi / az_n)
    xyz = torch.zeros((frames, n_raw, 3), dtype=torch.float32, device=device)
    mask = torch.zeros((frames, n_raw), dtype=torch.bool, device=device)
    per = max(1, chunk_rays // n)
    for f0 in range(0, frames, per):
        f1 = min(frames, f0 + per)
        th = (az0[f0:f1, None] - steps)[:, :, None]           # (F, A, 1)
        e = el[None, None, :]                                  # (1, 1, R)
        ce = torch.cos(e)
        d_s = torch.stack(torch.broadcast_tensors(
            ce * torch.cos(th), ce * torch.sin(th), torch.sin(e)),
            -1).reshape(f1 - f0, n, 3)
        d_w = d_s @ rot[f0:f1].transpose(1, 2)
        t_hit = _cast(_near(world, trans[f0:f1, :2]), org[f0:f1, None], d_w)
        hit = (t_hit < MAX_RANGE) & keep[f0:f1]
        pts = d_s * (t_hit + noise[f0:f1])[..., None]
        slot = hit.cumsum(1) - 1
        hit &= slot < n_raw          # a full buffer keeps the first n_raw
        fi = torch.arange(f0, f1, device=device)[:, None].expand_as(slot)
        xyz[fi[hit], slot[hit]] = pts[hit]
        mask[f0:f1] = torch.arange(n_raw, device=device) \
            < hit.sum(1, keepdim=True)
    return Log(xyz, mask, trans - trans[0])


def world_rng(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), k])


def render_pool(sensor: dict, traffic: dict, n_raw: int, seed: int,
                device) -> tuple:
    """The traffic's pool of logs: (xyz (L, F, n_raw, 3), mask (L, F,
    n_raw), gt (L, F, 3) numpy), log k drawn from (seed, k)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    pool, frames = traffic["pool"], traffic["frames"]
    xyz = torch.empty((pool, frames, n_raw, 3), dtype=torch.float32,
                      device=device)
    mask = torch.empty((pool, frames, n_raw), dtype=torch.bool,
                       device=device)
    gt = np.empty((pool, frames, 3))
    for k in range(pool):
        log = render_log(sensor, frames,
                         stream_speed(k, traffic["speed"]),
                         traffic["yaw"], n_raw, world_rng(seed, k), gen,
                         device)
        xyz[k], mask[k], gt[k] = log.xyz, log.mask, log.gt
        del log
    return xyz, mask, gt
