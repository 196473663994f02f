"""Synthetic Velodyne-style LiDAR simulator.

The reference validates only by replaying datasets (KITTI via
``kittiHelper.cpp``, VLP-16 rosbags — SURVEY.md §4). No dataset ships with
this machine, so this module raytraces ring-structured scans of a synthetic
urban world (ground plane, building walls, poles) from a known trajectory.
That gives:

* deterministic inputs for golden tests (oracle vs JAX frontend),
* ground-truth poses for ATE/RPE evaluation of the full pipeline,
* unbounded benchmark data at exact HDL-64/32/VLP-16 geometry.

Emits points in Velodyne convention (x forward, y left, z up), ordered in
firing order (azimuth-major sweep), the same layout `scanRegistration`
consumes from ``/velodyne_points``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_MAX_RANGE = 120.0


def elevation_angles(scan_lines: int) -> np.ndarray:
    """Per-ring elevation angles [deg] inverting the reference's ring-ID
    formulas (scanRegistration.cpp:169-205), so ring assignment of simulated
    points recovers the laser index exactly."""
    # beams are placed strictly inside their ring's angular bin (off the
    # int() rounding boundaries and the keep-range edges) so that f32/f64
    # rounding can never flip the assignment
    if scan_lines == 16:
        # scanID = int((angle + 15) / 2 + 0.5)  -> bin value i + 0.625
        return 2.0 * np.arange(16) - 15.0 + 0.25
    if scan_lines == 32:
        # scanID = int((angle + 92/3) * 3/4)    -> bin value i + 0.5
        return (np.arange(32) + 0.5) * 4.0 / 3.0 - 92.0 / 3.0
    if scan_lines == 64:
        # upper: scanID = int((2 - angle)*3 + 0.5)        -> value i + 0.75
        # lower: scanID = 32 + int((-8.83 - angle)*2 + 0.5) -> value k + 0.75
        upper = 2.0 - (np.arange(32) + 0.25) / 3.0
        lower = -8.955 - np.arange(32) / 2.0
        return np.concatenate([upper, lower])
    raise ValueError(f"unsupported scan_lines={scan_lines}")


@dataclasses.dataclass
class World:
    """Scene primitives. Walls are axis-aligned vertical rectangles; poles
    are vertical cylinders; ground is the plane z=0 (world frame)."""
    # walls: (W, 6) = [axis(0:x-normal,1:y-normal), coord, lo0, hi0, z0, z1]
    walls: np.ndarray
    # poles: (P, 4) = [cx, cy, radius, height]
    poles: np.ndarray
    ground_z: float = 0.0


def street_canyon(seed: int = 0, length: float = 400.0) -> World:
    """A street canyon: two long building facades with setbacks (vertical
    corner edges), lamp poles, and cross walls — rich in both edge and
    planar LOAM features."""
    rng = np.random.default_rng(seed)
    walls = []
    # building facades along +x at y = ±(7..12), segmented with setbacks
    for side in (-1.0, 1.0):
        x = -20.0
        while x < length:
            seg = rng.uniform(15.0, 35.0)
            y = side * rng.uniform(7.0, 12.0)
            h = rng.uniform(5.0, 15.0)
            # facade: y-normal wall spanning [x, x+seg]
            walls.append([1, y, x, x + seg, 0.0, h])
            # setback side wall: x-normal at segment end, from y to y±3
            walls.append([0, x + seg, min(y, y + side * 3.0),
                          max(y, y + side * 3.0), 0.0, h])
            x += seg
    # some cross-street walls far ahead
    for xc in (length + 10.0, -30.0):
        walls.append([0, xc, -15.0, 15.0, 0.0, 8.0])
    # parked boxes (cars/dumpsters): four vertical faces each — their
    # x-normal faces are what constrains forward motion for plane factors
    x = 5.0
    while x < length:
        side = 1.0 if (int(x / 23) % 2 == 0) else -1.0
        y0 = side * rng.uniform(4.0, 5.5)
        lx = rng.uniform(3.5, 5.0)
        ly = 1.8
        h = rng.uniform(1.4, 2.2)
        ylo, yhi = min(y0, y0 + side * ly), max(y0, y0 + side * ly)
        walls.append([0, x, ylo, yhi, 0.0, h])           # rear face
        walls.append([0, x + lx, ylo, yhi, 0.0, h])      # front face
        walls.append([1, ylo, x, x + lx, 0.0, h])        # inner side
        walls.append([1, yhi, x, x + lx, 0.0, h])        # outer side
        x += rng.uniform(18.0, 30.0)

    poles = []
    x = 0.0
    while x < length:
        side = 1.0 if (int(x / 17) % 2 == 0) else -1.0
        poles.append([x, side * 5.5, 0.15, 6.0])
        x += 17.0
    return World(walls=np.asarray(walls, np.float64),
                 poles=np.asarray(poles, np.float64))


def _ray_world_hits(origins: np.ndarray, dirs: np.ndarray,
                    world: World) -> np.ndarray:
    """Nearest-hit distances for rays (N,3 origins, N,3 unit dirs)."""
    n = origins.shape[0]
    t_best = np.full(n, _MAX_RANGE, np.float64)

    # ground plane z = ground_z
    dz = dirs[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (world.ground_z - origins[:, 2]) / dz
    ok = (dz < -1e-9) & (t > 0.1) & (t < t_best)
    t_best = np.where(ok, t, t_best)

    # walls
    for axis, coord, lo, hi, z0, z1 in world.walls:
        a = int(axis)  # 0: plane x=coord (spans y in [lo,hi]); 1: plane y=coord
        d = dirs[:, a]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (coord - origins[:, a]) / d
        p = origins + t[:, None] * dirs
        other = 1 - a
        ok = (np.abs(d) > 1e-9) & (t > 0.1) & (t < t_best) \
            & (p[:, other] >= lo) & (p[:, other] <= hi) \
            & (p[:, 2] >= z0) & (p[:, 2] <= z1)
        t_best = np.where(ok, t, t_best)

    # poles (infinite cylinder clipped by height)
    for cx, cy, r, h in world.poles:
        ox = origins[:, 0] - cx
        oy = origins[:, 1] - cy
        dx, dy = dirs[:, 0], dirs[:, 1]
        a = dx * dx + dy * dy
        b = 2 * (ox * dx + oy * dy)
        c = ox * ox + oy * oy - r * r
        disc = b * b - 4 * a * c
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
        p_z = origins[:, 2] + t * dirs[:, 2]
        ok = (disc > 0) & (a > 1e-12) & (t > 0.1) & (t < t_best) \
            & (p_z >= world.ground_z) & (p_z <= world.ground_z + h)
        t_best = np.where(ok, t, t_best)

    return t_best


@dataclasses.dataclass
class Trajectory:
    """Ground-truth sensor poses: quaternions (F,4 wxyz) + positions (F,3)."""
    quats: np.ndarray
    trans: np.ndarray


def drive_trajectory(n_frames: int, speed: float = 10.0,
                     period: float = 0.1, yaw_rate: float = 0.02,
                     height: float = 1.8, accel: float = 0.0) -> Trajectory:
    """A car driving forward with a gentle yaw drift (10 m/s, 10 Hz).

    ``accel`` [m/s²] ramps the speed over the sequence: v(t) = speed +
    accel·t. Non-zero accel makes consecutive sweeps warp *differently*
    under motion distortion — with constant velocity the warp is
    common-mode between frames and rigid frame-to-frame registration is
    nearly unbiased, so distortion-model tests need accel to have a
    structural signal."""
    ts = np.arange(n_frames) * period
    yaw = yaw_rate * ts
    v = speed + accel * ts
    # integrate position
    x = np.concatenate([[0.0], np.cumsum(v[:-1] * period * np.cos(yaw[:-1]))])
    y = np.concatenate([[0.0], np.cumsum(v[:-1] * period * np.sin(yaw[:-1]))])
    z = np.full(n_frames, height)
    quats = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)],
                     axis=-1)
    return Trajectory(quats=quats,
                      trans=np.stack([x, y, z], axis=-1))


def render_scan(world: World, q_wxyz: np.ndarray, t_xyz: np.ndarray,
                scan_lines: int = 64, n_azimuth: int = 1800,
                noise: float = 0.01, seed: int = 0,
                dropout: float = 0.05) -> np.ndarray:
    """Raytrace one scan. Returns (N, 4) float32 [x, y, z, reflectance] in the
    sensor frame, firing-order (azimuth-major), like a KITTI .bin payload."""
    rng = np.random.default_rng(seed)
    el = np.deg2rad(elevation_angles(scan_lines))
    # azimuth sweep: ori = -atan2(y, x) increases with time (clockwise)
    az0 = rng.uniform(-np.pi, np.pi)
    theta = az0 - 2 * np.pi * np.arange(n_azimuth) / n_azimuth

    th, e = np.meshgrid(theta, el, indexing="ij")   # (A, R)
    dirs_s = np.stack([np.cos(e) * np.cos(th),
                       np.cos(e) * np.sin(th),
                       np.sin(e)], axis=-1).reshape(-1, 3)

    # rotate to world
    w, xq, yq, zq = q_wxyz
    R = np.array([
        [1 - 2 * (yq * yq + zq * zq), 2 * (xq * yq - w * zq),
         2 * (xq * zq + w * yq)],
        [2 * (xq * yq + w * zq), 1 - 2 * (xq * xq + zq * zq),
         2 * (yq * zq - w * xq)],
        [2 * (xq * zq - w * yq), 2 * (yq * zq + w * xq),
         1 - 2 * (xq * xq + yq * yq)],
    ])
    dirs_w = dirs_s @ R.T
    origins = np.broadcast_to(t_xyz, dirs_w.shape)

    t_hit = _ray_world_hits(origins, dirs_w, world)
    hit = t_hit < _MAX_RANGE
    if dropout > 0:
        hit &= rng.uniform(size=hit.shape) > dropout
    rr = t_hit + rng.normal(scale=noise, size=t_hit.shape)
    pts_s = dirs_s * rr[:, None]
    refl = rng.uniform(0.0, 1.0, size=(pts_s.shape[0], 1))
    out = np.concatenate([pts_s, refl], axis=-1)[hit]
    return out.astype(np.float32)


def _np_slerp(q0: np.ndarray, q1: np.ndarray, s: float) -> np.ndarray:
    """Quaternion slerp (wxyz), shortest arc."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 1 - 1e-9:
        out = q0 + s * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1 - s) * th) * q0 + np.sin(s * th) * q1) / np.sin(th)


def _q_to_R(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def render_scan_distorted(world: World, q0: np.ndarray, t0: np.ndarray,
                          q1: np.ndarray, t1: np.ndarray,
                          scan_lines: int = 64, n_azimuth: int = 1800,
                          noise: float = 0.01, seed: int = 0,
                          dropout: float = 0.05) -> np.ndarray:
    """Raytrace one *motion-distorted* scan: azimuth column j fires at
    sweep fraction τ = j/n_azimuth from the interpolated pose
    slerp/lerp((q0,t0) → (q1,t1), τ), and its points are returned in the
    sensor frame *at fire time* — the physical model the reference's
    DISTORTION=1 path (laserOdometry.cpp:59,111-129) undoes with per-point
    slerp by the intensity-encoded time fraction."""
    rng = np.random.default_rng(seed)
    el = np.deg2rad(elevation_angles(scan_lines))
    az0 = rng.uniform(-np.pi, np.pi)
    theta = az0 - 2 * np.pi * np.arange(n_azimuth) / n_azimuth
    tau = np.arange(n_azimuth) / n_azimuth

    th, e = np.meshgrid(theta, el, indexing="ij")   # (A, R)
    dirs_s = np.stack([np.cos(e) * np.cos(th),
                       np.cos(e) * np.sin(th),
                       np.sin(e)], axis=-1)          # (A, R, 3)

    # per-column pose along the sweep
    Rs = np.stack([_q_to_R(_np_slerp(np.asarray(q0, np.float64),
                                     np.asarray(q1, np.float64), s))
                   for s in tau])                    # (A, 3, 3)
    ts = (1 - tau)[:, None] * np.asarray(t0) + tau[:, None] * np.asarray(t1)

    dirs_w = np.einsum("aij,arj->ari", Rs, dirs_s).reshape(-1, 3)
    origins = np.repeat(ts, scan_lines, axis=0)

    t_hit = _ray_world_hits(origins, dirs_w, world)
    hit = t_hit < _MAX_RANGE
    if dropout > 0:
        hit &= rng.uniform(size=hit.shape) > dropout
    rr = t_hit + rng.normal(scale=noise, size=t_hit.shape)
    pts_s = dirs_s.reshape(-1, 3) * rr[:, None]      # sensor frame @ fire time
    refl = rng.uniform(0.0, 1.0, size=(pts_s.shape[0], 1))
    out = np.concatenate([pts_s, refl], axis=-1)[hit]
    return out.astype(np.float32)


def make_distorted_sequence(n_frames: int, scan_lines: int = 64,
                            seed: int = 0, n_azimuth: int = 1800,
                            speed: float = 10.0, noise: float = 0.01,
                            dropout: float = 0.05,
                            yaw_rate: float = 0.02, accel: float = 0.0):
    """Motion-distorted synthetic sequence: frame i sweeps from GT pose i to
    GT pose i+1. Returns (scans, traj) where traj holds n_frames+1 poses;
    traj.trans[i] is frame i's *sweep-start* pose. The pipeline's
    distortion-mode pose chain tracks sweep-END frames (TransformToEnd
    semantics), so estimated frame i compares against GT pose i+1 rebased
    to GT pose 1 (frame 0 initializes at its start pose)."""
    dur = 0.1 * n_frames
    world = street_canyon(seed=seed, length=max(
        100.0, (speed + 0.5 * accel * dur) * dur + 60))
    traj = drive_trajectory(n_frames + 1, speed=speed, yaw_rate=yaw_rate,
                            accel=accel)
    scans = [render_scan_distorted(
        world, traj.quats[i], traj.trans[i], traj.quats[i + 1],
        traj.trans[i + 1], scan_lines=scan_lines, n_azimuth=n_azimuth,
        seed=seed * 10007 + i, noise=noise, dropout=dropout)
        for i in range(n_frames)]
    return scans, traj


def make_sequence(n_frames: int, scan_lines: int = 64, seed: int = 0,
                  n_azimuth: int = 1800, speed: float = 10.0,
                  noise: float = 0.01, dropout: float = 0.05):
    """Generate a full synthetic sequence: list of (N_i, 4) scans + GT."""
    world = street_canyon(seed=seed, length=max(100.0,
                                                speed * 0.1 * n_frames + 60))
    traj = drive_trajectory(n_frames, speed=speed)
    scans = [render_scan(world, traj.quats[i], traj.trans[i],
                         scan_lines=scan_lines, n_azimuth=n_azimuth,
                         seed=seed * 10007 + i, noise=noise, dropout=dropout)
             for i in range(n_frames)]
    return scans, traj


def pad_scan(points: np.ndarray, n_pad: int):
    """Pad/truncate an (N, >=3) scan to (n_pad, 3) xyz + validity mask."""
    n = min(points.shape[0], n_pad)
    xyz = np.zeros((n_pad, 3), np.float32)
    xyz[:n] = points[:n, :3]
    mask = np.zeros((n_pad,), bool)
    mask[:n] = True
    return xyz, mask
