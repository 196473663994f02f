"""KITTI odometry dataset loader (component C1 of SURVEY.md §2).

Host-side replacement for the reference's ``src/kittiHelper.cpp``: reads the
float32 ``.bin`` point clouds (:25-35,130-135), ``times.txt`` and the
ground-truth pose files (:68-72), and rotates GT from the camera frame to
the LiDAR frame with R = [0 0 1; -1 0 0; 0 -1 0] (:78-111). Instead of
publishing ROS topics it yields padded device-ready arrays; instead of the
optional rosbag export (:164-171) there is an ``.npz`` export.

The stereo PNGs the helper also publishes are unused by the SLAM path
(SURVEY.md §2.3) and are not loaded.
"""

from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np

# camera -> lidar axis rotation (kittiHelper.cpp:78-80)
R_CAM_TO_LIDAR = np.array([[0.0, 0.0, 1.0],
                           [-1.0, 0.0, 0.0],
                           [0.0, -1.0, 0.0]])


class KittiFrame(NamedTuple):
    xyz: np.ndarray          # (n_pad, 3) float32
    mask: np.ndarray         # (n_pad,) bool
    reflectance: np.ndarray  # (n_pad,) float32
    timestamp: float
    gt_q: np.ndarray | None  # (4,) wxyz in lidar axes, or None
    gt_t: np.ndarray | None  # (3,)


def read_bin(path: str) -> np.ndarray:
    """One KITTI velodyne scan: (N, 4) float32 [x y z reflectance]."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def _mat_to_quat_wxyz(m: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
    if w > 1e-6:
        x = (m[2, 1] - m[1, 2]) / (4 * w)
        y = (m[0, 2] - m[2, 0]) / (4 * w)
        z = (m[1, 0] - m[0, 1]) / (4 * w)
    else:  # fall back via the dominant diagonal element
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(0.0, 1.0 + m[i, i] - m[j, j] - m[k, k])) * 2.0
        q = np.zeros(4)
        q[1 + i] = s / 4
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
        q[0] = (m[k, j] - m[j, k]) / s
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def load_gt_poses(path: str):
    """Ground-truth 3x4 poses -> (quats (F,4) wxyz, trans (F,3)), rotated to
    LiDAR axes (kittiHelper.cpp:108-111)."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    quats, trans = [], []
    for m in raw:
        quats.append(_mat_to_quat_wxyz(R_CAM_TO_LIDAR @ m[:, :3]))
        trans.append(R_CAM_TO_LIDAR @ m[:, 3])
    return np.stack(quats), np.stack(trans)


def sequence_paths(dataset_folder: str, sequence: str):
    """File layout used by kittiHelper (kittiHelper.cpp:68-72,130-133)."""
    times = os.path.join(dataset_folder, "sequences", sequence, "times.txt")
    gt = os.path.join(dataset_folder, "results", f"{sequence}.txt")
    velo_dir = os.path.join(dataset_folder, "velodyne", "sequences",
                            sequence, "velodyne")
    return times, gt, velo_dir


def iter_sequence(dataset_folder: str, sequence: str, n_pad: int = 131072,
                  ) -> Iterator[KittiFrame]:
    """Yield frames in timestamp order, padded to n_pad."""
    times_path, gt_path, velo_dir = sequence_paths(dataset_folder, sequence)
    times = np.loadtxt(times_path)
    have_gt = os.path.exists(gt_path)
    if have_gt:
        quats, trans = load_gt_poses(gt_path)
    for i, ts in enumerate(np.atleast_1d(times)):
        pts = read_bin(os.path.join(velo_dir, f"{i:06d}.bin"))
        n = min(pts.shape[0], n_pad)
        xyz = np.zeros((n_pad, 3), np.float32)
        refl = np.zeros((n_pad,), np.float32)
        mask = np.zeros((n_pad,), bool)
        xyz[:n] = pts[:n, :3]
        refl[:n] = pts[:n, 3]
        mask[:n] = True
        yield KittiFrame(
            xyz=xyz, mask=mask, reflectance=refl, timestamp=float(ts),
            gt_q=quats[i] if have_gt else None,
            gt_t=trans[i] if have_gt else None)


def export_npz(dataset_folder: str, sequence: str, out_path: str,
               n_pad: int = 131072, max_frames: int | None = None):
    """Dataset re-export (the rosbag-export analog, kittiHelper.cpp:164-171).
    """
    xs, ms, ts, qs, tr = [], [], [], [], []
    for i, f in enumerate(iter_sequence(dataset_folder, sequence, n_pad)):
        if max_frames is not None and i >= max_frames:
            break
        xs.append(f.xyz)
        ms.append(f.mask)
        ts.append(f.timestamp)
        if f.gt_q is not None:
            qs.append(f.gt_q)
            tr.append(f.gt_t)
    np.savez_compressed(
        out_path, xyz=np.stack(xs), mask=np.stack(ms),
        times=np.asarray(ts),
        gt_q=np.stack(qs) if qs else np.zeros((0, 4)),
        gt_t=np.stack(tr) if tr else np.zeros((0, 3)))
