"""Trajectory / map visualization — the rviz stand-in (SURVEY.md §5).

The reference's live dashboards are rviz displays of the GT/odometry/mapped
paths and the accumulated map clouds (rviz_cfg/aloam_velodyne.rviz). Here the
same artifacts render to PNG with matplotlib (headless-safe) from the arrays
the pipeline already produces."""

from __future__ import annotations

import numpy as np


def plot_trajectories(paths: dict[str, np.ndarray], out_path: str,
                      title: str = "trajectories"):
    """Bird's-eye (x, y) overlay of named trajectories, like the reference's
    rviz path displays (/path_gt, /laser_odom_path, /aft_mapped_path)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    for name, tr in paths.items():
        tr = np.asarray(tr)
        ax.plot(tr[:, 0], tr[:, 1], label=name, linewidth=1.2)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_map_cloud(xyz: np.ndarray, out_path: str, max_points: int = 200000,
                   title: str = "map"):
    """Bird's-eye scatter of a map point cloud (the /laser_cloud_map
    equivalent, laserMapping.cpp:823-836)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xyz = np.asarray(xyz)
    if xyz.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(xyz.shape[0], max_points,
                                              replace=False)
        xyz = xyz[sel]
    fig, ax = plt.subplots(figsize=(9, 9))
    sc = ax.scatter(xyz[:, 0], xyz[:, 1], c=xyz[:, 2], s=0.3,
                    cmap="viridis", linewidths=0)
    fig.colorbar(sc, label="z [m]")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.axis("equal")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
