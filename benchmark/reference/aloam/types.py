"""Core tensor containers (port of ``aloam_tpu/types.py``).

Every cloud is a fixed-capacity struct-of-arrays with a validity mask and
an explicit leading stream axis B."""

from __future__ import annotations

from typing import NamedTuple

import torch


class PointCloud(NamedTuple):
    """Padded point clouds: xyz (B, N, 3) f32, intensity (B, N) f32,
    mask (B, N) bool.

    ``intensity`` carries the reference's ring + scan_period*relTime
    encoding (scanRegistration.cpp:239); ``int(intensity)`` is the ring ID
    used by the correspondence ring windows (laserOdometry.cpp:308,315)."""
    xyz: torch.Tensor
    intensity: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(dim=-1)

    def ring(self) -> torch.Tensor:
        return self.intensity.to(torch.int32)


class RingCloud(NamedTuple):
    """Ring-major packed scans: (B, R, C, 3) xyz, (B, R, C) intensity,
    (B, R) counts. Slot j of ring r is concatenated index start_r + j of
    the reference's per-ring bucketing (scanRegistration.cpp:240-252)."""
    xyz: torch.Tensor
    intensity: torch.Tensor
    cnt: torch.Tensor

    def slot_mask(self) -> torch.Tensor:
        c = self.xyz.shape[-2]
        slot = torch.arange(c, device=self.cnt.device)
        return slot < self.cnt[..., None]


class ScanFeatures(NamedTuple):
    """The frontend's five clouds (scanRegistration.cpp:413-441), each with
    (B, cap, ·) leaves, and ``overflow`` (B,): points dropped by capacity
    limits per stream (0 = exact)."""
    sharp: PointCloud
    less_sharp: PointCloud
    flat: PointCloud
    less_flat: PointCloud
    full: PointCloud
    overflow: torch.Tensor
