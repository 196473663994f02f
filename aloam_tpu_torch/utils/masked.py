"""Masked fixed-capacity compaction (port of ``aloam_tpu/utils/masked.py``):
the std::vector of the reference as a buffer of static capacity."""

from __future__ import annotations

import torch


def compact(values: torch.Tensor, mask: torch.Tensor, cap: int):
    """Pack the masked rows of values (N, ...) to the front of a buffer of
    ``cap`` rows, in order; mask (N,). Returns (out (cap, ...), out_mask
    (cap,), n_dropped), n_dropped the masked rows past ``cap``. One
    scatter into a spare row past the end takes every row not kept."""
    pos = mask.to(torch.int64).cumsum(0) - 1
    dest = torch.where(mask & (pos < cap), pos, cap)
    out = values.new_zeros((cap + 1,) + tuple(values.shape[1:]))
    out.index_copy_(0, dest, values)
    total = pos[-1] + 1
    kept = total.clamp_max(cap)
    out_mask = torch.arange(cap, device=mask.device) < kept
    return out[:cap], out_mask, total - kept


def compact_cloud(xyz: torch.Tensor, intensity: torch.Tensor,
                  mask: torch.Tensor, cap: int):
    """:func:`compact` of an (xyz (..., 3), intensity (...)) cloud,
    flattened; returns (xyz (cap, 3), intensity (cap,), mask, dropped)."""
    vals = torch.cat([xyz, intensity[..., None]], dim=-1)
    out, out_mask, dropped = compact(vals.reshape(-1, 4), mask.reshape(-1),
                                     cap)
    return out[:, :3], out[:, 3], out_mask, dropped
