"""Batched row gather (port of ``aloam_tpu/utils/batch.py:bgather``).

The JAX package's other ``*_b`` flat-op helpers exist only because
vmapped gathers lowered slowly on the TPU; the port writes batched torch
directly and needs only this one."""

from __future__ import annotations

import torch


def bgather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, N, ...); idx: (B, ...) integer in [0, N). Returns
    (B, *idx.shape[1:], *x.shape[2:])."""
    b, n = x.shape[0], x.shape[1]
    flat = x.reshape((b * n,) + tuple(x.shape[2:]))
    off = torch.arange(b, device=idx.device, dtype=torch.int64) * n
    gidx = idx.to(torch.int64) + off.reshape((b,) + (1,) * (idx.dim() - 1))
    return flat[gidx.reshape(-1)].reshape(tuple(idx.shape)
                                          + tuple(x.shape[2:]))
