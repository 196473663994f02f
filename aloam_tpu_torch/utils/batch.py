"""Batched row helpers (port of ``aloam_tpu/utils/batch.py``): gathers and
compactions over a leading stream axis B, each one flat operation over
the B·N rows with per-stream offsets (``boffsets``). The row gather,
``bgather``, is ``ops/gather.py``'s."""

from __future__ import annotations

import torch

from aloam_tpu_torch.utils.tree import map_tensors


def boffsets(b: int, n: int, idx_ndim: int, device=None) -> torch.Tensor:
    """Per-stream row offsets (0, n, 2n, ...) int32, shaped to broadcast
    against a (B, ...) index of ``idx_ndim`` dims."""
    return (torch.arange(b, dtype=torch.int32, device=device) * n).reshape(
        (b,) + (1,) * (idx_ndim - 1))


def _scatter_rows(values: torch.Tensor, dest: torch.Tensor, rows: int):
    """values (B, N, K) scattered to flat rows ``dest`` (B, N) of a (rows,
    K) buffer; a dest of ``rows`` lands in a spare row that is cut off."""
    k = values.shape[-1]
    out = values.new_zeros((rows + 1, k))
    out.index_copy_(0, dest.reshape(-1), values.reshape(-1, k))
    return out[:rows]


def bcompact2(values: torch.Tensor, mask_a: torch.Tensor, cap_a: int,
              mask_b: torch.Tensor, cap_b: int):
    """Two compactions of the same rows under disjoint masks as one
    scatter: values (B, N, K). Returns ((out_a (B, cap_a, K), mask_a'
    (B, cap_a), dropped_a), (out_b, mask_b', dropped_b)), each dropped
    summed over the streams."""
    b, _, k = values.shape
    pos_a = mask_a.to(torch.int64).cumsum(1) - 1
    pos_b = mask_b.to(torch.int64).cumsum(1) - 1
    cap = cap_a + cap_b
    off = boffsets(b, cap, 2, values.device)
    dest = torch.where(mask_a & (pos_a < cap_a), pos_a + off,
                       torch.where(mask_b & (pos_b < cap_b),
                                   cap_a + pos_b + off, b * cap))
    out = _scatter_rows(values, dest, b * cap).reshape(b, cap, k)
    tot_a, tot_b = pos_a[:, -1] + 1, pos_b[:, -1] + 1
    kept_a, kept_b = tot_a.clamp_max(cap_a), tot_b.clamp_max(cap_b)
    slots_a = torch.arange(cap_a, device=values.device)
    slots_b = torch.arange(cap_b, device=values.device)
    return ((out[:, :cap_a], slots_a < kept_a[:, None],
             (tot_a - kept_a).sum()),
            (out[:, cap_a:], slots_b < kept_b[:, None],
             (tot_b - kept_b).sum()))


def bcompact(values: torch.Tensor, mask: torch.Tensor, cap: int):
    """``utils.masked.compact`` of each stream as one scatter: values
    (B, N, K), mask (B, N). Returns (out (B, cap, K), out_mask (B, cap),
    n_dropped summed over the streams)."""
    b, _, k = values.shape
    pos = mask.to(torch.int64).cumsum(1) - 1
    dest = torch.where(mask & (pos < cap),
                       pos + boffsets(b, cap, 2, values.device), b * cap)
    out = _scatter_rows(values, dest, b * cap).reshape(b, cap, k)
    total = pos[:, -1] + 1
    kept = total.clamp_max(cap)
    out_mask = torch.arange(cap, device=values.device) < kept[:, None]
    return out, out_mask, (total - kept).sum()


def add_stream_axis(tree):
    """Every tensor leaf with a leading stream axis of 1 (a view): the
    single-stream API's arguments for the batched functions."""
    return map_tensors(lambda t: t[None], tree)


def drop_stream_axis(tree):
    """Every tensor leaf without its leading stream axis of 1 (a view)."""
    return map_tensors(lambda t: t[0], tree)
