"""How far each CUDA kernel may stand from its plain PyTorch version.

One definition, read by ``chip_smoke.py`` and by the bench's kernel check
(``aloam_tpu_torch.bench.verify_kernels``) on the card:

  select_rings           labels exact;
  segmented_prefix_sums  |k - p| <= 1e-5 + 1e-6 S, S the segmented prefix
                         sum of |x| (f32 summation order: the rounding of
                         a reordered sum grows with the magnitudes summed,
                         not with the sum, which may cancel; S reaches
                         ~1e3 at HDL-64 coordinates, where one f32 ulp is
                         ~6e-5), the last (count) channel exact;
  window_mins            exact: both compute d2 with the same rounded
                         operations in the same order;
  lm_fused               q atol 2e-5, t atol 2e-4, cost0 rtol 2e-4, cost
                         rtol 2e-3, counts exact (reduction order and
                         unpivoted elimination vs LU); a NaN in both agrees;
  assoc_cell             ok flags differ on at most 1 query in 10^4 and
                         columns of queries live in both within 1e-4: d2,
                         select and fit are the same rounded operations in
                         the same order (bit-equal where measured), a
                         margin for a near-tie;
  merge_tiles            both tables bit-equal as a whole and the counts
                         exact (no arithmetic but the midpoint and the
                         priority formula, identical);
  knn_select(_rows)      d2 and neighbours exact (the same rounded
                         operations in the same order, lowest-index ties);
  bgather                every output bit equal (a copy: NaN payloads and
                         -0.0 included);
  evict_and_count        both tables bit-equal after the in-place clear and
                         the counts exact (a copy of sentinels and integer
                         counts: no arithmetic on floats).
"""

from __future__ import annotations

import torch

EXACT = ("window_mins", "merge_tiles", "knn_select", "knn_select_rows")


def absdiff(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| with equal entries (inf included) and NaN in both at
    0."""
    same = (got == want) | (got.isnan() & want.isnan())
    return torch.where(same, 0.0, (got.double() - want.double()).abs())


def agree(name: str, got, want, kind: str | None = None, inputs=None):
    """(within the kernel's tolerance, max_abs_err) of a kernel's output
    against its plain version's; ``kind`` is assoc_cell's "surf" or
    "corner"; ``inputs`` the kernel's arguments, which the seg scan's
    bound reads (its values and heads). Tuples of outputs are compared
    element by element."""
    if name in ("bgather", "evict_and_count"):
        pairs = [(got, want)] if torch.is_tensor(got) else zip(got, want)
        same = all(g.shape == w.shape and g.dtype == w.dtype
                   and torch.equal(g.contiguous().view(torch.uint8),
                                   w.contiguous().view(torch.uint8))
                   for g, w in pairs)
        return same, 0.0 if same else float("inf")
    if name == "select_rings":
        return torch.equal(got, want), absdiff(got, want).max().item()
    if name == "segmented_prefix_sums":
        from aloam_tpu_torch.ops.voxel import segmented_prefix_sums_plain
        if inputs is None:
            raise ValueError("segmented_prefix_sums: the bound needs the "
                             "inputs (vals, heads)")
        vals, heads = inputs[:2]
        mags = segmented_prefix_sums_plain(vals.abs(), heads)
        d = absdiff(got, want)
        ok = bool((d <= 1e-5 + 1e-6 * mags).all()) \
            and torch.equal(got[-1], want[-1])
        return ok, d.max().item()
    if name in EXACT:
        err = max(absdiff(g, w).max().item() for g, w in zip(got, want))
        return all(torch.equal(g, w) for g, w in zip(got, want)), err
    if name == "assoc_cell":
        okc = 6 if kind == "corner" else 4
        live = (got[:, okc] > 0) & (want[:, okc] > 0)
        flips = (got[:, okc] != want[:, okc]).sum().item()
        err = absdiff(got[live], want[live]).max().item() if live.any() \
            else 0.0
        return (flips <= max(1, want.shape[0] // 10000) and err <= 1e-4
                and live.sum().item() > 0), err
    if name not in ("lm_fused", "lm_fused_s"):
        raise KeyError(f"no tolerance for {name!r}")
    d = absdiff(got, want)
    rel = torch.where(d[:, 7:9] == 0, 0.0,
                      d[:, 7:9] / want[:, 7:9].abs().clamp_min(1e-12))
    ok = bool(d[:, 0:4].max() <= 2e-5 and d[:, 4:7].max() <= 2e-4
              and rel[:, 0].max() <= 2e-4 and rel[:, 1].max() <= 2e-3
              and torch.equal(got[:, 9:], want[:, 9:]))
    return ok, d[:, :7].max().item()
