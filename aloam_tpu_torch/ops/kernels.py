"""The port's CUDA kernels, each described once: which ops module holds
its wrapper and plain PyTorch twin, the wrapper's launch counter, how many
leading arguments it updates in place, how it is held to its twin, its
``csrc/`` source and the ``pallas_call`` it replaces; and the kernels
each path launches. ``chip_smoke.py`` and the bench's kernel checks
(``aloam_tpu_torch.bench``) read it.

The table holds the names of wrapper, twin and counter, looked up on
their module at each use: tools swap module attributes (the plain run,
input recorders, ``benchmark/trace.record_work``), and a function kept
here would bypass them. Only the check, a function of this module that
nothing swaps, is held itself.

How far each kernel may stand from its plain version (:func:`agree`):

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

A new kernel is its ops module, its ``csrc/*.cu``, one line of
``_build.SIGNATURES`` and one entry here.
"""

from __future__ import annotations

import importlib
from typing import Callable, NamedTuple

import torch


def absdiff(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| with equal entries (inf included) and NaN in both at
    0."""
    same = (got == want) | (got.isnan() & want.isnan())
    return torch.where(same, 0.0, (got.double() - want.double()).abs())


def _bits(got, want, kind, inputs):
    pairs = [(got, want)] if torch.is_tensor(got) else zip(got, want)
    same = all(g.shape == w.shape and g.dtype == w.dtype
               and torch.equal(g.contiguous().view(torch.uint8),
                               w.contiguous().view(torch.uint8))
               for g, w in pairs)
    return same, 0.0 if same else float("inf")


def _labels(got, want, kind, inputs):
    return torch.equal(got, want), absdiff(got, want).max().item()


def _seg_scan(got, want, kind, inputs):
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


def _exact(got, want, kind, inputs):
    err = max(absdiff(g, w).max().item() for g, w in zip(got, want))
    return all(torch.equal(g, w) for g, w in zip(got, want)), err


def _assoc(got, want, kind, inputs):
    okc = 6 if kind == "corner" else 4
    live = (got[:, okc] > 0) & (want[:, okc] > 0)
    flips = (got[:, okc] != want[:, okc]).sum().item()
    err = absdiff(got[live], want[live]).max().item() if live.any() else 0.0
    return (flips <= max(1, want.shape[0] // 10000) and err <= 1e-4
            and live.sum().item() > 0), err


def _lm(got, want, kind, inputs):
    d = absdiff(got, want)
    rel = torch.where(d[:, 7:9] == 0, 0.0,
                      d[:, 7:9] / want[:, 7:9].abs().clamp_min(1e-12))
    ok = bool(d[:, 0:4].max() <= 2e-5 and d[:, 4:7].max() <= 2e-4
              and rel[:, 0].max() <= 2e-4 and rel[:, 1].max() <= 2e-3
              and torch.equal(got[:, 9:], want[:, 9:]))
    return ok, d[:, :7].max().item()


class Kernel(NamedTuple):
    module: str            # aloam_tpu_torch.ops.<module>
    wrapper: str           # launches the kernel for CUDA tensors
    plain: str             # the plain PyTorch twin
    source: str            # the CUDA source
    replaces: str | None   # the JAX package's pallas_call, or None
    check: Callable        # (got, want, kind, inputs) -> (ok, max abs err)
    counter: str = "launches"
    in_place: int = 0      # leading arguments updated in place


_CSRC, _PALLAS = "aloam_tpu_torch/csrc/", "aloam_tpu/ops/pallas_"
KERNELS = {
    "select_rings": Kernel("select", "select_rings", "select_rings_plain",
                           _CSRC + "select.cu", _PALLAS + "select.py:141",
                           _labels),
    "segmented_prefix_sums": Kernel(
        "voxel", "segmented_prefix_sums", "segmented_prefix_sums_plain",
        _CSRC + "seg_scan.cu", _PALLAS + "voxel.py:98", _seg_scan),
    "window_mins": Kernel("odom", "window_mins", "window_mins_plain",
                          _CSRC + "odom_window.cu", _PALLAS + "odom.py:199",
                          _exact),
    "lm_fused": Kernel("lm", "lm_fused", "lm_fused_plain", _CSRC + "lm.cu",
                       _PALLAS + "lm.py:326", _lm),
    "assoc_cell": Kernel("assoc", "assoc_cell", "assoc_cell_plain",
                         _CSRC + "assoc.cu", _PALLAS + "assoc.py:356",
                         _assoc),
    "merge_tiles": Kernel("insert", "merge_rows", "merge_rows_plain",
                          _CSRC + "insert.cu", _PALLAS + "insert.py:167",
                          _exact, in_place=2),
    # the table entry (gridmap.knn, the single-stream search) and the cache
    # entry (the association API) of one kernel
    "knn_select": Kernel("knn", "knn_grid", "knn_grid_plain",
                         _CSRC + "knn.cu", _PALLAS + "knn.py:108", _exact,
                         counter="grid_launches"),
    "knn_select_rows": Kernel("knn", "knn_select", "knn_select_plain",
                              _CSRC + "knn.cu", _PALLAS + "knn.py:108",
                              _exact),
    # lm_fused's launches with the s channel (the distortion path's
    # odometry solves)
    "lm_fused_s": Kernel("lm", "lm_fused", "lm_fused_plain", _CSRC + "lm.cu",
                         _PALLAS + "lm.py:326", _lm, counter="s_launches"),
    # the row gather of every caller (utils/batch.py:bgather in the JAX
    # package, which leaves it to XLA)
    "bgather": Kernel("gather", "bgather", "bgather_plain",
                      _CSRC + "gather.cu", None, _bits),
    # the map window's evict and census (gridmap.evict_and_count; the JAX
    # package leaves it to XLA)
    "evict_and_count": Kernel("evict", "evict_and_count",
                              "evict_and_count_plain", _CSRC + "evict.cu",
                              None, _bits, in_place=2),
}

# the kernels each path launches: the front half (pipeline.front_step_b),
# the batched step (step_b) and the single-stream step (step); the
# distortion path launches lm_fused_s besides
FRONT = ("select_rings", "segmented_prefix_sums", "window_mins", "lm_fused",
         "bgather")
STEP_B = FRONT + ("assoc_cell", "merge_tiles", "evict_and_count")
STEP = FRONT + ("merge_tiles", "knn_select", "evict_and_count")


def module(name: str):
    return importlib.import_module(
        f"aloam_tpu_torch.ops.{KERNELS[name].module}")


def wrapper(name: str) -> Callable:
    return getattr(module(name), KERNELS[name].wrapper)


def plain(name: str) -> Callable:
    return getattr(module(name), KERNELS[name].plain)


def launches(name: str) -> int:
    """The kernel's launches since its counter's last reset."""
    return getattr(module(name), KERNELS[name].counter)


def counts() -> dict:
    """Every kernel's launches since its counter's last reset, as its
    wrapper counts them (a graph's replays relaunch what its capture
    did)."""
    return {name: launches(name) for name in KERNELS}


def reset(names=tuple(KERNELS)) -> None:
    for name in names:
        setattr(module(name), KERNELS[name].counter, 0)


def fresh(name: str, args: tuple) -> tuple:
    """``args`` with clones of those the kernel updates in place."""
    k = KERNELS[name].in_place
    return tuple(a.clone() for a in args[:k]) + tuple(args[k:])


def run(name: str, fn: Callable, args: tuple, kw: dict):
    """``fn`` (the kernel's wrapper or twin) on the inputs. A kernel that
    updates its first k arguments in place gets clones of them, which
    come back ahead of its outputs."""
    k = KERNELS[name].in_place
    args = fresh(name, args)
    out = fn(*args, **kw)
    return args[:k] + tuple(out) if k else out


def agree(name: str, got, want, kind: str | None = None, inputs=None):
    """(within the kernel's tolerance, max_abs_err) of a kernel's output
    against its plain version's; ``kind`` is assoc_cell's "surf" or
    "corner"; ``inputs`` the kernel's arguments, which the seg scan's
    bound reads (its values and heads). Tuples of outputs are compared
    element by element."""
    return KERNELS[name].check(got, want, kind, inputs)


def record_inputs(names, drive) -> dict:
    """Run ``drive()`` with each named kernel's wrapper recording a copy of
    its inputs, one record per name and input signature (tensor shapes,
    other arguments but floats by value). Returns {(name, signature):
    (args, kwargs)}."""
    recorded, saved = {}, []

    def recorder(name, fn):
        def call(*args, **kw):
            key = (name, tuple(tuple(a.shape) if torch.is_tensor(a) else a
                               for a in args if not isinstance(a, float)))
            if key not in recorded:
                recorded[key] = (tuple(a.clone() if torch.is_tensor(a) else a
                                       for a in args), dict(kw))
            return fn(*args, **kw)
        return call

    try:
        for name in names:
            mod, attr = module(name), KERNELS[name].wrapper
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, recorder(name, saved[-1][2]))
        drive()
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
    return recorded
