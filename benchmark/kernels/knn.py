"""``csrc/knn.cu``: the 5-NN select, two entries. The table entry
(``ops/knn.knn_grid``, the single-stream map search) reads each distinct
bucket row of its queries' 2x2x2 blocks once (a bucket two cells of a
block share is read once), the queries once, and writes the distances and
neighbours once. The cache entry (``ops/knn.knn_select``) reads the
distinct rows of its live queries, a gated query's first candidate, the
row ids and queries, and writes its outputs. Bytes only: the candidates
compared belong to one algorithm."""

import torch

from benchmark.roofline import nbytes

PROFILER = ("knn_kernel",)


def grid_work(args, kw, out):
    from benchmark.reference.aloam.ops.gridmap import block_buckets
    pts, q, cell, radius = args[0], args[1], args[3], args[4]
    hh, dup = block_buckets(q, pts.shape[0], cell, radius)
    rows = hh[~dup].unique().numel()
    return rows * pts.shape[1] * pts.element_size() + nbytes([q]) \
        + nbytes(out), 0


def rows_work(args, kw, out):
    cand, row, q4 = args[0], args[1], args[2]
    live = q4[:, 3] <= 0
    rows = row[live].unique()
    gated = row[~live].unique()
    n_gated = int((~torch.isin(gated, rows)).sum())
    return (rows.numel() * cand.shape[1] * cand.element_size()
            + n_gated * 3 * cand.element_size() + nbytes([row, q4])
            + nbytes(out)), 0


WRAPPERS = (("aloam_tpu_torch.ops.knn", "knn_grid", grid_work),
            ("aloam_tpu_torch.ops.knn", "knn_select", rows_work))
