"""The kernels' work counts: each by hand on small inputs, and the record
of one eager CPU frame of each path, whose launches every kernel file
counts."""

import numpy as np
import pytest
import torch

from benchmark import roofline, trace
from benchmark.harness import Program
from benchmark.tests import _tiny

K = roofline.load_kernels()


def _work(kernel, i, args, kw, out):
    return K[kernel].WRAPPERS[i][2](args, kw, out)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 67e9) == pytest.approx(1.0)
    assert roofline.bound_ms(3.35e9, 134e9) == pytest.approx(2.0)


def test_select_reads_and_writes_once():
    r, c = 64, 100
    args = (torch.zeros(r, c), torch.zeros(r, c, dtype=torch.int32),
            torch.zeros(r, 12), 6, 2, 20, 4, 5, 0.1)
    out = torch.zeros(r, c, dtype=torch.int32)
    assert _work("select", 0, args, {}, out) == (4 * r * c * 3 + 48 * r, 0)


def test_seg_scan_counts_one_add_per_element_and_channel():
    vals, heads = torch.zeros(5, 16, 300), torch.zeros(16, 300,
                                                       dtype=torch.bool)
    out = torch.zeros_like(vals)
    assert _work("seg_scan", 0, (vals, heads), {}, out) == (
        2 * 4 * 5 * 16 * 300 + 16 * 300, 5 * 16 * 300)


def test_merge_counts_used_rows_and_live_points():
    b, c, p, bk = 2, 8, 16, 32
    cnt = torch.tensor([[3, 20, 0, 0, 0, 0, 0, 0],
                        [1, 0, 0, 0, 0, 0, 0, 0]], dtype=torch.int32)
    args = (torch.zeros(b, 64, 3 * bk), torch.zeros(b, 64, 5 * bk,
                                                    dtype=torch.int32),
            torch.zeros(b, c, dtype=torch.int32), cnt,
            *[torch.zeros(b, c, p)] * 4, torch.zeros(b, c, p,
                                                     dtype=torch.int32),
            torch.zeros(b, 3, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32), 2.0, 0.4)
    row = 8 * bk * 4
    want = 3 * (2 * row + 4) + (3 + 16 + 1) * 5 * 4 + 4 * b * c * 4 \
        + b * 3 * 4 + 3 * 4
    assert _work("insert", 0, args, {}, None) == (want, 0)


def test_knn_table_entry_reads_each_distinct_bucket_once():
    pts = torch.zeros(1024, 3 * 48)
    q = torch.tensor([[0.1, 0.1, 0.1], [0.2, 0.3, 0.1]])   # one block
    out = (torch.zeros(2, 5), torch.zeros(2, 5, 3))
    n_bytes, flops = _work("knn", 0, (pts, q, 5, 2.0, 1.0), {}, out)
    from benchmark.reference.aloam.ops.gridmap import block_buckets
    hh, dup = block_buckets(q[:1], 1024, 2.0, 1.0)
    rows = hh[~dup].unique().numel()
    assert 1 <= rows <= 8 and flops == 0
    assert n_bytes == rows * 144 * 4 + 2 * 3 * 4 + 2 * 5 * 4 + 2 * 15 * 4


def test_knn_cache_entry_reads_live_rows():
    cand = torch.zeros(10, 24 * 32)
    row = torch.tensor([0, 0, 3, 5], dtype=torch.int32)
    q4 = torch.tensor([[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0],
                       [0, 0, 0, 1.0]])
    out = (torch.zeros(4, 5), torch.zeros(4, 5, 3))
    n_bytes, _ = _work("knn", 1, (cand, row, q4, 5), {}, out)
    assert n_bytes == 2 * 24 * 32 * 4 + 1 * 12 + 4 * 4 + 16 * 4 \
        + 20 * 4 + 60 * 4


@pytest.mark.parametrize("path,kernels", [
    ("fleet", {"select", "seg_scan", "odom_window", "lm", "assoc",
               "insert"}),
    ("single", {"select", "seg_scan", "odom_window", "lm", "knn",
                "insert"})])
def test_one_recorded_cpu_frame_counts_every_kernel_of_the_path(path,
                                                                kernels):
    from benchmark.run import render
    torch.set_num_threads(2)
    cell = _tiny.cell(path, frames=3)
    xyz, mask, _ = render(cell, 3, "cpu")
    prog = Program(cell, xyz, mask, "cpu")
    state = prog.init()
    for f in range(2):
        state, _ = prog.step(state, *prog.frame(0, f))
    work = trace.record_work(prog, state, *prog.frame(0, 2))
    assert set(work) == kernels
    assert all(n >= 1 and b > 0 for b, n in work.values())
    # the state the record started from is left alone
    again = trace.record_work(prog, state, *prog.frame(0, 2))
    assert {k: n for k, (_, n) in again.items()} == \
        {k: n for k, (_, n) in work.items()}
    assert np.isclose(sum(b for b, _ in again.values()),
                      sum(b for b, _ in work.values()))
