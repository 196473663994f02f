"""``csrc/select.cu`` (``ops/select.select_rings``): the greedy sharp /
flat picks of each ring row. Bytes only: curvature, the bad-gap prefix
counts and the region bounds read once, the labels written once; the walk
does far fewer operations a byte than the card's balance."""

from benchmark.roofline import nbytes

PROFILER = ("select_kernel",)


def work(args, kw, out):
    return nbytes(list(args)) + nbytes(list(kw.values())) + nbytes(out), 0


WRAPPERS = (("aloam_tpu_torch.ops.select", "select_rings", work),)
