"""``csrc/odom_window.cu`` (``ops/odom.window_mins``): each query's nearest
point and ring-window neighbours. Bytes only: the queries and the planar
reference read once, the six outputs written once. The pairs compared
belong to one algorithm (a grid search compares fewer), so they are not
counted."""

from benchmark.roofline import nbytes

PROFILER = ("nn_partial_kernel", "window_kernel")


def work(args, kw, out):
    return nbytes(list(args)) + nbytes(list(kw.values())) + nbytes(out), 0


WRAPPERS = (("aloam_tpu_torch.ops.odom", "window_mins", work),)
