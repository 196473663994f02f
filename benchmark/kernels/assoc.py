"""``csrc/assoc.cu`` (``ops/assoc.assoc_cell``): the 5-NN of each
cell-sorted query over its cell's candidate row, and the line or plane fit.
Bytes only: the candidate rows, the tiles' first cells and the queries
read once, the fits written once (the pairs searched belong to one
algorithm)."""

from benchmark.roofline import nbytes

PROFILER = ("assoc_cell_kernel",)


def work(args, kw, out):
    return nbytes(list(args)) + nbytes(list(kw.values())) + nbytes(out), 0


WRAPPERS = (("aloam_tpu_torch.ops.assoc", "assoc_cell", work),)
