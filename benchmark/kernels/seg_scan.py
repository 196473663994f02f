"""``csrc/seg_scan.cu`` (``ops/voxel.segmented_prefix_sums``): segmented
prefix sums of K channels over rows. The channels and heads read once and
the sums written once; one add per element and channel, which no scan can
skip."""

from benchmark.roofline import nbytes

PROFILER = ("seg_tile_kernel", "seg_carry_kernel")


def work(args, kw, out):
    return (nbytes(list(args)) + nbytes(list(kw.values())) + nbytes(out),
            args[0].numel())


WRAPPERS = (("aloam_tpu_torch.ops.voxel", "segmented_prefix_sums", work),)
