"""``csrc/lm.cu`` (``ops/lm.lm_fused``): the whole damped Gauss-Newton
solve of each stream. Bytes only: the edge and plane factors and the
pose read once, the result written once."""

from benchmark.roofline import nbytes

PROFILER = ("lm_kernel",)


def work(args, kw, out):
    return nbytes(list(args)) + nbytes(list(kw.values())) + nbytes(out), 0


WRAPPERS = (("aloam_tpu_torch.ops.lm", "lm_fused", work),)
