"""The port's hand-written kernels' share of their roofline on the fleet
path: the least time of their launches (benchmark/kernels/*.py) over their
device time under torch.profiler, summed over the kernels."""

from benchmark.trace import kernel_roofline_pct


def read(record):
    return kernel_roofline_pct(record, "fleet")
