"""Device busy ms a frame on the single path: the union of the device
operations' intervals under torch.profiler over the traced stretch, over
its frames."""

from benchmark.trace import busy_ms


def read(record):
    return busy_ms(record, "single")
