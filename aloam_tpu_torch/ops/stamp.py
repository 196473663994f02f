"""The time stamp of a device span (kernel module of ``spans.py``).

The CUDA kernel is ``csrc/stamp.cu``: one thread writes the device's
global nanosecond timer (``%globaltimer``) into one int64 slot of a
buffer, on the current stream, so it runs after the work queued before it
and, under a capture, is a kernel node of the graph. The plain version
beside it writes the host's ``time.perf_counter_ns()``: on the CPU the
work before it has finished when it runs.
"""

from __future__ import annotations

import time

import torch

from aloam_tpu_torch.ops import _build


def stamp(buf: torch.Tensor, slot: int) -> None:
    """Write the time in ns into ``buf[slot]``, an int64 buffer: on a CUDA
    buffer the device's timer when the stream reaches the stamp, on a CPU
    buffer the host's ``perf_counter_ns``."""
    if not 0 <= slot < buf.numel():
        raise ValueError(f"stamp: slot {slot} of a buffer of {buf.numel()}")
    if buf.device.type == "cpu":
        buf[slot] = time.perf_counter_ns()
        return
    _build.require_cuda("stamp", buf, dtypes=(torch.int64,))
    _build.launch("aloam_stamp", buf.device, buf.data_ptr(), slot)
