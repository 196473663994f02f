"""The card's published peaks and the least time a launch could take.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor
cores (the port's kernels use none). Each kernel's work is counted by its
file under ``benchmark/kernels/``: every input read once and every output
written once at the launch's live counts, and only the arithmetic that no
correct implementation can skip.
"""

from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
KERNELS = Path(__file__).resolve().parent / "kernels"


def nbytes(x) -> int:
    """Bytes of every tensor in ``x`` (nested tuples and lists)."""
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(nbytes(y) for y in x)
    return 0


def bound_ms(n_bytes: int, flops: int) -> float:
    """The least time of a launch: the larger of its bytes over the peak
    bandwidth and its operations over the peak rate, in ms."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3


def load_kernels(base: Path = KERNELS) -> dict:
    """Every kernel file: {name: module}. A module has ``PROFILER`` (the
    names its device kernels carry in a profiler trace) and ``WRAPPERS``
    ((module, attribute, work) of each of the port's entry points that
    launch it; work(args, kw, out) -> (bytes, flops))."""
    out = {}
    for path in sorted(base.glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"benchmark.kernels.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def kernel_of(device_name: str, kernels: dict):
    """The kernel file whose profiler names occur in a device operation's
    name, or None."""
    for name, mod in kernels.items():
        if any(p in device_name for p in mod.PROFILER):
            return name
    return None
