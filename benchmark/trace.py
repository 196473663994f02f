"""The traced run (``--trace 1``): the record its per-layer readers read.

* **Kernel work.** One eager frame of the same step (``pipeline.step_b`` or
  ``pipeline.step``) on a clone of the state the traced stretch starts
  from, with each of the port's kernel entry points wrapped to count the
  bytes and operations of every launch (``benchmark/kernels/*.py``).
* **The traced stretch.** ``trace_frames`` frames of the window's loop,
  continuing the window's schedule and state, under ``torch.profiler``
  (CPU and CUDA activity). Device busy time is the union of the device
  operations' intervals; an idle gap is labelled by the innermost host
  operation running at its middle.

Every per-layer metric is a file ``benchmark/metrics/<name>.py`` with
``read(record) -> float | None``; :func:`read_metrics` loads them by name.
"""

from __future__ import annotations

import importlib.util
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from benchmark import roofline

METRICS = Path(__file__).resolve().parent / "metrics"
SHORT_GAP_US = 20     # gaps shorter than this are not labelled one by one


def record_work(prog, state, xyz, mask) -> dict:
    """{kernel: [bound ms, launches]} of one eager frame of the program's
    step from a clone of ``state`` (the clone is stepped and dropped)."""
    import importlib
    kernels = roofline.load_kernels()
    work = defaultdict(lambda: [0.0, 0])
    saved, active = [], set()

    def recorder(kernel, key, fn, count):
        def call(*args, **kw):
            if key in active:       # a wrapper calling itself launches once
                return fn(*args, **kw)
            active.add(key)
            try:
                out = fn(*args, **kw)
            finally:
                active.discard(key)
            n_bytes, flops = count(args, kw, out)
            work[kernel][0] += roofline.bound_ms(n_bytes, flops)
            work[kernel][1] += 1
            return out
        return call

    clone = _cloned(state)
    try:
        for kernel, mod in kernels.items():
            for modname, attr, count in mod.WRAPPERS:
                target = importlib.import_module(modname)
                saved.append((target, attr, getattr(target, attr)))
                setattr(target, attr, recorder(kernel, (modname, attr),
                                               saved[-1][2], count))
        prog.eager(clone, xyz, mask, prog.cfg)
    finally:
        for target, attr, fn in reversed(saved):
            setattr(target, attr, fn)
    return dict(work)


def _cloned(state):
    if torch.is_tensor(state):
        return state.clone()
    if isinstance(state, tuple):
        return type(state)(*map(_cloned, state))
    return state


def profiled(drive_stretch):
    """Run ``drive_stretch()`` (returns a ``harness.Window``) under
    torch.profiler: (the window, the profiler's events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        win = drive_stretch()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return win, prof.events()


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, kernels: dict) -> dict:
    """Device busy (the union of device intervals), device time by
    operation and by kernel file, and idle gaps by host operation, all in
    seconds, from profiler events."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    by_op, by_kernel = defaultdict(float), defaultdict(float)
    for ev in events:
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == cuda:
            dev.append((s, e))
            by_op[ev.name] += (e - s) * 1e-6
            k = roofline.kernel_of(ev.name, kernels)
            if k is not None:
                by_kernel[k] += (e - s) * 1e-6
        elif e > s:
            host.append((s, e, ev.name))
    merged = _union(dev)
    busy = sum(e - s for s, e in merged) * 1e-6
    host.sort()
    by_gap, j, stack = defaultdict(float), 0, []
    for (_, g0), (g1, _) in zip(merged, merged[1:]):
        if g1 - g0 < SHORT_GAP_US:
            by_gap[f"gaps under {SHORT_GAP_US} us"] += (g1 - g0) * 1e-6
            continue
        mid = 0.5 * (g0 + g1)
        while j < len(host) and host[j][0] <= mid:
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:   # host operations nest
            stack.pop()
        name = stack[-1][2] if stack else "host (no operation)"
        by_gap[name] += (g1 - g0) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "device_ops": [[n[:160], v] for n, v in top],
            "idle_gaps": [[n[:160], v] for n, v in idle],
            "kernel_s": dict(by_kernel)}


def load_metric(name: str, base: Path = METRICS):
    """The reader of per-layer metric ``name``: ``<base>/<name>.py``."""
    path = base / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(names: list, record: dict, base: Path = METRICS) -> dict:
    """{name: value} of each per-layer metric whose reader found something
    to read."""
    out = {}
    for name in names:
        value = load_metric(name, base).read(record)
        if value is not None:
            out[name] = value
    return out


# --- the readers' arithmetic, shared by the files under metrics/ ----------

def issue_ms(record: dict, path: str):
    """Mean host ms from a call of the step to its return, over the
    window's frames."""
    if record["path"] != path or not len(record["issue_ms"]):
        return None
    return float(np.mean(record["issue_ms"]))


def busy_ms(record: dict, path: str):
    """Device busy ms a frame (the union of device intervals) in the
    traced stretch."""
    if record["path"] != path or record["busy_s"] <= 0:
        return None
    return record["busy_s"] * 1e3 / record["frames_traced"]


def idle_pct(record: dict, path: str):
    """100 x (1 - busy / wall) a frame: the traced stretch's device busy
    time a frame against the untraced window's wall time a frame (under
    the profiler a graph launch holds the host for up to ms, which would
    read as idle time that the measured window does not have)."""
    if record["path"] != path or record["busy_s"] <= 0:
        return None
    busy = record["busy_s"] / record["frames_traced"]
    return 100.0 * (1.0 - busy / record["frame_s"])


def kernel_roofline_pct(record: dict, path: str):
    """100 x the least time of the port's kernels' launches over their
    device time in the traced stretch: the launches of one recorded frame,
    times the frames traced, against the profiler's device time of the
    same kernels."""
    if record["path"] != path:
        return None
    kernels = [k for k, (_, n) in record["kernel_work"].items()
               if n and record["kernel_s"].get(k, 0) > 0]
    dev_ms = sum(record["kernel_s"][k] for k in kernels) * 1e3
    if dev_ms <= 0:
        return None
    bound = sum(record["kernel_work"][k][0] for k in kernels) \
        * record["frames_traced"]
    return 100.0 * bound / dev_ms


def kernel_shares(record: dict) -> dict:
    """Each kernel's share of its roofline in the traced stretch, %."""
    out = {}
    for k, (bound, n) in record["kernel_work"].items():
        dev_s = record["kernel_s"].get(k, 0)
        if n and dev_s > 0:
            out[k] = 100.0 * bound * record["frames_traced"] / (dev_s * 1e3)
    return out
