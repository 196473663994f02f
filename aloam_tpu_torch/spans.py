"""Tracing spans of the port: where a step's time goes, on the device and
on the host. Off by default; :func:`enable` / :func:`disable` or the
:func:`tracing` block turn it on, nothing else does.

* **Device spans** (``device=True``). ``with stage(name):`` in the step's
  body launches a stamp (``ops/stamp.py``: one thread writes the device's
  ``%globaltimer`` into an int64 slot) on the current stream at the
  stage's start and at its end. Stamps are written into the buffer of the
  open :func:`frame`, which the frame allocates at its start; a stage
  outside a frame records nothing. Under a CUDA graph capture each stamp
  is a kernel node of the graph and the buffer lives in the graph's pool:
  ``graph.StepGraph`` captures a second graph with the stamps (its graph
  key holds the device flag) and, after each replay of it, clones the
  buffers out of the pool (:func:`replayed`), as it clones the outputs.
  The host keeps each frame's **span table**: the spans in the order they
  opened, each with its name, its parent (the innermost stage open around
  it) and its two stamp slots. Slots are taken in launch order, so under
  torch.profiler the i-th ``aloam_stamp_kernel`` operation of a frame is
  slot i. Nothing synchronises until :func:`drain`.
* **Host spans** (``host=True``). ``with host(name):`` takes the host's
  ``perf_counter_ns`` at entry and exit and, while a profiler runs, opens
  a ``torch.profiler.record_function`` range of the same name, so that the
  span sits on the clock of the device operations.
  ``graph.StepGraph`` records ``step`` around ``step.copy_in``,
  ``step.launch`` and ``step.clone_out``.
* **The log** keeps the last ``MAX_FRAMES`` frames (a frame: one call's
  host spans, with its first frame, and each frame's stamps) and counts
  the frames it dropped (:func:`dropped`). :func:`drain` returns its
  records and empties it; the stamps are read there, and put on the host's
  ``perf_counter`` clock by an offset measured when tracing is enabled (a
  stamp launched between two host readings around a synchronise; the half
  round trip is the offset's error bound, ``err_ns`` in each record;
  :func:`offset`). A CPU buffer holds host times already (offset 0,
  error 0).

The spans and what reads them: ``register``, ``features``, ``odometry``,
``mapping`` and ``outputs`` tile a frame (``outputs`` twice in a compiled
step: the step's output assembly, then the body's per-frame copies and
the state's copy); ``features.select`` (the selection walk and its
inputs), ``features.rings`` (the per-ring clouds); ``odom.assoc`` / ``odom.lm`` (each round),
``odom.handoff``; ``map.evict``, ``map.downsample``, ``map.insert``;
``map.cache`` and ``map.assoc`` (each round) on the batched mapping,
``map.knn`` and ``map.fit`` (each round, corner then surf) on the
single-stream one; ``map.lm`` (each round). :func:`frame_ms` sums each
per frame; ``python -m aloam_tpu_torch.cli --trace`` writes them into
``metrics.jsonl``.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple

import torch

from aloam_tpu_torch.ops import stamp as stamp_op

SLOTS = 256              # stamps a frame can hold (a frame uses 38-48)
MAX_FRAMES = 4096        # frames the log keeps

host_on = False          # host spans recorded
device_on = False        # device stages stamped


class Frame:
    """One frame's device spans: its stamp buffer, the span table (name,
    parent, start slot, end slot, in the order the spans opened) and its
    index in the call. Slots are taken in launch order: the i-th stamp a
    frame launches writes slot i."""

    def __init__(self, index: int, buf: torch.Tensor, table=None,
                 n: int = 0):
        self.index, self.buf = index, buf
        self.table = [] if table is None else table
        self.n = n                  # stamps launched
        self.open: list = []        # rows of the table not yet ended

    def _stamp(self) -> int:
        if self.n == self.buf.numel():
            raise RuntimeError(f"spans: more than {self.n} stamps in a "
                               f"frame")
        stamp_op.stamp(self.buf, self.n)
        self.n += 1
        return self.n - 1

    def begin(self, name: str) -> list:
        parent = self.open[-1][0] if self.open else None
        row = [name, parent, self._stamp(), None]
        self.table.append(row)
        self.open.append(row)
        return row

    def end(self, row: list) -> None:
        self.open.pop()
        row[3] = self._stamp()


class _Entry(NamedTuple):
    call: int
    frame: int
    host: list               # (name, parent, start ns, end ns)
    stamps: torch.Tensor | None
    table: list | None


class _Call:
    def __init__(self, ident: int):
        self.ident = ident
        self.host: list = []
        self.frames: list = []


_log: collections.deque = collections.deque(maxlen=MAX_FRAMES)
_dropped = 0
_calls = 0
_call: _Call | None = None     # the StepGraph call open
_frame: Frame | None = None    # the frame open
_sink: list | None = None      # frames finished under a capture
_host_open: list = []          # names of the host spans open
_offsets: dict = {}            # device -> (offset ns, error ns)


def enable(host: bool = True, device: bool = True) -> None:
    """Turn tracing on: host spans, device stages, or both. With device
    stages on a machine with a card, measures the current card's clock
    offset anew (which also loads the stamp kernel before any capture).
    Sets the log's bound to ``MAX_FRAMES`` and its count of dropped frames
    to 0."""
    global host_on, device_on, _log, _dropped
    if device and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
        _offsets[dev] = _measure(dev)
    host_on, device_on = bool(host), bool(device)
    _log = collections.deque(_log, maxlen=MAX_FRAMES)
    _dropped = 0


def disable() -> None:
    """Turn tracing off; the log keeps what it holds until drained."""
    global host_on, device_on
    host_on = device_on = False


@contextlib.contextmanager
def tracing(host: bool = True, device: bool = True):
    """A block with tracing on (:func:`enable`), off after it."""
    enable(host, device)
    try:
        yield
    finally:
        disable()


def dropped() -> int:
    """Frames the log dropped since tracing was enabled."""
    return _dropped


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Stage:
    __slots__ = ("name", "row", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # a range around the stamps for a profiler running outside a
        # capture: its device-side mirror names the stage's operations
        self.rf = torch.profiler.record_function(self.name) \
            if _sink is None and torch.autograd._profiler_enabled() \
            else _NULL
        self.rf.__enter__()
        self.row = _frame.begin(self.name)

    def __exit__(self, *exc):
        _frame.end(self.row)
        self.rf.__exit__(*exc)
        return False


def stage(name: str):
    """A device span around the block: a stamp before it and after it,
    recorded in the open frame (nothing outside a frame)."""
    return _NULL if _frame is None else _Stage(name)


class _FrameBlock:
    __slots__ = ("device", "index")

    def __init__(self, device, index: int):
        self.device, self.index = torch.device(device), index

    def __enter__(self) -> Frame:
        global _frame
        if _frame is not None:
            raise RuntimeError("spans: frames do not nest")
        _frame = Frame(self.index, torch.empty(SLOTS, dtype=torch.int64,
                                               device=self.device))
        return _frame

    def __exit__(self, typ, *exc):
        global _frame
        fr, _frame = _frame, None
        if typ is None:
            if fr.open:
                raise RuntimeError(f"spans: {fr.open[-1][0]} never ended")
            if _sink is not None:
                _sink.append(fr)
            else:
                _finished(fr)
        return False


def frame(device, index: int = 0):
    """The block of one frame's device stages, on ``device``: its stamp
    buffer is allocated at the start (in the graph's pool under a capture).
    ``index``: the frame's place in the open StepGraph call, or its number
    outside one. Nothing when device stages are off."""
    return _FrameBlock(device, index) if device_on else _NULL


@contextlib.contextmanager
def capturing():
    """The frames that finish inside the block are the graph's: they go
    into the list it yields, not into the log."""
    global _sink
    saved, _sink = _sink, []
    try:
        yield _sink
    finally:
        _sink = saved


def replayed(frames) -> None:
    """After a replay of a graph with stamps: each frame's used slots
    cloned out of the pool (queued, not waited for) into the log."""
    for fr in frames:
        _finished(Frame(fr.index, fr.buf[:fr.n].clone(), fr.table, fr.n))


def _finished(fr: Frame) -> None:
    if _call is not None:
        _call.frames.append(fr)
    else:
        _push(_Entry(_next_call(), fr.index, [], fr.buf, fr.table))


def _next_call() -> int:
    global _calls
    _calls += 1
    return _calls


def _push(entry: _Entry) -> None:
    global _dropped
    if len(_log) == _log.maxlen:
        _dropped += 1
    _log.append(entry)


@contextlib.contextmanager
def call(frame0: int):
    """One call of a compiled step whose first frame is ``frame0``: the
    host spans and the frames recorded inside it share a call id and go
    into the log at its end, the host spans with its first frame."""
    global _call
    if _call is not None:
        raise RuntimeError("spans: calls do not nest")
    c = _call = _Call(_next_call())
    try:
        yield
    finally:
        _call = None
    frames = c.frames or [None]
    for i, fr in enumerate(frames):
        _push(_Entry(c.ident, frame0 + (fr.index if fr else 0),
                     c.host if i == 0 else [],
                     fr.buf if fr else None, fr.table if fr else None))


class _HostSpan:
    __slots__ = ("name", "parent", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _host_open[-1] if _host_open else None
        _host_open.append(self.name)
        # a range only for a profiler running: without one it costs ~10 us
        self.rf = torch.profiler.record_function(self.name) \
            if torch.autograd._profiler_enabled() else _NULL
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _host_open.pop()
        span = (self.name, self.parent, self.t0, t1)
        if _call is not None:
            _call.host.append(span)
        else:
            _push(_Entry(_next_call(), 0, [span], None, None))
        return False


def host(name: str):
    """A host span around the block (and, while a profiler runs, a
    record_function range of the same name); nothing when host spans are
    off."""
    return _HostSpan(name) if host_on else _NULL


def offset(device) -> tuple:
    """(ns to add to the device's timer to read the host's perf_counter,
    the error bound): as measured at the last :func:`enable`, or now if it
    was not; (0, 0) on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0, 0
    if device not in _offsets:
        _offsets[device] = _measure(device)
    return _offsets[device]


def _measure(device: torch.device) -> tuple:
    """:func:`offset` from the least round trip of five stamps, each
    launched between two host readings around a synchronise."""
    buf = torch.zeros(1, dtype=torch.int64, device=device)
    best = None
    for _ in range(5):
        torch.cuda.synchronize(device)
        h0 = time.perf_counter_ns()
        stamp_op.stamp(buf, 0)
        torch.cuda.synchronize(device)
        h1 = time.perf_counter_ns()
        trip = h1 - h0
        if best is None or trip < best[0]:
            best = (trip, (h0 + h1) // 2 - int(buf.item()))
    return best[1], best[0] // 2


def drain() -> list:
    """The records the log holds, oldest first, and an empty log. A record:
    ``call``, ``frame``, ``name``, ``parent``, ``start_ns``, ``end_ns``
    (the host's perf_counter clock), ``clock`` (``host`` or ``device``),
    ``err_ns`` (the clock offset's bound) and, on the device, ``slots``
    (its two stamps' places in the frame). Waits for the stamps."""
    entries = list(_log)
    _log.clear()
    out = []
    for e in entries:
        for name, parent, t0, t1 in e.host:
            out.append(dict(call=e.call, frame=e.frame, name=name,
                            parent=parent, start_ns=t0, end_ns=t1,
                            clock="host", err_ns=0))
        if e.stamps is None:
            continue
        off, err = offset(e.stamps.device)
        ts = e.stamps.tolist()
        for name, parent, s0, s1 in e.table:
            out.append(dict(call=e.call, frame=e.frame, name=name,
                            parent=parent, start_ns=ts[s0] + off,
                            end_ns=ts[s1] + off, clock="device",
                            err_ns=err, slots=(s0, s1)))
    return out


def frame_ms(records) -> list:
    """Per (call, frame), in order: {span name: ms, summed over the frame's
    spans of that name; ``graph``: device ms from the frame's first stamp
    to its last}. Host spans go with their call's first frame."""
    out, first_last = {}, {}
    for r in records:
        key = (r["call"], r["frame"])
        ms = out.setdefault(key, {})
        ms[r["name"]] = ms.get(r["name"], 0.0) \
            + (r["end_ns"] - r["start_ns"]) * 1e-6
        if r["clock"] == "device":
            lo, hi = first_last.get(key, (r["start_ns"], r["end_ns"]))
            first_last[key] = (min(lo, r["start_ns"]), max(hi, r["end_ns"]))
    for key, (lo, hi) in first_last.items():
        out[key]["graph"] = (hi - lo) * 1e-6
    return list(out.values())
