"""Captured CUDA graphs of the SLAM step: the port's counterpart of the
JAX package's ``jax.jit`` with a donated state (``pipeline.make_step_fn``,
``parallel.batched_step_jit``, the sharded ``parallel.batched_step_fn``)
and of its one-program ``lax.scan`` (``pipeline.run_sequence(scan=True)``);
:class:`FnGraph` is the counterpart of a ``jax.jit`` with no state and no
donation (``parallel.sharded_knn``).

A :class:`StepGraph` binds one step function (``pipeline.step`` or
``step_b`` with its config). For each set of shapes and device it keeps a
static state and static input stacks (a *slot*), and in a slot one
captured ``torch.cuda.CUDAGraph`` per pattern of the mapping gate over the
frames it steps. A call copies the frames into the static inputs, replays
the graph on the device's current stream, and clones the outputs out of
the graph's memory pool, so that the next replay cannot overwrite them
(JAX returns fresh arrays). Every kernel of the step launches inside the
graph: the wrappers put their launches on the current stream, which is the
capture stream while a graph is captured.

* **Donation.** With ``donate=True`` a slot's first state becomes its
  static state: the map tables are adopted as they are (the step updates
  them in place, at fixed addresses, as a graph needs), every other leaf
  is copied into a buffer of the slot's own. The state passed in is
  consumed, as JAX's donated state is. A call returns the static state,
  and that state passed back in steps with no copy; any other state (a
  resumed checkpoint, a fresh ``init_state``) is copied into the static
  buffers first. So a state that the function returned is valid until its
  next call. With ``donate=False`` every call copies the caller's state in
  and returns a copy of the static state: the caller's state stays usable.
* **The body** runs the step over the frames, copies each frame's outputs
  into (F, ...) stacks, then copies every leaf of the new state into its
  static leaf (:func:`copy_into`: a leaf that is the static leaf itself is
  skipped, one that aliases a static leaf is staged first).
* **Capture.** Before a capture, one eager frame of each gate branch runs
  on a clone of the static state, on a side stream: it builds the kernels,
  makes the cached constants, raises the kernels' shared-memory limits
  and warms the allocator, and leaves the real state alone. The capture
  itself runs nothing on the device. A capture or a replay that fails
  raises; nothing falls back to eager.
* **Tracing** (``spans``, off by default). With host spans on, a call
  records ``step.copy_in`` (the slot, the state and input copies, the
  graph's lookup), ``step.launch`` (the replay, or the eager body) and
  ``step.clone_out`` inside ``step``. With device stages on, the body's
  stages stamp the device clock: a slot's graph key is (gate pattern,
  stamped), so stamps capture a second graph and leave the untraced one
  as it is, and each replay of the stamped graph clones its stamp buffers
  out of the pool into the spans log. With tracing off a call checks two
  flags and records nothing.
* **The mapping gate.** ``state.frame`` stays a host int, and
  ``pipeline._gated_mapping`` chooses on the host (``pipeline.maps_at``),
  so each pattern of the gate over a call's frames has its own graph: two
  for one frame with a ``mapping_skip_frame`` above 1 (JAX's
  ``lax.cond``), one with 1.
* **On CPU tensors** the same body runs eagerly on the same static
  buffers, with no graph: the tests' path. So does a CUDA state of a
  step built with ``capture=False``: a body whose collectives cannot be
  captured (gloo's: ``parallel.sharding.graphed`` decides, before any
  capture, never after a failure).
* **Collectives.** A body may issue ``torch.distributed`` collectives on
  an NCCL group (the sharded step's ``all_reduce``s, ``sharded_knn``'s
  ``all_gather``s): they are captured as NCCL kernels and run at each
  replay, so every rank of the group captures the same collectives in
  the same order and replays together (a replay waits for its peers).
  The warm-up frame runs every collective of the body before the capture,
  which creates the group's NCCL communicator (PyTorch makes it at the
  first collective); a collective in a gate branch is warmed up by that
  branch's warm-up frame, before the graph of its pattern is captured.
  Free such a graph before its process group is destroyed
  (``parallel.distributed.finish``): ``destroy_process_group`` hangs
  while a graph with NCCL collectives of two or more ranks is alive.
  The capture runs in ``torch.cuda.graph``'s default capture mode,
  ``"global"``, which NCCL needs no change of: on torch 2.11 with NCCL
  2.28 a capture with NCCL collectives inside holds while the process
  group's watchdog thread runs, also with eager collectives still in
  flight and the capture held open for seconds.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from aloam_tpu_torch import spans
from aloam_tpu_torch.utils.tree import map_tensors
from aloam_tpu_torch.utils.tree import rebuild as _rebuild
from aloam_tpu_torch.utils.tree import tensors as _tensors

captures = 0    # graphs captured, counted on the host
replays = 0     # graph replays


def _cloned(tree):
    return map_tensors(torch.clone, tree)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` are the same elements of the same memory."""
    return a.device == b.device and a.data_ptr() == b.data_ptr() \
        and a.dtype == b.dtype and a.shape == b.shape \
        and a.stride() == b.stride()


def copy_into(dst: list, src: list) -> None:
    """``dst[i]`` takes ``src[i]``'s values for every i, as if every source
    were read before any destination is written: a source that is its
    destination itself is skipped, and one that shares memory with any
    destination (a view of a static leaf, a leaf passed through) is
    cloned before the first copy."""
    owned = {d.untyped_storage().data_ptr() for d in dst}
    todo = []
    for d, s in zip(dst, src, strict=True):
        if _same(d, s):
            continue
        if s.untyped_storage().data_ptr() in owned:
            s = s.clone()
        todo.append((d, s))
    for d, s in todo:
        d.copy_(s)


def _key_of(tensors) -> tuple:
    """What a slot is made for: every tensor's shape, dtype and device."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


class _Slot:
    """A static state and static (F, ...) input stacks for one key."""

    def __init__(self, state, xyz: torch.Tensor, mask: torch.Tensor,
                 adopt: bool):
        tables = {id(t) for g in (state.map.corner, state.map.surf)
                  for t in g} if adopt else set()
        self.state = _rebuild(state, iter([
            t if id(t) in tables else t.clone(
                memory_format=torch.contiguous_format)
            for t in _tensors(state)]))
        self.xyz = torch.empty_like(xyz, memory_format=torch.contiguous_format)
        self.mask = torch.empty_like(mask,
                                     memory_format=torch.contiguous_format)
        self.graphs: dict = {}         # graph_key -> Captured

    def holds(self, state) -> bool:
        return all(_same(a, b) for a, b in zip(_tensors(state),
                                               _tensors(self.state)))


class Captured(NamedTuple):
    """One captured graph, the outputs it writes (in its pool), the host
    milliseconds its capture and its instantiation took, and the frames of
    device stages it stamps (``spans.Frame``, buffers in its pool)."""
    graph: torch.cuda.CUDAGraph
    outputs: tuple
    capture_ms: float
    instantiate_ms: float
    frames: tuple = ()


class StepGraph:
    """``step(state, xyz, mask) -> (state, outputs)`` run as a captured
    CUDA graph on a CUDA state, eagerly on a CPU one (see the module
    docstring). ``gate(frame)`` is the step's host-side branch at a frame
    (``pipeline.maps_at`` with the config bound). With ``capture=False``
    a CUDA state runs the same body eagerly too. ``step`` itself is the
    eager step, with no static buffers."""

    def __init__(self, step, gate, donate: bool = True,
                 capture: bool = True):
        self.step, self.gate, self.donate = step, gate, donate
        self.capture = capture
        self.slots: dict = {}

    def __call__(self, state, xyz: torch.Tensor, mask: torch.Tensor):
        """One frame: (new state, outputs)."""
        return self._call(state, xyz[None], mask[None], lambda o: o[0])

    def run(self, state, xyz_seq: torch.Tensor, mask_seq: torch.Tensor):
        """The step over every frame of (F, ...) input stacks from
        ``state``: (the state after them, the outputs stacked along a
        leading frame axis). On a CUDA state all F frames are one graph,
        replayed once."""
        return self._call(state, xyz_seq, mask_seq, None)

    def _call(self, state, xyz_seq, mask_seq, pick):
        """A call in three parts: the copies in, the launch, the clones
        out (``pick`` applied to each output). With tracing on
        (``spans``), the same parts inside the host spans ``step``,
        ``step.copy_in``, ``step.launch`` and ``step.clone_out``."""
        if spans.host_on or spans.device_on:
            return self._traced(state, xyz_seq, mask_seq, pick)
        slot, cap = self._copy_in(state, xyz_seq, mask_seq)
        outs = self._launch(slot, cap, state.frame)
        return self._clone_out(slot, cap, state, outs, pick)

    def _traced(self, state, xyz_seq, mask_seq, pick):
        with spans.call(state.frame), spans.host("step"):
            with spans.host("step.copy_in"):
                slot, cap = self._copy_in(state, xyz_seq, mask_seq)
            with spans.host("step.launch"):
                outs = self._launch(slot, cap, state.frame)
            with spans.host("step.clone_out"):
                return self._clone_out(slot, cap, state, outs, pick)

    def graph_key(self, frame0: int, n: int) -> tuple:
        """The key of a slot's graph for n frames from ``frame0``: the
        gate's pattern over them, and whether device stages are stamped
        (a second graph, the untraced one left as it is)."""
        return tuple(self.gate(frame0 + f) for f in range(n)), \
            spans.device_on

    def _copy_in(self, state, xyz_seq, mask_seq):
        """The slot of the inputs' key (made at first use), the state and
        the inputs copied into its static buffers, and the graph to replay
        (captured at first use; None where the body runs eagerly)."""
        key = _key_of(_tensors(state) + [xyz_seq, mask_seq])
        slot = self.slots.get(key)
        if slot is None:
            slot = self.slots[key] = _Slot(state, xyz_seq, mask_seq,
                                           self.donate)
        elif not (self.donate and slot.holds(state)):
            copy_into(_tensors(slot.state), _tensors(state))
        slot.xyz.copy_(xyz_seq)
        slot.mask.copy_(mask_seq)
        if not (slot.xyz.is_cuda and self.capture):
            return slot, None
        key = self.graph_key(state.frame, xyz_seq.shape[0])
        cap = slot.graphs.get(key)
        if cap is None:
            cap = slot.graphs[key] = self._capture(slot, state.frame, key[0])
        return slot, cap

    def _launch(self, slot: _Slot, cap, frame0: int):
        """The replay of ``cap`` (its outputs, in its pool), or the body
        run eagerly."""
        return self._body(slot, frame0) if cap is None else _replay(cap)

    def _clone_out(self, slot: _Slot, cap, state, outs, pick):
        """The outputs cloned out of a replayed graph's pool (and its
        stamps, into the spans log), and the new state."""
        if cap is not None:
            outs = _cloned(outs)
            spans.replayed(cap.frames)
        if pick is not None:
            outs = map_tensors(pick, outs)
        new = slot.state._replace(frame=state.frame + slot.xyz.shape[0])
        return (new if self.donate else _cloned(new)), outs

    def _body(self, slot: _Slot, frame0: int):
        """What the graph runs: the step over the static input stacks from
        the static state, each frame's outputs copied into stacks, then
        the new state copied into the static state. Returns the stacks.
        Each frame is a ``spans.frame``; the copies are its ``outputs``
        stage."""
        n = slot.xyz.shape[0]
        st, stacks = slot.state._replace(frame=frame0), None
        for f in range(n):
            with spans.frame(slot.xyz.device, f):
                st, out = self.step(st, slot.xyz[f], slot.mask[f])
                with spans.stage("outputs"):
                    if stacks is None:
                        stacks = _rebuild(out, iter([
                            o.new_empty((n,) + o.shape)
                            for o in _tensors(out)]))
                    for s, o in zip(_tensors(stacks), _tensors(out),
                                    strict=True):
                        s[f].copy_(o)
                    if f == n - 1:
                        copy_into(_tensors(slot.state), _tensors(st))
        return stacks

    def _capture(self, slot: _Slot, frame0: int, pattern: tuple) -> Captured:
        """Warm up each gate branch of ``pattern`` on a clone of the static
        state on a side stream, then capture :meth:`_body`."""
        def warm_up():
            for branch in dict.fromkeys(pattern):
                f = pattern.index(branch)
                warm = _cloned(slot.state)._replace(frame=frame0 + f)
                self.step(warm, slot.xyz[f], slot.mask[f])
        return _captured(slot.xyz.device, warm_up,
                         lambda: self._body(slot, frame0))


def _captured(dev: torch.device, warm_up, body) -> Captured:
    """``warm_up()`` run eagerly on a side stream of ``dev`` (ordered
    after the current stream's work, and before what follows), then
    ``body()`` captured into a new graph and instantiated; counted in
    :data:`captures`."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm_up()
        torch.cuda.current_stream(dev).wait_stream(side)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph), spans.capturing() as frames:
            outputs = body()
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
    global captures
    captures += 1
    return Captured(graph, outputs, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                    tuple(frames))


def _replay(cap: Captured):
    """One replay of ``cap`` on the current stream, counted in
    :data:`replays`: its outputs, in its pool (the next replay overwrites
    them; callers clone them out)."""
    cap.graph.replay()
    global replays
    replays += 1
    return cap.outputs


class FnGraph:
    """``fn(*tensors)`` -> a tensor or a tuple of them, with no state:
    captured once per set of the inputs' shapes, dtypes and devices, then
    replayed (the counterpart of a ``jax.jit`` with no donation). The
    first call with a key copies its inputs into static buffers, runs
    ``fn`` once eagerly on them on a side stream (the warm-up: cached
    constants, the communicator of a collective, the allocator), captures
    ``fn`` on them, copies the inputs in again (the warm-up may have
    updated them in place) and replays the graph; a later call copies its
    inputs in and replays. The outputs are cloned out of the graph's pool, so
    the next call cannot overwrite them, and the caller's inputs are never
    written. On CPU tensors, or with ``capture=False``, ``fn`` runs
    eagerly on the caller's inputs."""

    def __init__(self, fn, capture: bool = True):
        self.fn, self.capture = fn, capture
        self.slots: dict = {}          # key -> (static inputs, Captured)

    def __call__(self, *args: torch.Tensor):
        if not (self.capture and args[0].is_cuda):
            return self.fn(*args)
        key = _key_of(args)
        slot = self.slots.get(key)
        if slot is None:
            static = [a.clone(memory_format=torch.contiguous_format)
                      for a in args]
            slot = self.slots[key] = (static, _captured(
                args[0].device, lambda: self.fn(*static),
                lambda: self.fn(*static)))
        # every call, the first too: the warm-up may have written its
        # inputs (a step that updates the map tables in place)
        for s, a in zip(slot[0], args, strict=True):
            s.copy_(a)
        return _cloned(_replay(slot[1]))
