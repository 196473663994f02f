"""One run of one cell: the logs rendered on the card, the program's step
warmed up, the measured window, and what the check needs from it.

The program is ``aloam_tpu_torch`` through its public entry points:
``parallel.batched_step_jit(cfg, donate=True)`` with ``parallel.batched_init``
on the ``fleet`` path, ``pipeline.make_step_fn(cfg)`` with
``pipeline.init_state`` on the ``single`` path. Both are captured CUDA
graphs (``graph.StepGraph``); the harness raises if a graph is captured
inside the window.

The window replays the traffic's pool of logs in passes: in pass p stream b
plays log (b + p·B) mod L from a fresh state. Each log is stepped frame by
frame from frame 0; the host hands a frame over as soon as the pose of the
frame before it has reached the host (fleet: at most one frame ahead of the
card) or of the frame itself (single: a closed loop of one scan).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch


class Cell(NamedTuple):
    name: str
    config: dict        # benchmark/configs/<config>.json
    traffic: dict       # benchmark/traffic/<traffic>.json
    check: dict         # benchmark/workloads/<cell>.json


def aloam_config(cls, config: dict):
    """The config dataclass ``cls`` with the file's fields."""
    return cls(**config["aloam"])


class Program:
    """The system under test on one path: its step, its fresh state, and
    the frame input of (pass, frame)."""

    def __init__(self, cell: Cell, xyz: torch.Tensor, mask: torch.Tensor,
                 device):
        from aloam_tpu_torch import parallel, pipeline
        from aloam_tpu_torch.config import AloamConfig
        self.cfg = aloam_config(AloamConfig, cell.config)
        self.path = cell.traffic["path"]
        self.streams = cell.traffic["streams"]
        self.xyz, self.mask, self.device = xyz, mask, device
        self.pool, self.frames = xyz.shape[0], xyz.shape[1]
        if self.path == "fleet":
            self.step = parallel.batched_step_jit(self.cfg, donate=True)
            self.init = lambda: parallel.batched_init(
                self.cfg, self.streams, device)
            self.eager = pipeline.step_b
        elif self.path == "single":
            if self.streams != 1:
                raise ValueError("the single path steps one stream")
            self.step = pipeline.make_step_fn(self.cfg)
            self.init = lambda: pipeline.init_state(self.cfg, 1, device)
            self.eager = pipeline.step
        else:
            raise ValueError(f"unknown path {self.path!r}")

    def logs_of(self, p: int) -> list:
        """The log each stream plays in pass p."""
        return [(b + p * self.streams) % self.pool
                for b in range(self.streams)]

    def frame(self, p: int, f: int):
        """(xyz, mask) of frame f of pass p, as the step takes them."""
        logs = self.logs_of(p)
        if self.path == "single":
            return self.xyz[logs[0], f], self.mask[logs[0], f]
        if logs == list(range(self.pool)):
            return self.xyz[:, f], self.mask[:, f]
        idx = torch.tensor(logs, device=self.device)
        return self.xyz[idx, f], self.mask[idx, f]


class Window(NamedTuple):
    t0: float             # perf_counter at the first scan handed over
    seconds: float        # from t0 to the last pose on the host
    schedule: list        # (pass, frame) of every frame handed over
    outs: list            # the step's outputs of each frame (on the card)
    poses: np.ndarray     # (frames, B, 7) q_map | t_map as the host got them
    issue_ms: np.ndarray  # host ms from each call to its return
    scan_ms: np.ndarray   # single: device-clock ms from a scan handed over
                          # to the host holding its pose; fleet: empty
    state: object         # the state after the last frame
    next: tuple           # (pass, frame) the schedule would hand over next


def _schedule(frames: int):
    p = f = 0
    while True:
        yield p, f
        f += 1
        if f == frames:
            p, f = p + 1, 0


def drive(prog: Program, seconds: float, start: tuple = (0, 0),
          n_frames: int | None = None, state=None) -> Window:
    """Step the program from (pass, frame) ``start`` (from ``state``, or a
    fresh state, and a fresh state at every frame 0) for ``seconds``, or
    for ``n_frames``
    frames when given.
    Raises if a graph is captured while it runs, unless it is a warm-up
    (``n_frames`` given). On the single path a scan's latency runs from
    an event recorded as the host hands the scan over to one the host
    records once it holds the pose, both stamped by the device's clock:
    the host's wake-up after the pose arrives is in it. On a CPU device
    (the rehearsal) every copy is synchronous and the latency is read from
    the host clock."""
    from aloam_tpu_torch import graph
    dev, b = torch.device(prog.device), prog.streams
    cuda, fleet = dev.type == "cuda", prog.path == "fleet"
    host = [torch.empty((b, 7), dtype=torch.float32, pin_memory=cuda)
            for _ in range(2)]
    if cuda:
        copier = torch.cuda.Stream(dev)
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(3))
        torch.cuda.synchronize(dev)
    outs, poses, issue, lat, sched = [], [], [], [], []
    pending = []                     # (host buffer, copy-done event)
    captures = graph.captures
    gen = _schedule(prog.frames)
    while next(gen) != start:
        pass
    p, f = start
    t0 = time.perf_counter()
    while not (len(sched) == n_frames if n_frames is not None
               else time.perf_counter() - t0 >= seconds):
        if f == 0 or state is None:
            state = prog.init()
        xyz, mask = prog.frame(p, f)
        buf = host[len(sched) % 2]
        if cuda and not fleet:
            e0.record()
        th = time.perf_counter()
        state, out = prog.step(state, xyz, mask)
        issue.append((time.perf_counter() - th) * 1e3)
        sched.append((p, f))
        outs.append(out)
        if not cuda:
            buf[:, :4].copy_(out.q_map.reshape(b, 4))
            buf[:, 4:].copy_(out.t_map.reshape(b, 3))
            lat.append((time.perf_counter() - th) * 1e3)
            poses.append(buf.numpy().copy())
        elif fleet:
            done = torch.cuda.Event()
            copier.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(copier):
                buf[:, :4].copy_(out.q_map, non_blocking=True)
                buf[:, 4:].copy_(out.t_map, non_blocking=True)
                done.record(copier)
            pending.append((buf, done))
            if len(pending) > 1:          # the host is one frame ahead
                buf0, done0 = pending.pop(0)
                done0.synchronize()
                poses.append(buf0.numpy().copy())
        else:
            buf[0, :4].copy_(out.q_map, non_blocking=True)
            buf[0, 4:].copy_(out.t_map, non_blocking=True)
            e1.record()
            e1.synchronize()
            e2.record()             # the host holds the pose
            poses.append(buf.numpy().copy())
            e2.synchronize()
            lat.append(e0.elapsed_time(e2))
        p, f = next(gen)
    for buf0, done0 in pending:
        done0.synchronize()
        poses.append(buf0.numpy().copy())
    t_end = time.perf_counter()
    if n_frames is None and graph.captures != captures:
        raise RuntimeError(f"{graph.captures - captures} CUDA graphs "
                           f"captured inside the measured window")
    return Window(t0, t_end - t0, sched, outs, np.stack(poses),
                  np.asarray(issue), np.asarray(lat if not fleet else []),
                  state, (p, f))


def warm_up(prog: Program) -> None:
    """Every shape and branch the window uses, before the window: the
    capture (the first call), the outputs' copies, and a log boundary (a
    fresh state copied into the graph's static state)."""
    last = prog.frames - 2
    drive(prog, 0.0, start=(0, last), n_frames=2)
    drive(prog, 0.0, start=(1, 0), n_frames=2)
