"""Host-side stage timer — the TicToc equivalent (tic_toc.h:10-32), for the
data loader and the CLI. Device-side timing uses CUDA events and
torch.cuda.synchronize fences instead."""

from __future__ import annotations

import time


class TicToc:
    def __init__(self):
        self.tic()

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        """Elapsed milliseconds since tic()."""
        return (time.perf_counter() - self._t0) * 1e3


class StageTimes:
    """Accumulates named stage timings; prints a per-frame summary like the
    reference's printf instrumentation."""

    def __init__(self):
        self.times: dict[str, float] = {}

    def add(self, name: str, ms: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + ms

    def summary(self) -> str:
        return " ".join(f"{k}={v:.1f}ms" for k, v in self.times.items())
