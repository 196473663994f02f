"""Host-side stage timer — the TicToc equivalent (tic_toc.h:10-32), for the
data loader and the CLI. Device-side timing uses the port's spans
(``spans.py``) and torch.cuda.synchronize fences instead."""

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

