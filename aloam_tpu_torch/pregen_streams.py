"""Generate the port bench's synthetic streams into ``.bench_cache/``
before the bench runs, so that ``python -m aloam_tpu_torch.bench`` does
not raytrace inside its run (~0.3 s a frame on one host core):

    python -m aloam_tpu_torch.pregen_streams

It reads the bench's own knobs (BENCH_BATCH, BENCH_FRAMES,
BENCH_BATCH_FRAMES), so run it with the environment the bench will get.
The jobs, in order: the one-stream bench's warm-up (4 frames, seed 7) and
timed scene (BENCH_FRAMES, seed 42), the stage scene (10 frames, seed 3),
then the ladder's streams (seed 100 + b, BENCH_BATCH_FRAMES + 2 frames):
as many as the ladder's largest size, or 64 where 32 tops it (the B = 64
probe). Streams are independent, so a pool of processes, one a core,
makes them; each file depends only on its job, so the cache is the same
with any number of processes, and an interrupted run leaves whole files
only.
"""

from __future__ import annotations

import multiprocessing
import os
import time

from aloam_tpu_torch import bench


def jobs() -> list:
    """(frames, seed, speed) of every stream the bench reads, in order."""
    n_b = int(os.environ.get("BENCH_BATCH_FRAMES", "32"))
    n_1 = int(os.environ.get("BENCH_FRAMES", "16"))
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    n_streams = 64 if batch == 32 else max(bench.ladder(batch), default=0)
    out = [(4, 7, 10.0), (n_1, 42, 10.0), (10, 3, 10.0)]
    return out + [(n_b + 2, 100 + b, bench._stream_speed(b))
                  for b in range(n_streams)]


def _make(job) -> None:
    bench._cached_sequence(*job)


def main() -> None:
    todo = jobs()
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(os.cpu_count()) as pool:
        for i, _ in enumerate(pool.imap(_make, todo)):
            f, s, v = todo[i]
            print(f"[{i + 1}/{len(todo)}] f={f} seed={s} v={v:g} "
                  f"t={time.perf_counter() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
