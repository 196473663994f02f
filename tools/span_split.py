"""Each stage's device time a frame on one benchmark cell, read from the
PyTorch/CUDA port's spans (``aloam_tpu_torch/spans.py``).

    python tools/span_split.py --workload hdl64-fleet-b32 \
        --seed 8180000031 --frames 200

Run from the repository root on a machine with a CUDA card. It renders
the cell's logs from the seed on the card and builds the cell's program
as a benchmark run does (``benchmark.run.render``,
``benchmark.harness.Program`` and ``warm_up``: the graphed step of the
cell's path), turns the port's device spans on (``%globaltimer`` stamps,
which the step's graph holds in a second capture), steps ``--skip`` +
``--frames`` frames through ``benchmark.harness.drive`` from the first
frame of the first pass, and prints one JSON line: the card's name and
power limit and, for each span over the last ``--frames`` frames, the
mean, the quartiles (``statistics.quantiles``) and the frames it
appeared in; ``graph`` is a frame's first stamp to its last. It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True,
                    help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=200,
                    help="frames the statistics are over")
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script on tiny cells")
    ap.add_argument("--skip", type=int, default=2,
                    help="traced frames left out first (the stamped "
                         "graph's capture)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from aloam_tpu_torch import spans
    from benchmark.harness import Program, drive, warm_up
    from benchmark.run import load_cell, render

    device = torch.device(args.device)
    _, _, cell = load_cell(args.workload)
    xyz, mask, _ = render(cell, args.seed, device)
    prog = Program(cell, xyz, mask, device)
    warm_up(prog)
    spans.enable(host=False, device=True)
    try:
        drive(prog, 0.0, n_frames=args.skip + args.frames)
    finally:
        spans.disable()
    frames = spans.frame_ms(spans.drain())[args.skip:]
    span_ms = {}
    for name in sorted({n for f in frames for n in f}):
        v = [f[name] for f in frames if name in f]
        q = statistics.quantiles(v, n=4) if len(v) > 1 else v * 3
        span_ms[name] = dict(mean=statistics.fmean(v), q1=q[0],
                             median=q[1], q3=q[2], frames=len(v))
    card = None
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
            else torch.cuda.get_device_name(device)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "frames": len(frames), "card": card,
                      "torch": torch.__version__, "span_ms": span_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
