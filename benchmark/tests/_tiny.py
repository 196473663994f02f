"""Tiny cells for the CPU tests: the vlp16 configuration at a 256-step
azimuth, small capacities and 4-frame logs; two streams on the fleet path,
one on the single path."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark.harness import Cell

HERE = Path(__file__).resolve().parents[1]
SMALL = dict(n_raw=4096, ring_cap=256, less_flat_cap=2048,
             map_table_corner=1024, map_table_surf=2048,
             corner_stack_cap=256, surf_stack_cap=1024)


def manifest() -> dict:
    return json.loads((HERE.parent / "BENCHMARK.json").read_text())


def cell(path: str, frames: int = 4) -> Cell:
    config = json.loads((HERE / "configs" / "vlp16.json").read_text())
    config["aloam"].update(SMALL)
    config["sensor"] = dict(config["sensor"], azimuth=256)
    config["log_frames"] = frames
    traffic = json.loads((HERE / "traffic" / (
        "fleet-b32.json" if path == "fleet" else "single.json")).read_text())
    traffic.update(streams=2 if path == "fleet" else 1, pool=2)
    check = {"replay_frames": frames, "replay_streams": 2,
             "trace_frames": 2, "limits": {}}
    name = "hdl64-fleet-b32" if path == "fleet" else "vlp16-single"
    return Cell(name, config, traffic, copy.deepcopy(check))
