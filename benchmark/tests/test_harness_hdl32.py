"""The hdl32 configuration's cases of the harness's CPU tests: the
HDL-32E's 32 rings through the ring formula (``test_harness_render.py``),
the frozen reference held to the f64 oracle on its sensor and leaves
(``test_harness_oracle.py``), and the whole run at a tiny size on the
fleet path against the ``hdl32-fleet-b32`` cell's own limits, the control
included (``test_harness_rehearsal.py``). The first two run the bodies of
those tests on the HDL-32 case."""

import json
import time

import torch

from benchmark import check, run
from benchmark.reference.aloam.config import AloamConfig
from benchmark.tests import _tiny
from benchmark.tests import test_harness_oracle as oracle
from benchmark.tests.test_harness_render import (
    test_rings_come_back_through_the_ring_formula as rings_come_back)

NAME = "hdl32-fleet-b32"
# 3 frames of the hdl32 cell's sensor at 512 steps a turn, 5 m/s; at the
# 0.2 / 0.4 m leaves the default insert and buckets drop up to ~800 map
# points a frame here, so they are sized up (5 dropped in frame 0)
ORACLE_CASE = (dict(scan_lines=32, azimuth=512, noise=0.01, dropout=0.05),
               3, 5.0,
               AloamConfig(scan_lines=32, minimum_range=0.3,
                           line_resolution=0.2, plane_resolution=0.4,
                           n_raw=16384, ring_cap=640, less_flat_cap=16384,
                           map_table_corner=4096, map_table_surf=8192,
                           corner_stack_cap=4096, surf_stack_cap=8192,
                           map_insert_point_cap=128,
                           map_insert_cell_cap=4096,
                           map_bucket_corner=64, map_bucket_surf=64))


def test_32_rings_come_back_through_the_ring_formula():
    rings_come_back(32, 8192, 256)


def test_reference_trajectory_matches_the_f64_oracle_on_hdl32(monkeypatch):
    monkeypatch.setitem(oracle.CASES, "hdl32", ORACLE_CASE)
    oracle.test_reference_trajectory_matches_the_f64_oracle("hdl32")


def _cell(frames=4):
    """``_tiny.cell("fleet")`` on the hdl32 configuration's sensor, with
    the buffers that scale with rings sized for 32 of them."""
    conf = json.loads((_tiny.HERE / "configs" / "hdl32.json").read_text())
    conf["aloam"].update(_tiny.SMALL, n_raw=8192, less_flat_cap=4096)
    conf["sensor"] = dict(conf["sensor"], azimuth=256)
    conf["log_frames"] = frames
    return _tiny.cell("fleet", frames)._replace(name=NAME, config=conf)


def test_sound_hdl32_run_is_correct_and_the_control_is_not():
    torch.set_num_threads(2)
    limits = run.load_cell(NAME)[2].check["limits"]
    cell = _cell()
    cell.check["limits"] = limits
    result, numbers, ctl = run.run_cell(
        _tiny.manifest(), cell, 2**31 + 101, 0.0, True, "cpu",
        time.perf_counter(), control=True, window_frames=6)
    assert result["correct"] is True
    assert result["metrics"] == {"issue_ms.fleet": result["metrics"][
        "issue_ms.fleet"]}            # no device time on the CPU
    assert all(v == 0.0 for v in numbers.values())
    json.dumps(result)
    assert not check.verdict(ctl, limits)
