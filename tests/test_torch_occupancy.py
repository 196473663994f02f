"""tools/hdl32_occupancy.py on the CPU at a tiny size: what it recomputes
with no capacity in the way agrees with the step's own counts where no
capacity cut, and a capacity set below what it measured shows in the
step's overflow column."""

import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "hdl32_occupancy", os.path.join(ROOT, "tools", "hdl32_occupancy.py"))
occ = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(occ)

TINY = ["--seed", str(2**31 + 47), "--seeds", "1", "--device", "cpu",
        "--streams", "2", "--frames", "2", "--azimuth", "256",
        "--set", "n_raw=8192", "--set", "ring_cap=512",
        "--set", "map_table_corner=1024", "--set", "map_table_surf=2048"]


@pytest.mark.parametrize("less_flat_cap,cut", [(16384, False), (1024, True)])
def test_occupancy_agrees_with_the_steps_own_counts(capsys, less_flat_cap,
                                                    cut):
    torch.set_num_threads(2)
    assert occ.main(TINY + ["--set", f"less_flat_cap={less_flat_cap}"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got = json.loads(lines[-1])
    most, cap, col = got["max"], got["cap"], got["columns"]
    assert set(cap) == set(most) and len(got["ate_m"]) == 1
    assert 0 < most["returns"] <= 32 * 256
    assert 0 < most["ring_points"] <= 256
    assert (most["less_flat_ring"] > cap["less_flat_ring"]) == cut
    if cut:
        assert col["frontend_overflow"] > 0
        assert col["n_less_flat"] < most["less_flat"]
    else:
        # nothing was cut: the step counted what the tool recomputed
        assert col["frontend_overflow"] == 0
        assert col["n_less_flat"] == most["less_flat"]
