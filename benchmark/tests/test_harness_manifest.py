"""BENCHMARK.json against the benchmark's contract, and the data files the
harness finds by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import check, roofline, run, trace

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == KEYS
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(MANIFEST["command"]) <= 32


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for e in MANIFEST[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup


def _reports(cell, kind):
    return set(run.cell_metrics(MANIFEST, cell, kind))


def test_every_cell_reports_what_it_must():
    for w in MANIFEST["workloads"]:
        e2e = _reports(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert _reports(w["name"], "per_layer")


def test_each_layer_metric_moves_a_metric_its_cells_report():
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert m["moves"] in _reports(cell, "end_to_end"), (m, cell)


def test_files_found_by_name():
    for c in MANIFEST["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
        assert c["file"].startswith("benchmark/")
    for w in MANIFEST["workloads"]:
        _, entry, cell = run.load_cell(w["name"], ROOT)
        assert entry == w and set(cell.check["limits"]) == set(
            check.NUMBERS)
    for m in MANIFEST["per_layer"]:
        assert callable(trace.load_metric(m["name"]).read)


def test_check_budget_holds_24_cells():
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of compile a cell
    and 1200 s spare fit in 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (MANIFEST["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200


def test_added_files_alone_are_found(tmp_path):
    """A later PR adds a config, a traffic mix, a cell and a per-layer
    metric as new files and manifest entries only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads(json.dumps(MANIFEST))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "vlp16.json").read_text())
    (b / "configs" / "hdl32.json").write_text(json.dumps(
        dict(cfg, name="hdl32")))
    (b / "traffic" / "single-paced.json").write_text(
        (b / "traffic" / "single.json").read_text())
    (b / "workloads" / "hdl32-single.json").write_text(
        (b / "workloads" / "vlp16-single.json").read_text())
    (b / "metrics" / "scans_done.single.py").write_text(
        "def read(record):\n    return float(len(record['issue_ms']))\n")
    m["configs"].append(dict(m["configs"][1], name="hdl32",
                             file="benchmark/configs/hdl32.json"))
    m["workloads"].append({"name": "hdl32-single", "config": "hdl32",
                           "traffic": "single-paced", "chips": 1,
                           "why": "x"})
    for e in m["end_to_end"]:
        if "vlp16-single" in e.get("workloads", ()):
            e["workloads"].append("hdl32-single")
    m["per_layer"].append({"name": "scans_done.single", "unit": "scans",
                           "better": "higher", "source": "host_clock",
                           "layer": "compiled step", "moves": "scan_ms_p99",
                           "workloads": ["hdl32-single"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    manifest, entry, cell = run.load_cell("hdl32-single", tmp_path)
    assert cell.config["name"] == "hdl32" and cell.traffic["path"] == "single"
    names = run.cell_metrics(manifest, "hdl32-single", "per_layer")
    assert names == ["scans_done.single"]
    got = trace.read_metrics(names, {"issue_ms": [1.0, 2.0]},
                             b / "metrics")
    assert got == {"scans_done.single": 2.0}
    (b / "kernels" / "extra.py").write_text(
        "PROFILER = ('extra_kernel',)\nWRAPPERS = ()\n")
    assert "extra" in roofline.load_kernels(b / "kernels")


def test_readers_leave_out_what_they_cannot_read():
    """A reader of another path's metric, or of a stretch with no device
    time, returns None, and the harness leaves the metric out."""
    record = {"path": "single", "issue_ms": [1.0], "busy_s": 0.0,
              "window_s": 1.0, "frames_traced": 2, "kernel_work": {},
              "kernel_s": {}}
    names = [m["name"] for m in MANIFEST["per_layer"]]
    assert trace.read_metrics(names, record) == {"issue_ms.single": 1.0}
