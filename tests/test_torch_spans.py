"""The port's tracing spans (``aloam_tpu_torch/spans.py``) on the CPU,
where a stamp is the host's ``perf_counter_ns`` and every frame runs
eagerly: the span tables of the compiled steps (``batched_step_jit`` at
B = 2, ``make_step_fn`` at B = 1, ``run_sequence(scan=True)``), their
order, nesting and tiling, the per-round spans, the host spans of a call,
outputs and state bit-equal with tracing on and off, nothing recorded or
stamped with it off, the graph key, the log's bound, the exporter
(``cli --trace``) and the stamp's plain version. The stamps as graph nodes
run only on the card (``chip_smoke.py`` phases 6, 8 and 10).
"""

import json

import numpy as np
import pytest
import torch

from aloam_tpu_torch import cli, graph, spans
from aloam_tpu_torch import pipeline as tp
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.io import synthetic as syn
from aloam_tpu_torch.ops import _build
from aloam_tpu_torch.ops import stamp as stamp_op
from aloam_tpu_torch.parallel import batched_step_jit

torch.set_num_threads(1)

# tests/test_torch_graph.py's 16-line config
CFG = AloamConfig(
    scan_lines=16, minimum_range=0.3,
    line_resolution=0.2, plane_resolution=0.4,
    n_raw=4096, ring_cap=256, less_flat_cap=2048,
    map_table_corner=1024, map_table_surf=2048,
    corner_stack_cap=256, surf_stack_cap=1024,
)
TOP = ["register", "features", "odometry", "mapping", "outputs", "outputs"]
HOST = {"step": None, "step.copy_in": "step", "step.launch": "step",
        "step.clone_out": "step"}


@pytest.fixture(autouse=True)
def _off():
    """Every test starts and ends with tracing off and an empty log."""
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


@pytest.fixture(scope="module")
def scene():
    """(F, 2, n_raw, 3) xyz and (F, 2, n_raw) mask: seeds 30, 31 at 1 and
    1.5 m/s, 3 frames."""
    xyz, mask = [], []
    for b in range(2):
        scans, _ = syn.make_sequence(3, scan_lines=CFG.scan_lines,
                                     n_azimuth=256, seed=30 + b,
                                     speed=1.0 + 0.5 * b)
        pads = [syn.pad_scan(s, CFG.n_raw) for s in scans]
        xyz.append(np.stack([p[0] for p in pads]))
        mask.append(np.stack([p[1] for p in pads]))
    return (torch.from_numpy(np.stack(xyz, axis=1)),
            torch.from_numpy(np.stack(mask, axis=1)))


def _stepped(path, scene, traced: bool):
    """3 frames of the compiled step of ``path`` from a fresh state: (the
    outputs of each frame, the final state, the drained records)."""
    xyz, mask = scene
    if path == "fleet":
        fn, st = batched_step_jit(CFG), tp.init_state(CFG, 2, "cpu")
        frames = [(xyz[f], mask[f]) for f in range(3)]
    else:
        fn, st = tp.make_step_fn(CFG), tp.init_state(CFG, 1, "cpu")
        frames = [(xyz[f, 0], mask[f, 0]) for f in range(3)]
    outs = []
    if traced:
        spans.enable(host=True, device=True)
    for x, m in frames:
        st, out = fn(st, x, m)
        outs.append(out)
    spans.disable()
    return outs, st, spans.drain()


@pytest.fixture(scope="module")
def runs(scene):
    """Each path stepped with tracing off and on."""
    spans.disable()
    out = {(p, t): _stepped(p, scene, t) for p in ("fleet", "single")
           for t in (False, True)}
    spans.drain()
    return out


def _frames(records):
    """{(call, frame): (device records in slot order, host records)}."""
    out = {}
    for r in records:
        dev, host = out.setdefault((r["call"], r["frame"]), ([], []))
        (dev if r["clock"] == "device" else host).append(r)
    for dev, _ in out.values():
        dev.sort(key=lambda r: r["slots"])
    return out


def _count(dev, name):
    return sum(r["name"] == name for r in dev)


@pytest.mark.parametrize("path", ["fleet", "single"])
def test_span_tables_tile_and_nest(runs, path):
    """Per frame of the compiled step: the table in slot order, the
    top-level stages in order and tiling the frame (each begins at or
    after the one before ends), every child inside its parent, the
    per-round spans once a round, the four host spans of the call around
    the device spans (on the CPU both clocks are perf_counter)."""
    frames = _frames(runs[path, True][2])
    assert [f for _, f in frames] == [0, 1, 2]
    assert len({c for c, _ in frames}) == 3          # a call a frame
    rounds = CFG.map_outer_rounds
    for dev, host in frames.values():
        # every slot used once, taken in launch order: the stamps' times
        # rise with their slots
        at = {}
        for r in dev:
            at[r["slots"][0]], at[r["slots"][1]] = r["start_ns"], r["end_ns"]
        assert sorted(at) == list(range(2 * len(dev)))
        assert [at[i] for i in sorted(at)] == sorted(at.values())
        top = [r for r in dev if r["parent"] is None]
        assert [r["name"] for r in top] == TOP
        for a, b in zip(top, top[1:]):
            assert a["start_ns"] <= a["end_ns"] <= b["start_ns"]
        by_name = {r["name"]: r for r in top}
        for r in dev:
            if r["parent"] is not None:
                p = by_name[r["parent"]]
                assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                    <= p["end_ns"], r["name"]
        parents = {r["name"]: r["parent"] for r in dev}
        assert {n for n, p in parents.items() if p == "features"} == \
            {"features.select", "features.rings"}
        assert _count(dev, "features.select") \
            == _count(dev, "features.rings") == 1
        assert {n for n, p in parents.items() if p == "odometry"} == \
            {"odom.assoc", "odom.lm", "odom.handoff"}
        assert _count(dev, "odom.assoc") == _count(dev, "odom.lm") \
            == CFG.odom_outer_rounds
        assert _count(dev, "odom.handoff") == 1
        for name in ("map.evict", "map.downsample", "map.insert"):
            assert _count(dev, name) == 1, name
        assert _count(dev, "map.lm") == rounds
        mapping = {n for n, p in parents.items() if p == "mapping"}
        if path == "fleet":
            assert mapping == {"map.evict", "map.downsample", "map.cache",
                               "map.assoc", "map.lm", "map.insert"}
            assert _count(dev, "map.cache") == 1     # reused in round 2
            assert _count(dev, "map.assoc") == rounds
        else:
            assert mapping == {"map.evict", "map.downsample", "map.knn",
                               "map.fit", "map.lm", "map.insert"}
            # corner then surf, every round
            assert _count(dev, "map.knn") == _count(dev, "map.fit") \
                == 2 * rounds
        assert {r["name"]: r["parent"] for r in host} == HOST
        h = {r["name"]: r for r in host}
        for a, b in zip(["step.copy_in", "step.launch"],
                        ["step.launch", "step.clone_out"]):
            assert h[a]["end_ns"] <= h[b]["start_ns"]
        assert h["step.launch"]["start_ns"] <= dev[0]["start_ns"] \
            and dev[-1]["end_ns"] <= h["step.launch"]["end_ns"]
        assert all(r["err_ns"] == 0 for r in dev + host)


@pytest.mark.parametrize("path", ["fleet", "single"])
def test_tracing_changes_no_output(runs, path):
    """Outputs of every frame and the final state bit-equal with tracing
    on and off; with it off nothing is recorded."""
    outs0, st0, recs0 = runs[path, False]
    outs1, st1, _ = runs[path, True]
    assert recs0 == []
    for a, b in zip(outs0 + [st0], outs1 + [st1]):
        ta, tb = graph._tensors(a), graph._tensors(b)
        assert len(ta) == len(tb) > 0
        for x, y in zip(ta, tb):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert st0.frame == st1.frame == 3


def test_off_launches_no_stamp(scene, monkeypatch):
    """With tracing off no stamp is launched, no stage or frame opens
    anything, and the log stays empty, through a compiled step and
    directly."""
    calls = []
    monkeypatch.setattr(stamp_op, "stamp", lambda *a: calls.append(a))
    xyz, mask = scene
    fn = batched_step_jit(CFG)
    fn(tp.init_state(CFG, 2, "cpu"), xyz[0], mask[0])
    with spans.frame("cpu"), spans.stage("register"), spans.host("step"):
        pass
    assert calls == [] and spans.drain() == []


def test_host_spans_are_profiler_ranges_under_a_profiler(scene):
    """Under torch.profiler the call's host spans are record_function
    ranges of the same names (the idle gaps' labels); without a profiler
    the spans are recorded all the same."""
    from torch.profiler import ProfilerActivity, profile
    xyz, mask = scene
    fn, st = batched_step_jit(CFG), tp.init_state(CFG, 2, "cpu")
    with spans.tracing(device=False):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            st, _ = fn(st, xyz[0], mask[0])
        fn(st, xyz[1], mask[1])
    names = {ev.name for ev in prof.events()}
    assert set(HOST) <= names
    assert [len(ms) for ms in spans.frame_ms(spans.drain())] == [4, 4]


def test_sequence_frames_share_a_call(scene):
    """run_sequence(scan=True): one body over 3 frames is one call with
    frames 0-2 from the state's frame, each with its own table; the
    state's copy is the last frame's outputs stage."""
    xyz, mask = scene
    with spans.tracing(host=False):
        st, _ = tp.run_sequence(tp.init_state(CFG, 1, "cpu"), xyz[:, 0],
                                mask[:, 0], CFG, scan=True)
    frames = _frames(spans.drain())
    assert len({c for c, _ in frames}) == 1
    assert [f for _, f in frames] == [0, 1, 2]
    for dev, host in frames.values():
        assert host == []
        assert [r["name"] for r in dev if r["parent"] is None] == TOP


def test_graph_key_differs_only_in_the_device_flag():
    fn = tp.make_step_fn(CFG.replace(mapping_skip_frame=2))
    off = fn.graph_key(3, 2)
    with spans.tracing(host=True, device=False):
        assert fn.graph_key(3, 2) == off
    with spans.tracing(host=False, device=True):
        on = fn.graph_key(3, 2)
    assert off == ((False, True), False) and on == ((False, True), True)


def test_log_keeps_the_last_frames_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(spans, "MAX_FRAMES", 3)
    spans.enable(host=False, device=True)
    for i in range(5):
        with spans.frame("cpu", i):
            with spans.stage("register"):
                pass
    assert spans.dropped() == 2
    recs = spans.drain()
    assert [r["frame"] for r in recs] == [2, 3, 4]
    assert spans.drain() == []
    monkeypatch.undo()
    spans.enable(host=False, device=True)
    assert spans.dropped() == 0 and spans._log.maxlen == spans.MAX_FRAMES


def test_stages_open_profiler_ranges_outside_a_capture():
    """Under a profiler each stage is a record_function range of its name
    (nested as the spans are); under a capture, and without a profiler,
    it is not."""
    from torch.profiler import ProfilerActivity, profile
    with spans.tracing(host=False), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.frame("cpu", 0):
            with spans.stage("mapping"), spans.stage("map.lm"):
                torch.ones(3).sum()
        with spans.capturing():
            with spans.frame("cpu", 1), spans.stage("odometry"):
                pass
    names = [e.name for e in prof.events()]
    assert names.count("mapping") == names.count("map.lm") == 1
    assert "odometry" not in names
    with spans.tracing(host=False), spans.frame("cpu", 2):
        st = spans.stage("features")
        with st:
            assert st.rf is spans._NULL


def test_capture_sends_frames_to_the_graph_and_replays_clone_them():
    """Frames finished under ``capturing`` go to the graph, not the log;
    each ``replayed`` clones the used slots into the log, so a later
    write to the graph's buffer does not reach an earlier replay's."""
    with spans.tracing(host=False):
        with spans.capturing() as frames:
            with spans.frame("cpu", 1):
                with spans.stage("mapping"), spans.stage("map.lm"):
                    pass
        assert len(frames) == 1 and spans.drain() == []
        spans.replayed(frames)
        frames[0].buf[:4] = 0
        spans.replayed(frames)
    first, second = spans.frame_ms(spans.drain())
    assert first["mapping"] >= first["map.lm"] > 0
    assert second == {"mapping": 0.0, "map.lm": 0.0, "graph": 0.0}


def test_misuse_raises():
    with spans.tracing(), spans.frame("cpu"):
        with pytest.raises(RuntimeError, match="do not nest"):
            with spans.frame("cpu"):
                pass
    with spans.tracing(), pytest.raises(RuntimeError, match="more than"):
        with spans.frame("cpu"):
            for _ in range(spans.SLOTS // 2 + 1):
                with spans.stage("register"):
                    pass


def test_frame_ms_sums_per_frame():
    def rec(call, frame, name, t0, t1, clock="device"):
        return dict(call=call, frame=frame, name=name, parent=None,
                    start_ns=t0, end_ns=t1, clock=clock, err_ns=0)
    recs = [rec(1, 4, "step", 0, 9_000_000, "host"),
            rec(1, 4, "map.lm", 1_000_000, 2_000_000),
            rec(1, 4, "map.lm", 3_000_000, 3_500_000),
            rec(1, 4, "outputs", 3_500_000, 4_000_000),
            rec(2, 5, "step", 0, 1_000_000, "host")]
    assert spans.frame_ms(recs) == [
        {"step": 9.0, "map.lm": 1.5, "outputs": 0.5, "graph": 3.0},
        {"step": 1.0}]


def test_stamp_plain_version_and_signature():
    buf = torch.zeros(4, dtype=torch.int64)
    stamp_op.stamp(buf, 1)
    stamp_op.stamp(buf, 2)
    assert 0 < buf[1] <= buf[2] and buf[0] == buf[3] == 0
    with pytest.raises(ValueError, match="slot 4"):
        stamp_op.stamp(buf, 4)
    assert _build.SIGNATURES["aloam_stamp"] == (_build._P, _build._I,
                                                _build._P)
    assert spans.offset("cpu") == (0, 0)


def test_cli_trace_writes_span_ms(tmp_path):
    """cli --trace on the CPU over 2 frames: each metrics.jsonl record
    carries its frame's span ms (every stage and host span, the graph's
    first to last stamp), and tracing is off after the run."""
    out = tmp_path / "run"
    cli.main(["--device", "cpu", "--preset", "VLP-16", "--synthetic",
              "--frames", "2", "--trace", "--out", str(out)])
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["frame"] for r in recs] == [0, 1]
    for r in recs:
        ms = r["span_ms"]
        assert set(TOP) | set(HOST) | {"graph", "odom.assoc", "map.knn",
                                       "map.fit", "map.lm"} <= set(ms)
        assert 0 < ms["graph"] <= ms["step.launch"] <= ms["step"]
    assert not (spans.host_on or spans.device_on)
