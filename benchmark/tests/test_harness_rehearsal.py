"""The whole run on the CPU at a tiny size (the port's plain versions in
place of its kernels, no graph): a sound run comes out correct, and each
fault of the timed path that a cell can have, planted underneath the
harness, comes out not correct against the cells' own limits, as does the
control (the reference in bfloat16)."""

import json
import time

import pytest
import torch

from aloam_tpu_torch import pipeline
from benchmark import check, run
from benchmark.tests import _tiny

SEED = 2**31 + 101
REAL = {name: run.load_cell(name)[2].check["limits"]
        for name in ("hdl64-fleet-b32", "vlp16-single")}


def _run(path, trace=False, control=False, seed=SEED):
    torch.set_num_threads(2)
    cell = _tiny.cell(path)
    cell.check["limits"] = REAL[cell.name]
    return run.run_cell(_tiny.manifest(), cell, seed, 0.0, trace, "cpu",
                        time.perf_counter(), control=control,
                        window_frames=6)


@pytest.mark.parametrize("path", ["fleet", "single"])
def test_sound_run_is_correct_and_the_control_is_not(path):
    result, numbers, ctl = _run(path, trace=True, control=True)
    assert result["correct"] is True
    assert set(result) == {"correct", "attempted", "failed", "metrics",
                           "device", "breakdown", "checks"}
    assert list(result)[-1] == "checks"
    assert result["metrics"] == {f"issue_ms.{path}": result["metrics"][
        f"issue_ms.{path}"]}          # no device time on the CPU
    assert all(v == 0.0 for v in numbers.values())
    json.dumps(result)
    assert not check.verdict(ctl, REAL[_tiny.cell(path).name])


def _stepped(real, state, xyz, mask, cfg):
    from aloam_tpu_torch.graph import _cloned
    return real(_cloned(state), xyz, mask, cfg)


@pytest.mark.parametrize("path", ["fleet", "single"])
def test_a_step_that_returns_its_state_unchanged_is_caught(path,
                                                           monkeypatch):
    name = "step_b" if path == "fleet" else "step"
    real = getattr(pipeline, name)

    def stuck(state, xyz, mask, cfg, **kw):
        _, out = _stepped(real, state, xyz, mask, cfg)
        return state, out
    monkeypatch.setattr(pipeline, name, stuck)
    result, numbers, _ = _run(path)
    assert result["correct"] is False, numbers


def test_half_the_batch_left_out_is_caught(monkeypatch):
    real = pipeline.step_b

    def half(state, xyz, mask, cfg, **kw):
        new, out = _stepped(real, state, xyz, mask, cfg)
        h = xyz.shape[0] // 2

        def keep(n, o):
            if torch.is_tensor(n):
                n = n.clone()
                n[h:] = o[h:]
                return n
            if isinstance(n, tuple) and not isinstance(n, torch.Size):
                return type(n)(*(keep(a, b) for a, b in zip(n, o)))
            return n
        new = keep(new, state)._replace(frame=new.frame)
        prev = {"q_odom": state.odom.q_w, "t_odom": state.odom.t_w,
                "q_map": state.map.q_w, "t_map": state.map.t_w}
        out = out._replace(**{k: torch.cat([getattr(out, k)[:h], v[h:]])
                              for k, v in prev.items()})
        return new, out
    monkeypatch.setattr(pipeline, "step_b", half)
    result, numbers, _ = _run("fleet")
    assert result["correct"] is False, numbers


@pytest.mark.parametrize("path", ["fleet", "single"])
def test_an_answer_altered_where_it_is_produced_is_caught(path,
                                                          monkeypatch):
    name = "step_b" if path == "fleet" else "step"
    real = getattr(pipeline, name)

    def altered(state, xyz, mask, cfg, **kw):
        new, out = real(state, xyz, mask, cfg)
        if state.frame == 1:
            out = out._replace(t_map=out.t_map + 0.1)
        return new, out
    monkeypatch.setattr(pipeline, name, altered)
    result, numbers, _ = _run(path)
    assert result["correct"] is False, numbers
