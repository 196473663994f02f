"""The port's bench (``aloam_tpu_torch/bench.py``) on the CPU: its control
flow, its scenes, configs and timing blocks against the JAX package's
``bench.py``, one batched run against bench.py's on a reduced config, and
its kernel check shown able to fail.

No timing is checked here: the numbers come only from a run on the card
(``python -m aloam_tpu_torch.bench``). ``main(device="cpu")`` runs the
control flow with ``bench_single`` / ``bench_batched`` faked, as
tests/test_bench_logic.py runs bench.py's; there the port departs on
purpose in one place: only an out-of-memory error of a ladder size is
recorded, any other error propagates.
"""

import contextlib
import dataclasses
import io
import json
import os
import types

import numpy as np
import pytest
import torch

from aloam_tpu import config as jconfig
from aloam_tpu_torch import bench as pb
from aloam_tpu_torch.config import PRESETS
from aloam_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _oom(batch):
    return torch.cuda.OutOfMemoryError(f"CUDA out of memory at B={batch}")


@pytest.fixture()
def bench_mod(monkeypatch):
    """The port's bench with BENCH_BATCH 32 and a faked one-stream run."""
    monkeypatch.setenv("BENCH_BATCH", "32")
    for knob in ("BENCH_PRESET_RUNG", "BENCH_BATCH_FRAMES", "BENCH_FRAMES"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(pb, "bench_single",
                        lambda cfg, n, device: (0.08, 0.02))
    return pb


@pytest.fixture()
def jax_bench(monkeypatch):
    """The JAX package's bench.py, imported as test_bench_logic.py does."""
    monkeypatch.syspath_prepend(REPO)
    import bench
    return bench


def _run_main(bench):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(device="cpu")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


# --- the ladder: test_bench_logic.py's six cases on the port ----------------

def test_ladder_reports_best(bench_mod, monkeypatch):
    calls = []

    def fake(cfg, batch, n_frames, device):
        calls.append(batch)
        return (80.0, 1.5, 0.05, 0.02, None) if batch == 32 \
            else (49.0, 1.0, 0.04, 0.02, None)

    monkeypatch.setattr(bench_mod, "bench_batched", fake)
    r = _run_main(bench_mod)
    # the trailing 32 is the preset rung at the best batch
    assert calls == [32, 16, 32]
    assert r["value"] == 80.0 and r["batch"] == 32
    assert r["batch_ladder"] == {"32": 80.0, "16": 49.0}
    assert r["value_preset"] == 80.0
    assert r["bench_caps"]["ring_cap"] == 1856
    assert r["bench_caps"]["less_flat_cap"] == 36864
    assert r["preset_caps"]["ring_cap"] == 2560
    assert r["preset_caps"]["n_raw"] == 131072
    assert r["preset_caps"]["less_flat_cap"] == 40960


def test_preset_rung_skippable(bench_mod, monkeypatch):
    calls = []

    def fake(cfg, batch, n_frames, device):
        calls.append(batch)
        return 49.0, 1.0, 0.04, 0.02, None

    monkeypatch.setenv("BENCH_PRESET_RUNG", "0")
    monkeypatch.setattr(bench_mod, "bench_batched", fake)
    r = _run_main(bench_mod)
    assert calls == [32, 16]
    assert "value_preset" not in r and "preset_caps" not in r


def test_ladder_falls_back_on_out_of_memory(bench_mod, monkeypatch):
    def fake(cfg, batch, n_frames, device):
        if batch == 32:
            raise _oom(batch)
        return 49.0, 1.0, 0.04, 0.02, None

    monkeypatch.setattr(bench_mod, "bench_batched", fake)
    r = _run_main(bench_mod)
    assert r["value"] == 49.0 and r["batch"] == 16
    assert r["batch_fallback"] == ["B=32: OutOfMemoryError"]


def test_ladder_all_fail_raises(bench_mod, monkeypatch):
    def fake(cfg, batch, n_frames, device):
        raise _oom(batch)

    monkeypatch.setattr(bench_mod, "bench_batched", fake)
    with pytest.raises(RuntimeError, match="every batch size failed"):
        _run_main(bench_mod)


def test_ladder_probes_64_on_near_linear_scaling(bench_mod, monkeypatch):
    calls = []

    def fake(cfg, batch, n_frames, device):
        calls.append(batch)
        return {32: 95.0, 16: 49.0, 64: 150.0}[batch], 1.0, 0.05, 0.02, None

    monkeypatch.setattr(bench_mod, "bench_batched", fake)
    r = _run_main(bench_mod)
    assert calls == [32, 16, 64, 64]   # final 64 = preset rung
    assert r["value"] == 150.0 and r["batch"] == 64
    assert r["batch_ladder"]["64"] == 150.0


def test_ladder_skips_64_on_sublinear_scaling(bench_mod, monkeypatch):
    calls = []

    def fake(cfg, batch, n_frames, device):
        calls.append(batch)
        return {32: 60.0, 16: 49.0}[batch], 1.0, 0.05, 0.02, None

    monkeypatch.setattr(bench_mod, "bench_batched", fake)
    r = _run_main(bench_mod)
    assert calls == [32, 16, 32]       # final 32 = preset rung
    assert r["value"] == 60.0 and r["batch"] == 32


# --- the port's departures ---------------------------------------------------

def test_out_of_memory_at_64_is_recorded(bench_mod, monkeypatch):
    """The 64 probe out of memory: recorded, the best of 32 / 16 stands
    and the preset rung runs at it."""
    calls = []

    def fake(cfg, batch, n_frames, device):
        calls.append(batch)
        if batch == 64:
            raise _oom(batch)
        return {32: 95.0, 16: 49.0}[batch], 1.0, 0.05, 0.02, None

    monkeypatch.setattr(bench_mod, "bench_batched", fake)
    r = _run_main(bench_mod)
    assert calls == [32, 16, 64, 32]
    assert r["batch"] == 32 and r["batch_fallback"] == [
        "B=64: OutOfMemoryError"]


@pytest.mark.parametrize("where", ["ladder", "preset rung"])
def test_other_errors_propagate(bench_mod, monkeypatch, where):
    """A failure that is not an out-of-memory error (a kernel that does
    not launch) fails the run, on the ladder and on the preset rung, and
    nothing is printed."""
    calls = []

    def fake(cfg, batch, n_frames, device):
        calls.append(batch)
        if where == "ladder" or len(calls) == 3:
            raise RuntimeError("CUDA error: an illegal memory access")
        return 49.0, 1.0, 0.04, 0.02, None

    monkeypatch.setattr(bench_mod, "bench_batched", fake)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(RuntimeError, match="illegal memory access"):
        bench_mod.main(device="cpu")
    assert buf.getvalue() == ""


def test_printed_keys_are_bench_pys(bench_mod, monkeypatch):
    """The keys, in order, of BENCH_r05.json's parsed line but
    step_gflops and mfu_pct (no FLOPs: the step runs no model)."""
    with open(os.path.join(REPO, "BENCH_r05.json")) as fh:
        want = [k for k in json.load(fh)["parsed"]
                if k not in ("step_gflops", "mfu_pct")]
    monkeypatch.setattr(bench_mod, "bench_batched",
                        lambda cfg, b, n, device: (49.0, 1.0, 0.04, 0.02,
                                                   None))
    assert list(_run_main(bench_mod)) == want


def test_main_needs_a_card_for_cuda(monkeypatch):
    """Without a card the bench raises before it runs anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pb, "bench_single", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.main()


# --- against bench.py --------------------------------------------------------

def test_stream_speeds_match_bench_py(jax_bench):
    assert [pb._stream_speed(b) for b in range(128)] == \
        [jax_bench._stream_speed(b) for b in range(128)]


@pytest.mark.parametrize("az,qchunk", [(1800, "2048"), (900, "1024")])
def test_batched_bench_cfg_matches_bench_py(jax_bench, monkeypatch, az,
                                            qchunk):
    """Field by field, on the preset and on another base."""
    monkeypatch.setattr(pb, "_AZ", az)
    monkeypatch.setattr(jax_bench, "_AZ", az)
    monkeypatch.setenv("BENCH_QCHUNK", qchunk)
    for name in ("HDL-64", "VLP-16"):
        got = pb.batched_bench_cfg(PRESETS[name])
        want = jax_bench.batched_bench_cfg(jconfig.PRESETS[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert dataclasses.asdict(pb.batched_bench_cfg()) == \
        dataclasses.asdict(jax_bench.batched_bench_cfg())
    assert pb.batched_bench_cfg().n_raw % 512 == 0


def test_cached_sequence_matches_bench_py(jax_bench, monkeypatch, tmp_path):
    """The same scene bit for bit (xyz, mask, ground truth), under a file
    name of the port's own, written whole and read back the same."""
    monkeypatch.setattr(pb, "_AZ", 64)
    monkeypatch.setattr(jax_bench, "_AZ", 64)
    monkeypatch.setattr(pb, "CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jax_bench, "_here", str(tmp_path / "jax"))
    got = pb._cached_sequence(3, 101, 5.25)
    want = jax_bench._cached_sequence(3, 101, 5.25)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (3, PRESETS["HDL-64"].n_raw, 3)
    assert os.listdir(tmp_path / "port") == [
        "torch_bench_hdl64_a64_f3_s101_v5.25.npz"]
    for g, w in zip(pb._cached_sequence(3, 101, 5.25), want):
        np.testing.assert_array_equal(g, w)


class _Clock:
    """A fake perf_counter that reads the number of steps taken so far,
    so its readings give each timed block's (first, last + 1) frame."""

    def __init__(self):
        self.steps, self.reads = 0, []

    def perf_counter(self):
        self.reads.append(self.steps)
        return float(self.steps)

    def step(self, state, xyz, mask):
        self.steps += 1
        return state, types.SimpleNamespace(t_map=xyz[:3])

    def blocks(self):
        return list(zip(self.reads[::2], self.reads[1::2]))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_time_blocks_partition_matches_bench_py(jax_bench, monkeypatch, n):
    """The same blocks over n frames (n // 3 a block, the remainder folded
    into the last), each timed over its frames, the trajectory in frame
    order."""
    frames = [(np.full(4, f, np.float32), np.ones(4, bool)) for f in range(n)]
    j_clock = _Clock()
    monkeypatch.setattr(jax_bench, "time", j_clock)
    j_secs, j_est, _ = jax_bench._time_blocks(j_clock.step, None, frames)

    t_clock = _Clock()
    monkeypatch.setattr(pb, "time", t_clock)
    t_frames = [tuple(map(torch.from_numpy, f)) for f in frames]
    t_secs, t_est, _ = pb._time_blocks(t_clock.step, None, t_frames)

    assert t_clock.blocks() == j_clock.blocks() == pb._blocks(n)
    assert t_secs == j_secs == [1.0] * len(pb._blocks(n))
    np.testing.assert_array_equal(t_est, j_est)


def test_time_blocks_refuses_a_capture_inside(monkeypatch):
    """A graph captured inside a timed block fails the run."""
    from aloam_tpu_torch import graph

    def step(state, xyz, mask):
        monkeypatch.setattr(graph, "captures", graph.captures + 1)
        return state, types.SimpleNamespace(t_map=xyz)

    frames = [(torch.zeros(3), torch.ones(3, dtype=torch.bool))] * 3
    with pytest.raises(RuntimeError, match="captured inside"):
        pb._time_blocks(step, None, frames)


def test_bench_batched_matches_bench_py(jax_bench, monkeypatch, tmp_path):
    """B = 2 streams over 3 timed frames (after bench.py's 2 warm-up
    frames) at 360 azimuth steps (fewer lose the track in both packages:
    ~1 m at 128), on the bench config with small caps and tables: the
    port's mapped position of every stream at every timed frame within
    2.5e-2 m per axis of bench.py's (the t_map bound of
    tests/test_torch_mapping.py), against the same ground-truth rows; each
    stream's ATE within 2.5e-2 · √3 m of bench.py's (as far as that bound
    lets an RMSE move) and under 0.5 m; the returned max and median those
    ATEs'; finite rates, no FLOPs."""
    monkeypatch.setattr(pb, "_AZ", 360)
    monkeypatch.setattr(jax_bench, "_AZ", 360)
    monkeypatch.setattr(pb, "CACHE_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jax_bench, "_here", str(tmp_path / "jax"))
    small = dict(less_flat_cap=4096, map_table_corner=1024,
                 map_table_surf=2048, corner_stack_cap=1024,
                 surf_stack_cap=2048)
    cfg = pb.batched_bench_cfg().replace(**small)
    jcfg = jax_bench.batched_bench_cfg().replace(**small)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    runs = {}

    def spy(key, fn):
        def call(*a, **kw):
            runs[key] = out = fn(*a, **kw)
            return out
        return call

    monkeypatch.setattr(pb, "run_batched", spy("port", pb.run_batched))
    monkeypatch.setattr(jax_bench, "_time_blocks",
                        spy("jax", jax_bench._time_blocks))
    got = pb.bench_batched(cfg, 2, 3, "cpu")
    want = jax_bench.bench_batched(jcfg, 2, 3)
    assert got[0] > 0 and got[1] >= 0 and got[4] is None

    _, est, gt = runs["port"]
    est_j = np.moveaxis(runs["jax"][1], 0, 1)              # (B, F, 3)
    gt_j = jax_bench.load_streams(jcfg, 2, 5)[2][:, 2:5]
    assert est.shape == est_j.shape == gt.shape == (2, 3, 3)
    np.testing.assert_array_equal(gt, gt_j)
    np.testing.assert_allclose(est, est_j, rtol=0, atol=2.5e-2)
    ate = [pb.ate_rmse(est[b], gt[b], align=False) for b in range(2)]
    ate_j = [pb.ate_rmse(est_j[b], gt[b], align=False) for b in range(2)]
    assert max(ate_j) == pytest.approx(want[2], abs=1e-6)
    assert np.median(ate_j) == pytest.approx(want[3], abs=1e-6)
    for b in range(2):
        assert abs(ate[b] - ate_j[b]) <= 2.5e-2 * 3 ** 0.5, (b, ate, ate_j)
        assert ate[b] < 0.5, (b, ate)
    assert got[2] == max(ate) and got[3] == float(np.median(ate))


@pytest.mark.parametrize("batch,n_streams", [("32", 64), ("16", 16),
                                              ("8", 8), ("48", 48), ("0", 0)])
def test_pregen_streams_follow_the_bench_knobs(monkeypatch, batch,
                                               n_streams):
    """pregen_streams makes the streams the bench reads under the same
    knobs: the one stream's BENCH_FRAMES, and as many ladder streams as
    the ladder's largest size, or 64 where 32 tops it (the B = 64
    probe)."""
    from aloam_tpu_torch import pregen_streams
    monkeypatch.setenv("BENCH_BATCH", batch)
    monkeypatch.setenv("BENCH_FRAMES", "8")
    monkeypatch.setenv("BENCH_BATCH_FRAMES", "6")
    jobs = pregen_streams.jobs()
    assert jobs[:3] == [(4, 7, 10.0), (8, 42, 10.0), (10, 3, 10.0)]
    assert jobs[3:] == [(8, 100 + b, pb._stream_speed(b))
                        for b in range(n_streams)]


# --- the kernel check --------------------------------------------------------

def _plus(fn, eps=1e-3, at=None):
    """fn's outputs with eps added (to output ``at`` of a tuple)."""
    def perturbed(*a, **kw):
        out = fn(*a, **kw)
        if at is None:
            return out + eps
        return tuple(o + eps if i == at else o for i, o in enumerate(out))
    return perturbed


def _merge_plus(plain):
    """plain, then the tables' points moved by 1e-3 in place."""
    def perturbed(pts, aux, *rest):
        stats = plain(pts, aux, *rest)
        pts.add_(1e-3)
        return stats
    return perturbed


def _float_plus(plain):
    """plain's output plus 1e-3 where it is floating point (an index
    moved off an integer would break the step before its check)."""
    def perturbed(*a, **kw):
        out = plain(*a, **kw)
        return out + 1e-3 if out.is_floating_point() else out
    return perturbed


# each kernel's perturbed side, made from its plain version
PERTURBED = {
    "knn_select_rows": lambda plain: _plus(plain, at=0),
    "knn_select": lambda plain: _plus(plain, at=0),
    "assoc_cell": _plus,
    "merge_tiles": _merge_plus,
    "segmented_prefix_sums": _plus,
    "window_mins": lambda plain: _plus(plain, at=0),
    "lm_fused": _plus,
    # labels are integers: one label off
    "select_rings": lambda plain: _plus(plain, eps=1),
    "bgather": _float_plus,
    "evict_and_count": _merge_plus,
}
# the kernels verify_kernels checks (the others only verify_rung does, at
# step_b's inputs)
VERIFIED = ("knn_select_rows", "knn_select", "assoc_cell", "merge_tiles",
            "segmented_prefix_sums", "window_mins", "lm_fused",
            "select_rings")


def _perturb(monkeypatch, name):
    """The kernel's wrapper replaced by its perturbed plain version."""
    spec = kernels.KERNELS[name]
    monkeypatch.setattr(kernels.module(name), spec.wrapper,
                        PERTURBED[name](kernels.plain(name)))


def test_verify_kernels_passes_on_the_plain_versions():
    """On the CPU each wrapper is its plain version: every check agrees,
    with error 0."""
    errs = pb.verify_kernels(torch.device("cpu"))
    assert set(errs) == {"knn_select", "assoc_cell", "merge_tiles",
                         "segmented_prefix_sums", "window_mins", "lm_fused",
                         "select_rings"}
    assert all(e == 0.0 for e in errs.values())


@pytest.mark.parametrize("name", sorted(VERIFIED))
def test_verify_kernels_fails_on_a_perturbed_kernel(monkeypatch, name):
    """The kernel side replaced by its plain version plus 1e-3 (one label
    for select_rings): the check raises and names the kernel."""
    _perturb(monkeypatch, name)
    with pytest.raises(RuntimeError, match=name):
        pb.verify_kernels(torch.device("cpu"))


def test_seg_scan_bound_scales_with_the_summed_magnitudes():
    """The seg scan's bound grows with the segmented sum of |x|, not with
    the result: a sum of ±1000 terms that cancels to ~0 may differ by
    f32 rounding of the terms (5e-5 here), not by 1e-2; the count channel
    is held exact; the bound cannot be read without the inputs."""
    from aloam_tpu_torch.ops import voxel
    vals = torch.tensor([[[1000.0, -1000.0, 0.5, 3.0, -3.0]]] * 2)
    vals[-1] = 1.0
    heads = torch.tensor([[True, False, False, True, False]])
    want = voxel.segmented_prefix_sums_plain(vals, heads)

    def off(eps, at=(0, 0, 2)):
        got = want.clone()
        got[at] += eps
        return kernels.agree("segmented_prefix_sums", got, want,
                               inputs=(vals, heads))

    assert off(5e-5)[0]                  # |p| = 0.5, Σ|x| = 2000.5
    assert not off(1e-2)[0]
    assert not off(5e-5, at=(0, 0, 4))[0]   # |p| = 0, Σ|x| = 6
    assert not off(1.0, at=(1, 0, 2))[0]    # the count channel
    with pytest.raises(ValueError, match="inputs"):
        kernels.agree("segmented_prefix_sums", want, want)


@pytest.fixture(scope="module")
def rung(tmp_path_factory):
    """The first two frames of B = 2 bench streams at 360 azimuth steps on
    the small config of test_bench_batched_matches_bench_py."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pb, "_AZ", 360)
    mp.setattr(pb, "CACHE_DIR", str(tmp_path_factory.mktemp("rung")))
    cfg = pb.batched_bench_cfg().replace(
        less_flat_cap=4096, map_table_corner=1024, map_table_surf=2048,
        corner_stack_cap=1024, surf_stack_cap=2048)
    xyz, mask, _ = pb.load_streams(cfg, 2, 2)
    mp.undo()
    return cfg, xyz, mask


def test_verify_rung_checks_every_kernel_of_step_b(rung):
    """On the CPU each wrapper is its plain version: all eight of step_b's
    kernels are recorded at frame 1 and agree, with error 0."""
    cfg, xyz, mask = rung
    errs = pb.verify_rung(cfg, 2, xyz, mask, "cpu")
    assert set(errs) == set(kernels.STEP_B) and len(errs) == 8
    assert all(e == 0.0 for e in errs.values())


@pytest.mark.parametrize("name", ["assoc_cell", "merge_tiles", "bgather",
                                  "evict_and_count"])
def test_verify_rung_fails_on_a_perturbed_kernel(rung, monkeypatch, name):
    """The kernel side replaced by its plain version plus 1e-3, the tables
    of the merge and of the window pass in place too: the rung's check
    raises and names the kernel."""
    _perturb(monkeypatch, name)
    cfg, xyz, mask = rung
    with pytest.raises(RuntimeError, match=name):
        pb.verify_rung(cfg, 2, xyz, mask, "cpu")
