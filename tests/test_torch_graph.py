"""The port's compiled step (``aloam_tpu_torch/graph.py``): the body that
``make_step_fn``, ``parallel.batched_step_jit`` and
``pipeline.run_sequence(scan=True)`` capture into CUDA graphs on a card,
run here eagerly on the CPU on the same static buffers.

Held bit for bit against the eager step (``step_b`` / ``step``): every
state leaf and every output, after a resumed state is copied in, at
``mapping_skip_frame`` 2, with ``donate=False``; and the one-program
sequence against JAX's ``run_sequence(scan=True)`` under jit at
tests/test_torch_single.py's bounds. The capture and the replay run only
on the card (``chip_smoke.py`` phase 12).
"""

import jax
import numpy as np
import pytest
import torch

from aloam_tpu import pipeline as jpipe
from aloam_tpu_torch import geometry as geo
from aloam_tpu_torch import graph
from aloam_tpu_torch import mapping as mp
from aloam_tpu_torch import pipeline as tp
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.io import synthetic as syn
from aloam_tpu_torch.ops import gridmap
from aloam_tpu_torch.parallel import batched_step_jit
import test_torch_single as single

torch.set_num_threads(1)

# tests/test_torch_mapping.py's 16-line config, with the registered cloud
CFG = AloamConfig(
    scan_lines=16, minimum_range=0.3,
    line_resolution=0.2, plane_resolution=0.4,
    n_raw=4096, ring_cap=256, less_flat_cap=2048,
    map_table_corner=1024, map_table_surf=2048,
    corner_stack_cap=256, surf_stack_cap=1024, emit_registered=True,
)
B = 2


@pytest.fixture(scope="module")
def scene():
    """(F, B, n_raw, 3) xyz and (F, B, n_raw) mask: tests/test_torch_mapping's
    streams 0 and 1 (seeds 30, 31 at 1 and 1.5 m/s), 4 frames."""
    xyz, mask = [], []
    for b in range(B):
        scans, _ = syn.make_sequence(4, scan_lines=CFG.scan_lines,
                                     n_azimuth=256, seed=30 + b,
                                     speed=1.0 + 0.5 * b)
        pads = [syn.pad_scan(s, CFG.n_raw) for s in scans]
        xyz.append(np.stack([p[0] for p in pads]))
        mask.append(np.stack([p[1] for p in pads]))
    return (torch.from_numpy(np.stack(xyz, axis=1)),
            torch.from_numpy(np.stack(mask, axis=1)))


def _eager(cfg, xyz, mask, n):
    """step_b from a fresh state over n frames: the state after each
    frame (cloned: the step updates the tables in place) and each frame's
    outputs."""
    st = tp.init_state(cfg, B, "cpu")
    states, outs = [graph._cloned(st)], []
    for f in range(n):
        st, out = tp.step_b(st, xyz[f], mask[f], cfg)
        states.append(graph._cloned(st))
        outs.append(out)
    return states, outs


def _storages(tree) -> set:
    return {t.untyped_storage().data_ptr() for t in graph._tensors(tree)}


def _assert_equal(got, want, what):
    g, w = graph._tensors(got), graph._tensors(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: leaf {i}"


def test_body_equals_step_b_and_resumes(scene):
    """batched_step_jit's body over 3 frames at B = 2 equals step_b bit for
    bit on every state leaf and every output; a different state (step_b's
    after frame 1) copied in steps frames 1-2 to step_b's again; nothing
    is captured on the CPU."""
    xyz, mask = scene
    states, outs = _eager(CFG, xyz, mask, 3)
    captures = graph.captures
    fn = batched_step_jit(CFG)
    st = tp.init_state(CFG, B, "cpu")
    for f in range(3):
        st, out = fn(st, xyz[f], mask[f])
        assert st.frame == f + 1
        _assert_equal(out, outs[f], f"outputs {f}")
        _assert_equal(st, states[f + 1], f"state {f}")
    (slot,) = fn.slots.values()
    assert slot.holds(st) and not slot.graphs
    resumed = graph._cloned(states[1])._replace(frame=1)
    assert not slot.holds(resumed)
    st = resumed
    for f in (1, 2):
        st, out = fn(st, xyz[f], mask[f])
        _assert_equal(out, outs[f], f"resumed outputs {f}")
        _assert_equal(st, states[f + 1], f"resumed state {f}")
    assert len(fn.slots) == 1 and graph.captures == captures


def test_skip_frame_two_branches(scene):
    """At mapping_skip_frame 2 over 4 frames the body takes the gate's
    branch by the host frame counter, as step_b does: bit-equal outputs
    and states, the skipped frames' map columns zero, frame 2's map
    factors not."""
    xyz, mask = scene
    cfg = CFG.replace(mapping_skip_frame=2)
    states, outs = _eager(cfg, xyz, mask, 4)
    fn = batched_step_jit(cfg)
    st = tp.init_state(cfg, B, "cpu")
    col = tp.METRIC_NAMES.index("map_surf_factors")
    maps = [i for i, n in enumerate(tp.METRIC_NAMES) if n.startswith("map_")]
    for f in range(4):
        st, out = fn(st, xyz[f], mask[f])
        _assert_equal(out, outs[f], f"outputs {f}")
        _assert_equal(st, states[f + 1], f"state {f}")
        if f % 2:
            assert not out.metrics[:, maps].any()
        elif f:
            assert bool((out.metrics[:, col] > 0).all())


def test_copy_into_stages_aliases():
    """copy_into: a new leaf that is a view of another static leaf is
    read before that leaf is written (two leaves swapped, a shifted view
    of its own leaf); a leaf passed through is not copied."""
    a = torch.arange(4.0)
    b = torch.arange(4.0) + 10
    c = torch.arange(6.0).reshape(2, 3)
    keep = c.data_ptr()
    graph.copy_into([a, b, c], [b, a, c])
    assert a.tolist() == [10, 11, 12, 13] and b.tolist() == [0, 1, 2, 3]
    assert c.data_ptr() == keep and c.flatten().tolist() == list(range(6))
    d = torch.arange(5.0)
    graph.copy_into([d[:4]], [d[1:]])
    assert d.tolist() == [1, 2, 3, 4, 4]


def test_donate_false_leaves_the_state(scene):
    """donate=False: the caller's state, tables included, is unchanged
    by a call, the state returned shares no memory with the static one,
    and both calls give step_b's outputs."""
    xyz, mask = scene
    states, outs = _eager(CFG, xyz, mask, 2)
    fn = batched_step_jit(CFG, donate=False)
    st0 = tp.init_state(CFG, B, "cpu")
    st1, out = fn(st0, xyz[0], mask[0])
    _assert_equal(st0, states[0], "the caller's state")
    _assert_equal(out, outs[0], "outputs 0")
    before = graph._cloned(st1)
    st2, out = fn(st1, xyz[1], mask[1])
    _assert_equal(st1, before, "the caller's state after frame 1")
    _assert_equal(st2, states[2], "state 1")
    _assert_equal(out, outs[1], "outputs 1")
    (slot,) = fn.slots.values()
    assert not _storages(slot.state) & _storages(st2)


def test_outputs_survive_the_next_call(scene):
    """The outputs of call k are unchanged by call k + 1, and none shares
    memory with the static state."""
    xyz, mask = scene
    fn = batched_step_jit(CFG)
    st = tp.init_state(CFG, B, "cpu")
    st, out0 = fn(st, xyz[0], mask[0])
    kept = graph._cloned(out0)
    st, _ = fn(st, xyz[1], mask[1])
    _assert_equal(out0, kept, "outputs of call 0")
    assert not _storages(st) & _storages(out0)


def test_scan_equals_host_loop_and_jax():
    """run_sequence(scan=True) over tests/test_torch_single.py's 16-line
    scene (3 frames, one stream) equals scan=False bit for bit, outputs
    and final state, and JAX's run_sequence(scan=True) under jit within
    test_torch_single's bounds (assert_frame_matches_jax)."""
    xyz, mask = single._scene()
    cfg, jcfg = single.CFG, single.JCFG
    st, outs = tp.run_sequence(tp.init_state(cfg, 1, "cpu"), single._t(xyz),
                               single._t(mask), cfg, scan=True)
    st_l, outs_l = tp.run_sequence(tp.init_state(cfg, 1, "cpu"),
                                   single._t(xyz), single._t(mask), cfg)
    assert st.frame == st_l.frame == single.N_FRAMES
    _assert_equal(outs, outs_l, "outputs")
    _assert_equal(st, st_l, "final state")
    run = jax.jit(lambda s, x, m: jpipe.run_sequence(s, x, m, jcfg,
                                                     scan=True))
    _, jouts = run(jpipe.init_state(jcfg), xyz, mask)
    jouts = jax.tree.map(np.asarray, jouts)
    for f in range(single.N_FRAMES):
        single.assert_frame_matches_jax(
            tp.SlamOutputs(*(None if o is None else o[f] for o in outs)),
            jpipe.SlamOutputs(*(None if o is None else o[f]
                                for o in jouts)), f)


def test_step_constants_cached_per_device():
    """The constants the step makes every frame: the mapping windows and
    the 2×2×2 block offsets are one tensor per (value, device), made once;
    the identity quaternion is made by device operations, fresh each
    call (so no state leaf aliases another through it); values as
    before."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    w = mp._window_cells(CFG, cpu)
    assert w is mp._window_cells(CFG, cpu)
    assert mp._local_cells(CFG, cpu) is mp._local_cells(CFG, cpu)
    assert mp._window_cells(CFG, meta).device == meta
    assert w.dtype == torch.int32 and w.tolist() == np.ceil(
        np.array([CFG.cube_width, CFG.cube_height, CFG.cube_depth])
        * CFG.cube_size / 2.0 / CFG.knn_cell).astype(int).tolist()
    o = gridmap._offsets8(cpu)
    assert o is gridmap._offsets8(cpu) and o.dtype == torch.int32
    assert gridmap._offsets8(meta).device == meta
    assert o.tolist() == [[i, j, k] for i in (0, 1) for j in (0, 1)
                          for k in (0, 1)]
    q1, q2 = geo.qidentity(cpu), geo.qidentity(cpu)
    assert q1.tolist() == [1.0, 0.0, 0.0, 0.0] and q1.dtype == torch.float32
    assert q1.data_ptr() != q2.data_ptr()
