"""The compiled sharded entry points (``parallel.batched_step_fn``, a
``graph.StepGraph``, and ``parallel.sharded_knn``, a ``graph.FnGraph``)
on a gloo world of one rank: here on the CPU their bodies run eagerly on
the same static buffers that a capture uses on the card.

Held bit for bit against the port's ``pipeline.step_b`` (outputs of every
frame and the final tables) over 3 frames of tests/test_torch_parallel.py's
streams; after a returned state, a fresh ``batched_init`` state copied in,
and at ``mapping_skip_frame`` 2; with a ``TableShard`` of the one rank,
whose ``all_reduce``s run over the world's group. ``sharded_knn`` through
its wrapper: equal to the dense ``knn`` and, at
test_sharded_knn_matches_jax_and_dense's bounds (indices exact, d2 rtol
1e-4 / atol 1e-5), to JAX's ``sharded_knn``; a second call at the same
shapes gives fresh results. The capture rule (``parallel.graphed``) one
case at a time. The (1, 2) and (2, 2) gloo meshes run in
tests/test_torch_parallel.py's workers, and the capture itself only on
the card (``chip_smoke.py`` phase 11).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from aloam_tpu.parallel import make_mesh as j_make_mesh
from aloam_tpu.parallel import sharded_knn as j_sharded_knn
from aloam_tpu_torch import graph
from aloam_tpu_torch import pipeline as tp
from aloam_tpu_torch.io import synthetic as syn
from aloam_tpu_torch.neighbors import knn
from aloam_tpu_torch.ops.gridmap import TableShard
from aloam_tpu_torch.parallel import (batched_init, batched_step_fn,
                                      distributed, graphed, make_mesh,
                                      sharded_knn)

from _torch_mp_worker import CFG
from test_torch_parallel import KNN_CASES, _knn_case

torch.set_num_threads(1)

B, N_FRAMES, K = 2, 3, 5


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) mesh of a gloo world of one rank, as
    test_distributed_helpers_single_process builds one."""
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    import os
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    distributed.initialize(
        init_method=f"tcp://127.0.0.1:{distributed.free_port()}",
        world_size=1, rank=0, backend="gloo")
    try:
        yield make_mesh(1, 1, "cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def scene():
    """tests/test_torch_parallel.py's streams 0 and 1 (seeds 30, 31 at 1
    and 1.5 m/s): (F, B, n_raw, 3) xyz and (F, B, n_raw) mask."""
    xyz = np.zeros((N_FRAMES, B, CFG.n_raw, 3), np.float32)
    mask = np.zeros((N_FRAMES, B, CFG.n_raw), bool)
    for b in range(B):
        scans, _ = syn.make_sequence(N_FRAMES, scan_lines=16, n_azimuth=256,
                                     seed=30 + b, speed=1.0 + 0.5 * b)
        for f, s in enumerate(scans):
            xyz[f, b], mask[f, b] = syn.pad_scan(s, CFG.n_raw)
    return torch.from_numpy(xyz), torch.from_numpy(mask)


def _whole(cfg, scene):
    """step_b from a fresh state over the frames: (outputs of every frame,
    the final state)."""
    xyz, mask = scene
    st, outs = tp.init_state(cfg, B, "cpu"), []
    for f in range(N_FRAMES):
        st, out = tp.step_b(st, xyz[f], mask[f], cfg)
        outs.append(out)
    return outs, st


@pytest.fixture(scope="module")
def whole(scene):
    return _whole(CFG, scene)


def _assert_bits(got, want, what):
    g, w = graph._tensors(got), graph._tensors(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: leaf {i}"
        if a.is_floating_point():         # bits: NaNs and -0.0 too
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
            a = a.view(bits[a.element_size()])
            b = b.view(bits[b.element_size()])
        assert torch.equal(a, b), f"{what}: leaf {i}"


def _stepped(fn, st, scene):
    xyz, mask = scene
    outs = []
    for f in range(N_FRAMES):
        st, out = fn(st, xyz[f], mask[f])
        outs.append(out)
    return outs, st


def test_batched_step_fn_is_a_step_graph_bit_equal_to_step_b(mesh, scene,
                                                             whole):
    """batched_step_fn on a (1, 1) mesh over 3 frames, each from the state
    it returned: a StepGraph that would capture on the card (n_model 1),
    its outputs and final tables bit-equal to step_b's; its eager body
    (``.step``) too; nothing captured on the CPU."""
    fn = batched_step_fn(CFG, mesh)
    assert isinstance(fn, graph.StepGraph) and fn.capture and fn.donate
    before = (graph.captures, graph.replays)
    outs, st = _stepped(fn, batched_init(CFG, B, "cpu", mesh), scene)
    assert (graph.captures, graph.replays) == before
    want_outs, want_st = whole
    _assert_bits(outs, want_outs, "outputs")
    assert st.frame == want_st.frame == N_FRAMES
    _assert_bits(st, want_st, "state")
    outs, st = _stepped(fn.step, batched_init(CFG, B, "cpu", mesh), scene)
    _assert_bits(outs, want_outs, "the eager body's outputs")
    _assert_bits(st.map, want_st.map, "the eager body's tables")


def test_batched_step_fn_donates_and_copies_other_states_in(mesh, scene,
                                                            whole):
    """The first state's map tables become the static ones (donated); a
    state the function returned steps with no copy (its leaves are the
    static state's); a fresh batched_init state is copied in and steps as
    step_b does from scratch; at mapping_skip_frame 2 the function is
    bit-equal to step_b at that config."""
    xyz, mask = scene
    fn = batched_step_fn(CFG, mesh)
    st0 = batched_init(CFG, B, "cpu", mesh)
    tables = [t for g in (st0.map.corner, st0.map.surf) for t in g]
    st, _ = fn(st0, xyz[0], mask[0])
    (slot,) = fn.slots.values()
    assert all(a is b for a, b in zip(
        [t for g in (slot.state.map.corner, slot.state.map.surf) for t in g],
        tables))
    ptrs = [t.data_ptr() for t in graph._tensors(st)]
    st, _ = fn(st, xyz[1], mask[1])
    assert [t.data_ptr() for t in graph._tensors(st)] == ptrs
    assert slot.holds(st)

    fresh = batched_init(CFG, B, "cpu", mesh)
    assert not slot.holds(fresh)
    outs, st = _stepped(fn, fresh, scene)
    assert len(fn.slots) == 1
    want_outs, want_st = whole
    _assert_bits(outs, want_outs, "fresh state, outputs")
    _assert_bits(st.map, want_st.map, "fresh state, tables")

    skip = CFG.replace(mapping_skip_frame=2)
    outs, st = _stepped(batched_step_fn(skip, mesh),
                        batched_init(skip, B, "cpu", mesh), scene)
    want_outs, want_st = _whole(skip, scene)
    _assert_bits(outs, want_outs, "mapping_skip_frame 2, outputs")
    _assert_bits(st.map, want_st.map, "mapping_skip_frame 2, tables")


def test_table_shard_of_one_rank_matches_whole_tables(mesh, scene, whole):
    """step_b with TableShard(the world's group, 0, 1) through a StepGraph
    (chip_smoke.py phase 11 (a) captures its all_reduces on one card):
    every collective runs over the group of one, and outputs and tables
    are the whole-table step_b's bit for bit."""
    group = mesh.get_group("model")
    calls = []
    real = dist.all_reduce

    def counted(t, *a, **kw):
        calls.append(t.dtype)
        return real(t, *a, **kw)
    fn = graph.StepGraph(
        lambda s, x, m: tp.step_b(s, x, m, CFG,
                                  shard=TableShard(group, 0, 1)),
        lambda f: tp.maps_at(CFG, f))
    dist.all_reduce = counted
    try:
        outs, st = _stepped(fn, tp.init_state(CFG, B, "cpu"), scene)
    finally:
        dist.all_reduce = real
    assert torch.int32 in calls and len(calls) >= N_FRAMES
    want_outs, want_st = whole
    _assert_bits(outs, want_outs, "outputs")
    _assert_bits(st.map, want_st.map, "tables")


def test_sharded_knn_wrapper_matches_dense_and_jax(mesh):
    """sharded_knn through its FnGraph on the (1, 1) mesh, on
    test_sharded_knn_matches_jax_and_dense's cases (all of one shape):
    equal to the dense knn (d2 and indices) and to JAX's sharded_knn on a
    (1, 1) mesh (indices exact, d2 at rtol 1e-4 / atol 1e-5); each call
    with new values at the same shapes gives the new values' result, and
    the earlier calls' outputs are left as they were."""
    fn = sharded_knn(mesh, k=K)
    assert isinstance(fn, graph.FnGraph) and fn.capture
    jknn = j_sharded_knn(j_make_mesh(1, 1), k=K)
    got = []
    for case in KNN_CASES:
        q, r, m = _knn_case(case)
        tq, tr, tm = map(torch.from_numpy, (q, r, m))
        d2, idx = fn(tq, tr, tm)
        dd, di = knn(tq, tr, tm, K)
        assert torch.equal(idx, di) and torch.equal(d2, dd), case
        jd, ji = jknn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji),
                                      err_msg=case)
        fin = np.isfinite(np.asarray(jd))
        np.testing.assert_array_equal(np.isfinite(d2.numpy()), fin)
        np.testing.assert_allclose(d2.numpy()[fin], np.asarray(jd)[fin],
                                   rtol=1e-4, atol=1e-5, err_msg=case)
        got.append((d2.clone(), idx.clone(), d2, idx))
    assert not torch.equal(got[0][1], got[1][1])
    assert len(fn.slots) == 0        # the CPU path keeps no static inputs
    for d_copy, i_copy, d2, idx in got:
        assert torch.equal(d_copy, d2) and torch.equal(i_copy, idx)


def test_fn_graph_runs_eagerly_on_cpu_tensors():
    """FnGraph on CPU tensors calls fn on the caller's own inputs and keeps
    no slot; a plain tuple of outputs keeps its type through the graph's
    tree helpers (the clone of a replay's outputs)."""
    seen = []

    def fn(a, b):
        seen.append((a, b))
        return a + b, a * b
    fg = graph.FnGraph(fn)
    a, b = torch.arange(4.0), torch.ones(4)
    s, p = fg(a, b)
    assert seen[0][0] is a and seen[0][1] is b and not fg.slots
    assert torch.equal(s, a + 1) and torch.equal(p, a)
    out = graph._cloned((s, p))
    assert type(out) is tuple and torch.equal(out[0], s) \
        and out[0].data_ptr() != s.data_ptr()


@pytest.mark.parametrize("device_type, n_model, backend, captured", [
    ("cpu", 1, None, False),        # a CPU state: the body runs eagerly
    ("cuda", 1, "gloo", True),      # no collective in the body
    ("cuda", 2, "nccl", True),      # NCCL's collectives go into the graph
    ("cuda", 2, "gloo", False),     # gloo stages through the host: eager
])
def test_capture_rule(device_type, n_model, backend, captured):
    """parallel.graphed: capture on a CUDA device when the body issues no
    collective or the model group is NCCL's; a gloo model group with
    n_model > 1 and a CPU call run eagerly."""
    assert graphed(device_type, n_model, backend) is captured


def test_finish_destroys_the_group_or_leaves_at_once():
    """distributed.finish at the end of a rank: after a clean run it
    destroys the process group; while an exception propagates it prints
    the traceback and leaves with code 1 (SystemExit: its own code), not
    reaching the destroy that a live NCCL graph would hang."""
    import os
    import sys
    code = ("import sys, torch.distributed as dist; "
            "from aloam_tpu_torch.parallel import distributed as d; "
            "d.initialize(backend='gloo'); mode = sys.argv[1]\n"
            "try:\n"
            "    if mode == 'raise': raise ValueError('boom')\n"
            "    if mode == 'exit': sys.exit(3)\n"
            "finally:\n"
            "    d.finish()\n"
            "print('clean', dist.is_initialized())\n")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    out = distributed.spawn([sys.executable, "-c", code, "ok"], 1, env, 120)
    assert out == ["clean False\n"], out
    with pytest.raises(RuntimeError, match=r"exited 1(.|\n)*ValueError: boom"):
        distributed.spawn([sys.executable, "-c", code, "raise"], 1, env, 120)
    with pytest.raises(RuntimeError, match="exited 3"):
        distributed.spawn([sys.executable, "-c", code, "exit"], 1, env, 120)
