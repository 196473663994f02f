"""The port's ``parallel/`` and dense k-NN against the JAX package.

The k-NN runs in this process on the same numpy inputs through both
packages (JAX on the CPU under this suite's conftest). Everything that
needs more than one rank runs in real OS processes
(``tests/_torch_mp_worker.py``, or ``dryrun_multichip``'s own) that
rendezvous through ``torch.distributed`` over gloo, as
tests/test_multiprocess.py does for JAX; each worker has its own time
limit, and a worker that exits non-zero fails the test with its stderr.

Tolerances: d2 at rtol 1e-4 / atol 1e-5 (JAX's own, tests/test_sharding.py)
and indices exact; the sharded step within 3e-4 of the unsharded one
(JAX's contract for its sharded step, tests/test_sharding.py), and against
JAX's ``step_b`` at tests/test_torch_mapping.py's step_b bounds. With the
map tables split over "model" the step is bit-equal to the unsharded one
(outputs and tables), and held against JAX's ``batched_step_fn`` on the
same mesh at those bounds.
"""

import dataclasses
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from aloam_tpu import config as jconfig
from aloam_tpu import neighbors as jnb
from aloam_tpu import pipeline as jpipe
from aloam_tpu.io import synthetic as syn
from aloam_tpu.parallel import batched_init as j_batched_init
from aloam_tpu.parallel import batched_step_fn as j_batched_step_fn
from aloam_tpu.parallel import make_mesh as j_make_mesh
from aloam_tpu.parallel import sharded_knn as j_sharded_knn
from aloam_tpu_torch import neighbors as nb
from aloam_tpu_torch import pipeline as tp
from aloam_tpu_torch.parallel import batched_step_jit, distributed, make_mesh
from aloam_tpu_torch.parallel.dryrun import dryrun_multichip

from _torch_mp_worker import CFG, OUTPUTS

torch.set_num_threads(1)

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_mp_worker.py")
_TIMEOUT = 240          # seconds, each group of worker processes
K = 5
JCFG = jconfig.AloamConfig(**dataclasses.asdict(CFG))


def _spawn(mode: str, size: int, d) -> list:
    """Run ``size`` workers in ``mode``; returns their stdouts."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    # a host name may resolve to an interface gloo cannot reach; keep
    # every gloo pair on loopback
    env.update(GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    return distributed.spawn([sys.executable, _WORKER, mode, str(d)], size,
                             env, _TIMEOUT)


# ---- the dense k-NN ------------------------------------------------------

def _knn_case(name: str, m: int = 1024, shards: int = 4):
    """(query (64, 3), refs (m, 3), mask (m,)), seeded numpy. ``ties``
    duplicates refs across every shard boundary (of 2 and 4 shards) and
    puts queries exactly on them; ``masked`` masks 30% of the refs and the
    whole second shard; ``few`` leaves 3 valid refs, fewer than k."""
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.normal(size=(64, 3)).astype(np.float32) * 5
    r = rng.normal(size=(m, 3)).astype(np.float32) * 5
    mask = np.ones(m, bool)
    if name == "ties":
        for b in range(1, shards):
            lo = b * m // shards
            r[lo:lo + 4] = r[lo - 4:lo][::-1]
            q[4 * b:4 * b + 4] = r[lo - 4:lo]
    elif name == "masked":
        mask = rng.random(m) > 0.3
        mask[m // shards:2 * m // shards] = False
    elif name == "few":
        mask[:] = False
        mask[[m - 3, m // 2 + 1, 7]] = True
    return q, r, mask


KNN_CASES = ("random", "ties", "masked", "few")


def _close(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=msg)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-5,
                               err_msg=msg)


@pytest.mark.parametrize("case", KNN_CASES)
def test_dist2_and_knn_match_jax(case):
    """dist2_matrix, the dense knn and knn_streamed (chunk 128, the ref
    padded) against JAX's on the same inputs: d2 at rtol 1e-4 / atol
    1e-5, indices exact (ties go to the lowest index; a query with fewer
    than k valid refs gets the lowest masked indices from knn and index 0
    from knn_streamed's +inf slots, as in JAX)."""
    q, r, m = _knn_case(case)
    tq, tr, tm = map(torch.from_numpy, (q, r, m))
    _close(nb.dist2_matrix(tq, tr, tm), jnb.dist2_matrix(q, r, m))
    for got, want in (
            (nb.knn(tq, tr, tm, K), jnb.knn(q, r, m, K)),
            (nb.knn_streamed(tq, tr, tm, K, chunk=128),
             jnb.knn_streamed(jnp.asarray(q), jnp.asarray(r),
                              jnp.asarray(m), K, chunk=128))):
        _close(got[0], want[0], case)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]),
                                      err_msg=case)


def test_knn_past_the_dense_limit_streams():
    """Q·M past 32 Mi: both knn dispatchers take the streamed path (here
    with chunks of 1024 and a padded last chunk) and agree; the port's
    dense block is never built. Many queries over few refs, the queries
    inside the refs' cloud: the d2 expansion rounds at |q|²·ulp, and
    JAX's compiled scan rounds it differently from its eager dense path,
    so the nearest distances must stay large against |q|² for JAX's
    tolerance to hold."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(8192, 3)).astype(np.float32)
    r = rng.normal(size=(4097, 3)).astype(np.float32) * 5
    r[2048:2056] = r[:8]                           # ties across chunks
    q[:8] = r[:8]
    m = rng.random(r.shape[0]) > 0.1
    m[:8] = True
    assert q.shape[0] * r.shape[0] > 32 * 1024 * 1024
    calls = []
    real = nb.knn_streamed
    nb.knn_streamed = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        d2, idx = nb.knn(*map(torch.from_numpy, (q, r, m)), K, chunk=1024)
    finally:
        nb.knn_streamed = real
    assert calls == [1]
    want = jnb.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), K,
                   chunk=1024)
    _close(d2, want[0])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    assert (idx.numpy()[:8, :2] == np.stack(
        [np.arange(8), np.arange(8) + 2048], axis=1)).all()


# ---- sharded_knn over gloo ranks ------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_knn_matches_jax_and_dense(shards, tmp_path):
    """sharded_knn over ``shards`` gloo ranks, each holding M / shards
    refs, against JAX's sharded_knn on a (1, shards) mesh of the virtual
    CPU devices and against the port's dense knn: every rank returns the
    same d2 (rtol 1e-4 / atol 1e-5 against JAX, equal to the dense knn)
    and the same indices, exactly, also with ties across shard
    boundaries, a fully masked shard and fewer than k valid refs. On
    those (1, n) meshes batched_step_fn refuses a corner table of n / 2
    rows, which the n model ranks do not divide."""
    if len(jax.devices()) < shards:
        pytest.skip(f"needs {shards} JAX devices")
    cases = [_knn_case(c) for c in KNN_CASES]
    np.savez(tmp_path / "knn_in.npz",
             **{f"{c}{i}": a for i, case in enumerate(cases)
                for c, a in zip("qrm", case)})
    _spawn("knn", shards, tmp_path)
    for rank in range(shards):
        with np.load(tmp_path / f"knn_out_{rank}.npz") as z:
            assert "model ranks do not divide map_table_corner" in str(
                z["refused"])
    jknn = j_sharded_knn(j_make_mesh(1, shards), k=K)
    for i, (name, (q, r, m)) in enumerate(zip(KNN_CASES, cases)):
        jd, ji = jknn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m))
        dd, di = nb.knn(*map(torch.from_numpy, (q, r, m)), K)
        for rank in range(shards):
            with np.load(tmp_path / f"knn_out_{rank}.npz") as z:
                d2, idx = z[f"d{i}"], z[f"i{i}"]
            msg = f"{name} rank {rank}"
            np.testing.assert_array_equal(idx, np.asarray(ji), err_msg=msg)
            np.testing.assert_array_equal(idx, di.numpy(), err_msg=msg)
            np.testing.assert_array_equal(d2, dd.numpy(), err_msg=msg)
            _close(d2, jd, msg)


# ---- the sharded step ------------------------------------------------------

def _streams(batch: int, n_frames: int):
    """tests/test_sharding.py's distinct streams: (F, B, n, 3), (F, B, n)."""
    xs = []
    for b in range(batch):
        scans, _ = syn.make_sequence(n_frames, scan_lines=16, n_azimuth=256,
                                     seed=30 + b, speed=1.0 + 0.5 * b)
        xs.append([syn.pad_scan(s, CFG.n_raw) for s in scans])
    xyz = np.stack([[xs[b][f][0] for b in range(batch)]
                    for f in range(n_frames)])
    mask = np.stack([[xs[b][f][1] for b in range(batch)]
                     for f in range(n_frames)])
    return xyz, mask


def test_sharded_step_matches_unsharded_and_jax(tmp_path):
    """batched_step_fn over 2 gloo ranks, two streams each, 3 frames: the
    gathered outputs (every rank's the same) within 3e-4 of the port's
    unsharded step_b on the 4 streams (poses and metrics; on the CPU the
    plain versions make them equal), and against JAX's step_b under jit
    at tests/test_torch_mapping.py's bounds: q_odom / t_odom 2e-3 / 5e-3,
    the map and high-frequency poses 2.5e-2, feature counts and
    map_solved exact."""
    batch, n_frames = 4, 3
    xyz, mask = _streams(batch, n_frames)
    np.savez(tmp_path / "step_in.npz", xyz=xyz, mask=mask)
    _spawn("step", 2, tmp_path)
    outs = [dict(np.load(tmp_path / f"step_out_{r}.npz")) for r in range(2)]
    for name in outs[0]:
        np.testing.assert_array_equal(outs[1][name], outs[0][name], name)

    st = tp.init_state(CFG, batch, "cpu")
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape),
                       jpipe.init_state(JCFG))
    jst = jst._replace(frame=jnp.zeros((batch,), jnp.int32))
    jstep = jax.jit(lambda s, x, m: jpipe.step_b(s, x, m, JCFG))
    exact = ("n_sharp", "n_flat", "n_less_sharp", "n_less_flat",
             "map_solved")
    worst = 0.0
    for f in range(n_frames):
        st, want = tp.step_b(st, torch.from_numpy(xyz[f]),
                             torch.from_numpy(mask[f]), CFG)
        jst, jout = jstep(jst, xyz[f], mask[f])
        for name, atol in (("q_odom", 2e-3), ("t_odom", 5e-3),
                           ("q_map", 2.5e-2), ("t_map", 2.5e-2),
                           ("q_hf", 2.5e-2), ("t_hf", 2.5e-2),
                           ("metrics", None)):
            got = outs[0][f"{name}_{f}"]
            worst = max(worst, float(np.abs(
                got - getattr(want, name).numpy()).max()))
            np.testing.assert_allclose(got, getattr(want, name).numpy(),
                                       rtol=0, atol=3e-4,
                                       err_msg=f"{name} {f}")
            if atol is not None:
                np.testing.assert_allclose(
                    got, np.asarray(getattr(jout, name)), atol=atol,
                    err_msg=f"{name} {f} against JAX")
        got_m = dict(zip(tp.METRIC_NAMES, outs[0][f"metrics_{f}"].T))
        want_m = dict(zip(jpipe.METRIC_NAMES, np.asarray(jout.metrics).T))
        for name in exact:
            np.testing.assert_array_equal(got_m[name], want_m[name],
                                          err_msg=f"{name} {f}")
    print(f"max |sharded - unsharded| over poses and metrics: {worst:.3e}")


EXACT = ("n_sharp", "n_flat", "n_less_sharp", "n_less_flat", "map_solved")
JAX_BOUNDS = (("q_odom", 2e-3), ("t_odom", 5e-3), ("q_map", 2.5e-2),
              ("t_map", 2.5e-2), ("q_hf", 2.5e-2), ("t_hf", 2.5e-2))


@pytest.fixture(scope="module")
def whole_step():
    """The port's unsharded step_b over 4 streams and 3 frames: (xyz,
    mask, per-frame outputs as numpy dicts, the final state)."""
    xyz, mask = _streams(4, 3)
    st = tp.init_state(CFG, 4, "cpu")
    outs = []
    for f in range(3):
        st, o = tp.step_b(st, torch.from_numpy(xyz[f]),
                          torch.from_numpy(mask[f]), CFG)
        outs.append({n: getattr(o, n).numpy() for n in OUTPUTS})
    return xyz, mask, outs, st


@pytest.mark.parametrize("n_data", [1, 2])
def test_sharded_step_model_axis_matches_whole_and_jax(n_data, whole_step,
                                                       tmp_path):
    """batched_step_fn over an (n_data, 2) mesh of gloo ranks, each model
    rank holding half of its data group's map tables, 4 streams and 3
    frames. Every rank's table leaves are (4 / n_data, H / 2, ·), and
    shard_tables of the gathered tables gives them back; the two
    model ranks of a data group return the same outputs bit for bit every
    frame; the data groups' outputs, joined, and the tables gathered by
    gather_tables are the unsharded step_b's bit for bit; and the outputs
    hold against JAX's batched_step_fn on make_mesh(n_data, 2) of the
    virtual CPU devices at tests/test_torch_mapping.py's bounds (q_odom /
    t_odom 2e-3 / 5e-3, the map and high-frequency poses 2.5e-2; feature
    counts and map_solved exact). batched_step_fn is the compiled entry
    point (a graph.StepGraph, stepped from the state it returned), which
    on a gloo model group runs eagerly (parallel.graphed); every rank's
    outputs and table part equal its eager body's bit for bit."""
    if len(jax.devices()) < 2 * n_data:
        pytest.skip(f"needs {2 * n_data} JAX devices")
    xyz, mask, want, st = whole_step
    np.savez(tmp_path / "step_in.npz", xyz=xyz, mask=mask)
    _spawn("table", 2 * n_data, tmp_path)
    outs = [dict(np.load(tmp_path / f"table_out_{r}.npz"))
            for r in range(2 * n_data)]
    local = 4 // n_data
    for r, o in enumerate(outs):
        assert o.pop("round_trip"), r
        assert not o.pop("captured"), r      # gloo, n_model 2: eager
        assert o.pop("eager_tables_equal"), r
        for name in OUTPUTS:
            for f in range(3):
                np.testing.assert_array_equal(
                    o.pop(f"eager_{name}_{f}").view(np.uint8),
                    o[f"{name}_{f}"].view(np.uint8),
                    f"rank {r}: the eager body's {name} {f}")
        for kind, h in (("corner", CFG.map_table_corner),
                        ("surf", CFG.map_table_surf)):
            for leaf in ("pts", "aux"):
                width = getattr(getattr(st.map, kind), leaf).shape[-1]
                assert o[f"shape_{kind}_{leaf}"].tolist() == [
                    local, h // 2, width], (r, kind, leaf)
    for d in range(n_data):
        a, b = outs[2 * d], outs[2 * d + 1]
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], f"{d} {name}")
    for name in OUTPUTS:
        for f in range(3):
            np.testing.assert_array_equal(
                np.concatenate([outs[2 * d][f"{name}_{f}"]
                                for d in range(n_data)]),
                want[f][name], f"{name} {f}")
    for kind in ("corner", "surf"):
        for leaf in ("pts", "aux"):
            got = np.concatenate([outs[2 * d][f"{kind}_{leaf}"]
                                  for d in range(n_data)])
            whole = getattr(getattr(st.map, kind), leaf)
            np.testing.assert_array_equal(
                got.view(np.int32), whole.numpy().view(np.int32),
                f"{kind} {leaf}")

    jstep = j_batched_step_fn(JCFG, j_make_mesh(n_data, 2))
    jst = j_batched_init(JCFG, 4)
    for f in range(3):
        jst, jout = jstep(jst, jnp.asarray(xyz[f]), jnp.asarray(mask[f]))
        for name, atol in JAX_BOUNDS:
            np.testing.assert_allclose(want[f][name],
                                       np.asarray(getattr(jout, name)),
                                       atol=atol, err_msg=f"{name} {f}")
        got_m = dict(zip(tp.METRIC_NAMES, want[f]["metrics"].T))
        want_m = dict(zip(jpipe.METRIC_NAMES, np.asarray(jout.metrics).T))
        for name in EXACT:
            np.testing.assert_array_equal(got_m[name], want_m[name],
                                          err_msg=f"{name} {f}")
    shards = {s.data.shape for s in jst.map.surf.pts.addressable_shards}
    assert shards == {(local, CFG.map_table_surf // 2,
                       st.map.surf.pts.shape[-1])}


def test_two_process_runtime():
    """The counterpart of tests/test_multiprocess.py: two OS processes
    rendezvous through distributed.initialize() from MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK, all_reduce rank + 1 over the "data"
    axis (JAX's psum), run one sharded step each on its own stream and
    print MP_OK."""
    outs = _spawn("mp", 2, ".")
    for rank, out in enumerate(outs):
        assert f"MP_OK {rank} 3.0" in out, (rank, out)


# ---- single process --------------------------------------------------------

def test_distributed_helpers_single_process(monkeypatch):
    """initialize() with nothing set is a no-op; process_local_batch at
    world size 1; batched_step_jit(donate=False) leaves the input state's
    tables as they were (donate=True consumes them); in a world of one
    gloo rank, a second initialize() does nothing, global_mesh gives a
    (1, 1) mesh, and meshes the world cannot hold raise.
    (batched_step_fn's refusal of a table that n_model does not divide
    needs two ranks: test_sharded_knn_matches_jax_and_dense checks it on
    its (1, n) meshes.)"""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not dist.is_initialized()
    assert distributed.process_local_batch(6) == (6, 0)

    xyz, mask = _streams(1, 2)
    step = batched_step_jit(CFG, donate=False)
    st, _ = step(tp.init_state(CFG, 1, "cpu"), torch.from_numpy(xyz[0]),
                 torch.from_numpy(mask[0]))
    before = [t.clone() for g in (st.map.corner, st.map.surf) for t in g]
    st2, _ = step(st, torch.from_numpy(xyz[1]), torch.from_numpy(mask[1]))
    after = [t for g in (st.map.corner, st.map.surf) for t in g]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert not all(torch.equal(a, b) for a, b in zip(
        [t for g in (st2.map.corner, st2.map.surf) for t in g], before))
    batched_step_jit(CFG)(st, torch.from_numpy(xyz[1]),
                          torch.from_numpy(mask[1]))
    assert not all(torch.equal(a, b) for a, b in zip(after, before))

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    distributed.initialize(
        init_method=f"tcp://127.0.0.1:{distributed.free_port()}",
        world_size=1, rank=0, backend="gloo")
    try:
        distributed.initialize()            # a second call does nothing
        mesh = distributed.global_mesh(1, "cpu")
        assert mesh.mesh.tolist() == [[0]]
        assert mesh.mesh_dim_names == ("data", "model")
        assert distributed.process_local_batch(3) == (3, 0)
        with pytest.raises(ValueError, match="do not split"):
            distributed.global_mesh(2, "cpu")
        with pytest.raises(ValueError, match="need 2 ranks"):
            make_mesh(1, 2, "cpu")
    finally:
        dist.destroy_process_group()


def test_spawn_fails_on_a_failed_or_hung_rank():
    """distributed.spawn returns every rank's stdout in rank order, raises
    with the output of a rank that exits non-zero (killing the others
    at once), and kills a rank still running at its time limit."""
    code = ("import os, sys, time; r = int(os.environ['RANK']); "
            "print('rank', r, os.environ['WORLD_SIZE']); sys.stdout.flush(); ")
    outs = distributed.spawn([sys.executable, "-c", code], 2, timeout=60)
    assert outs == ["rank 0 2\n", "rank 1 2\n"], outs
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 .* exited 3"
                       r"(.|\n)*rank 1 2(.|\n)*boom"):
        distributed.spawn([sys.executable, "-c", code + (
            "r and sys.exit(sys.stderr.write('boom') and 3); "
            "time.sleep(60)")], 2, timeout=60)
    assert time.monotonic() - t0 < 30
    with pytest.raises(RuntimeError, match="rank 0 of 2 .* was still "
                       "running after 2 s"):
        distributed.spawn([sys.executable, "-c", code + "time.sleep(60)"],
                          2, timeout=2)


def test_dryrun_multichip(monkeypatch, capsys):
    """dryrun_multichip over 2 gloo ranks on the CPU: two distinct streams
    a rank (64 lines) for 3 frames, the gathered trajectories against the
    unsharded step on rank 0, then sharded_knn over a (1, 2) mesh equal
    to the dense knn; its OK lines, the graphs line saying that nothing
    was captured on the CPU."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = dryrun_multichip(2, "cpu", timeout=_TIMEOUT)
    for line in ("trajectory match OK: frames=3, streams=4",
                 "sharded knn OK: mesh=(1 data x 2 model)",
                 "dryrun_multichip OK: mesh=(2 data x 1 model), batch=4"):
        assert line in out, out
    assert "max |sharded - unsharded| = 0.00e+00 m" in out, out
    assert "map tables partitioned OK" in out, out
    assert "graphs OK: captures=0 replays=0 (eager on cpu)" in out, out


def test_dryrun_multichip_model_axis(monkeypatch):
    """dryrun_multichip over 4 gloo ranks: JAX's mesh choice, (2 data x 2
    model), each model rank holding half of its group's map tables (the
    partition assert on every rank, and its line), trajectories equal to
    the unsharded step, and sharded_knn over (1, 4)."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = dryrun_multichip(4, "cpu", timeout=_TIMEOUT)
    for line in ("map tables partitioned OK: ",
                 "MiB total / 4 devices)",
                 "trajectory match OK: frames=3, streams=4",
                 "max |sharded - unsharded| = 0.00e+00 m",
                 "sharded knn OK: mesh=(1 data x 4 model)",
                 "dryrun_multichip OK: mesh=(2 data x 2 model), batch=4"):
        assert line in out, out
