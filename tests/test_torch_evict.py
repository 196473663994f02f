"""The map window's evict and census (``ops/evict.py``) on the CPU.

The plain version against the JAX package's ``evict_and_count`` on
planted tables (``_torch_scenes.evict_table``: cells on the window's and
the local box's edges on each axis, empty and full rows, cells at the
int32 extremes): tables bit for bit, counts exact. The dispatch of
``gridmap.evict_and_count`` for CPU tensors, and the wrapper's pure
helpers and input checks. The CUDA kernel itself runs only on the card
(``chip_smoke.py``, ``check_evict``), where it is held bit-equal to the
plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aloam_tpu.ops import gridmap as jgrid
from aloam_tpu_torch.ops import evict as evict_op
from aloam_tpu_torch.ops import gridmap
from _torch_scenes import evict_table

torch.set_num_threads(1)

# (window_half, local_half): the local box inside the window, and one
# poking past it on two axes (the census counts after the clear)
BOXES = {"inside": ((6, 5, 3), (2, 2, 1)),
         "local_past_window": ((3, 5, 2), (4, 1, 3))}


def _case(seed, bsz, box, h=40, bk=32, rows_used=0.6):
    rng = np.random.default_rng(seed)
    window, local = (np.asarray(v, np.int32) for v in BOXES[box])
    center = rng.integers(-50, 50, (bsz, 3)).astype(np.int32)
    pts, aux = evict_table(rng, center, window, local, h, bk, rows_used)
    return pts, aux, center, window, local


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("evict", [True, False])
@pytest.mark.parametrize("bsz", [1, 3])
def test_plain_matches_jax(bsz, evict, box):
    """The plain version, through ``gridmap.evict_and_count``, against
    JAX's: both tables bit for bit after the in-place clear (untouched
    without ``evict``), cleared and census counts exact per stream, int64
    (B,). Every stream clears something (its edge row has cells one past
    the window on each axis); the empty row stays empty, and the full
    rows keep exactly their in-window slots."""
    pts, aux, center, window, local = _case(7 + bsz, bsz, box)
    jg, jn, jnear = jgrid.evict_and_count(
        jgrid.GridMap(pts=jnp.asarray(pts), aux=jnp.asarray(aux)),
        jnp.asarray(center), jnp.asarray(window), jnp.asarray(local), evict)
    grid = gridmap.GridMap(pts=_t(pts), aux=_t(aux))
    tg, tn, tnear = gridmap.evict_and_count(grid, _t(center), _t(window),
                                            _t(local), evict)
    assert tg.pts is grid.pts and tg.aux is grid.aux          # in place
    np.testing.assert_array_equal(tg.pts.numpy().view(np.int32),
                                  np.asarray(jg.pts).view(np.int32))
    np.testing.assert_array_equal(tg.aux.numpy(), np.asarray(jg.aux))
    for got, want in ((tn, jn), (tnear, jnear)):
        assert got.dtype == torch.int64 and tuple(got.shape) == (bsz,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cx = tg.aux.view(bsz, -1, 5, 32)[:, :, 1]
    assert (cx[:, 0] == gridmap._EMPTY).all()
    if evict:
        assert (tn > 0).all()
        assert int(tn.sum()) == int(((aux.reshape(bsz, -1, 5, 32)[:, :, 1]
                                      != gridmap._EMPTY).sum()
                                     - (cx != gridmap._EMPTY).sum()))
    else:
        assert not tn.any()
        np.testing.assert_array_equal(tg.aux.numpy(), aux)
        np.testing.assert_array_equal(tg.pts.numpy(), pts)
    assert (tnear > 0).all()


@pytest.mark.parametrize("evict", [True, False])
def test_cpu_tables_take_the_plain_version(monkeypatch, evict):
    """``gridmap.evict_and_count`` on CPU tensors runs the plain version
    once, with the caller's tables and flag, and launches no kernel."""
    pts, aux, center, window, local = _case(3, 2, "inside")
    calls = []
    plain = evict_op.evict_and_count_plain

    def spy(*args):
        calls.append(args)
        return plain(*args)
    monkeypatch.setattr(evict_op, "evict_and_count_plain", spy)
    grid = gridmap.GridMap(pts=_t(pts), aux=_t(aux))
    launches = evict_op.launches
    gridmap.evict_and_count(grid, _t(center), _t(window), _t(local), evict)
    assert len(calls) == 1 and calls[0][-1] is evict
    assert calls[0][0] is grid.pts and calls[0][1] is grid.aux
    assert evict_op.launches == launches


@pytest.mark.parametrize("streams, vectors, blocks", [
    (32, 8192 * 8, 16),       # the fleet's corner table: 512 of 528 slots
    (32, 16384 * 12, 16),     # its surf table
    (1, 8192 * 8, 256),       # one stream: a vector a thread
    (1, 16384 * 12, 528),     # the card's 4 x 132, the loop past it
    (1, 10 ** 6, 528),
    (200, 10 ** 6, 2),
    (3, 10, 1),
    (70000, 5, 1)])           # more streams than slots: one block each
def test_launch_plan(streams, vectors, blocks):
    """ops/evict.launch_plan on a 132-SM card: blocks a stream, never more
    in all than the 4 x 132 resident at once (but one a stream)."""
    assert evict_op.launch_plan(streams, vectors, 132) == blocks


@pytest.mark.parametrize("bk, address, width", [
    (32, 0, 16), (48, 0, 16), (48, 1 << 20, 16),
    (33, 0, 4), (5, 0, 4),     # an odd Bk: one slot a vector
    (2, 0, 8), (6, 0, 8),
    (32, 8, 8), (32, 4, 4)])   # a table not 16-byte aligned
def test_vector_width(bk, address, width):
    """The cx vector's bytes: the widest of 16, 8, 4 that divides 4·Bk
    and the table's address."""
    assert evict_op.vector_bytes(bk, address) == width


def test_wrapper_refuses_bad_inputs():
    """The wrapper raises on a tensor that is neither on the CPU nor a
    CUDA tensor (the meta device stands in), on tensors on two devices,
    on a wrong dtype and on a wrong shape; it never falls back."""
    pts, aux, center, window, local = (_t(a) for a in _case(5, 2, "inside"))
    meta = [t.to("meta") for t in (pts, aux, center, window, local)]
    bad = [meta, [pts, meta[1], center, window, local],
           [pts.double(), aux, center, window, local],
           [pts, aux.long(), center, window, local],
           [pts, aux, center.float(), window, local],
           [pts, aux, center, window.long(), local],
           [pts, aux, center[:, :2], window, local],
           [pts, aux, center, window, local[:2]],
           [pts[:, :, :-1], aux, center, window, local],
           [pts, aux[0], center, window, local]]
    launches = evict_op.launches
    for args in bad:
        with pytest.raises(ValueError):
            evict_op.evict_and_count(*args)
    assert evict_op.launches == launches


def test_tolerance_holds_tables_bit_for_bit():
    """``ops/tolerance.agree`` (the card's comparison of kernel and plain)
    takes the two tables and the counts bit for bit: a table equal in
    value but not in bits (-0.0 for 0.0), or a count one off, fails."""
    from aloam_tpu_torch.ops import tolerance
    pts, aux, center, window, local = (_t(a) for a in _case(9, 2, "inside"))
    counts = evict_op.evict_and_count(pts, aux, center, window, local)
    want = (pts, aux, *counts)
    assert tolerance.agree("evict_and_count", tuple(t.clone() for t in want),
                           want) == (True, 0.0)
    signed = pts.clone()
    signed.view(-1)[0] = 0.0
    zero = signed.clone()
    zero.view(-1)[0] = -0.0
    assert not tolerance.agree("evict_and_count", (zero, aux, *counts),
                               (signed, aux, *counts))[0]
    assert not tolerance.agree("evict_and_count",
                               (pts, aux, counts[0] + 1, counts[1]), want)[0]
