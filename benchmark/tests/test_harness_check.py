"""The check's pieces: the control's bfloat16 arithmetic, and the replay
drawn from the seed among what the window stepped."""

import torch

from benchmark import check
from benchmark.tests import _tiny


def _is_bf16(t):
    return torch.equal(t, t.to(torch.bfloat16).to(torch.float32))


def test_every_float32_result_is_rounded_to_bfloat16():
    x = torch.linspace(1.0, 2.0, 1001)
    assert not _is_bf16(x)
    with check.Bfloat16():
        y = x * 1.0001
        z = torch.sort(x).values
        s = x.sum()
        w = torch.zeros(4)
        w.add_(1.0001)
        n = torch.arange(5) * 3          # integers are left alone
    assert _is_bf16(y) and _is_bf16(z) and _is_bf16(s) and _is_bf16(w)
    assert torch.equal(n, torch.arange(5) * 3)
    assert not torch.equal(y, x * 1.0001)


def test_views_write_nothing():
    x = torch.linspace(1.0, 2.0, 1001)
    keep = x.clone()
    with check.Bfloat16():
        v = x[10:20]
        r = x.reshape(7, 143)
    assert v.data_ptr() == x.data_ptr() + 10 * 4
    assert r.data_ptr() == x.data_ptr()
    assert torch.equal(x, keep)


class _Window:
    def __init__(self, schedule):
        self.schedule = schedule


def test_the_replay_is_drawn_from_the_seed_among_passes_that_reached_it():
    from benchmark.harness import Program, _schedule
    cell = _tiny.cell("fleet", frames=4)
    cell.check.update(replay_frames=3, replay_streams=1)
    xyz = torch.zeros((2, 4, 8, 3))
    prog = Program(cell, xyz, torch.zeros((2, 4, 8), dtype=torch.bool),
                   "cpu")
    gen = _schedule(4)
    sched = [next(gen) for _ in range(4 * 5 + 2)]   # passes 0-4, pass 5 cut
    picks = {check.choose(cell, prog, _Window(sched), s)
             for s in range(2**31, 2**31 + 40)}
    assert {p.pass_ for p in picks} == {0, 1, 2, 3, 4}
    assert {tuple(p.streams) for p in picks} == {(0,), (1,)}
    assert all(p.frames == 3 for p in picks)
    seed = 2**33 + 5
    assert check.choose(cell, prog, _Window(sched), seed) == \
        check.choose(cell, prog, _Window(sched), seed)


def test_a_short_window_replays_the_furthest_pass_it_reached():
    from benchmark.harness import Program
    cell = _tiny.cell("single", frames=4)
    cell.check.update(replay_frames=4)
    prog = Program(cell, torch.zeros((2, 4, 8, 3)),
                   torch.zeros((2, 4, 8), dtype=torch.bool), "cpu")
    got = check.choose(cell, prog, _Window([(0, 0), (0, 1), (0, 2)]), 7)
    assert got == check.Replay(0, (0,), 3)
