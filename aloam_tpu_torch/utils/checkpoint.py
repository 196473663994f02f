"""Checkpoint and resume of the SLAM state (port of
``aloam_tpu/utils/checkpoint.py``).

The file is the JAX package's: one ``.npz`` holding ``n_leaves`` and
``leaf_0``, ``leaf_1``, ... in the order ``jax.tree.flatten`` gives a
``SlamState`` (its NamedTuple fields in order, depth first: the odometry
state, the map state with its two tables, the frame counter). A state of
one stream (B = 1, as ``pipeline.step`` keeps it) is written in the JAX
single-stream layout: leaves without the stream axis, the frame an int32
scalar. A JAX single-stream checkpoint therefore loads into the port, and
the port's into the JAX package. A batched state keeps its stream axis and
writes the frame as (B,) int32, as JAX's batched state holds it.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _rebuild(tree, leaves):
    if isinstance(tree, tuple):
        return type(tree)(*(_rebuild(sub, leaves) for sub in tree))
    return next(leaves)


def save(path: str, state) -> None:
    """Write a ``pipeline.SlamState`` to one ``.npz`` (see the module
    docstring)."""
    bsz = state.odom.q_w.shape[0]
    arrays = {}
    for i, x in enumerate(_leaves(state)):
        if torch.is_tensor(x):
            a = x.detach().cpu().numpy()
        else:                                   # the host frame counter
            a = np.full((bsz,), x, np.int32)
        arrays[f"leaf_{i}"] = a[0] if bsz == 1 else a
    np.savez_compressed(path, n_leaves=len(arrays), **arrays)


def load(path: str, example):
    """Restore into the structure, devices and dtypes of ``example``, a
    state of the same config and stream count. A leaf may lack the
    example's stream axis of 1 (a single-stream checkpoint)."""
    with np.load(path) as data:
        n = int(data["n_leaves"])
        got = [data[f"leaf_{i}"] for i in range(n)]
    ex = _leaves(example)
    if len(ex) != n:
        raise ValueError(f"checkpoint has {n} leaves, expected {len(ex)}: "
                         "config or capacity mismatch")
    out = []
    for i, (g, e) in enumerate(zip(got, ex)):
        if not torch.is_tensor(e):
            out.append(int(np.reshape(g, -1)[0]))
            continue
        if (1,) + g.shape == tuple(e.shape):
            g = g[None]
        if g.shape != tuple(e.shape):
            raise ValueError(f"checkpoint leaf {i}: shape {g.shape}, "
                             f"expected {tuple(e.shape)}")
        out.append(torch.from_numpy(np.ascontiguousarray(g)).to(
            device=e.device, dtype=e.dtype))
    return _rebuild(example, iter(out))
