"""How far the JAX package moves its own 3-frame distorted chains when
every input coordinate is nudged by one ulp, beside how far the port is
from it: the measurement behind the chain tolerances of
tests/test_torch_distortion.py and the choice of its scene. On the CPU,
~1 minute:

    JAX_PLATFORMS=cpu python tests/_torch_distortion_spread.py

Prints, per chain (``step_b`` over the B streams, ``step`` over stream 0)
and output, the per-frame maximum over streams and components of
|JAX on a nudged scene - JAX| over 20 seeded nudges, and of |port - JAX|.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]
from test_torch_distortion import (B, CFG, JCFG, N_FRAMES,  # noqa: E402
                                   make_scene)

from aloam_tpu import pipeline as jpipe  # noqa: E402
from aloam_tpu_torch import pipeline as tp  # noqa: E402

NAMES = ("q_odom", "t_odom", "q_map", "t_map", "q_hf", "t_hf")
N_NUDGES = 20


def nudged(xyz, seed):
    up = np.random.default_rng(seed).random(xyz.shape) < 0.5
    return np.where(up, np.nextafter(xyz, np.inf),
                    np.nextafter(xyz, -np.inf)).astype(np.float32)


def chain(step, st, xyz, mask):
    outs = []
    for f in range(N_FRAMES):
        st, out = step(st, xyz[f], mask[f])
        outs.append({n: np.asarray(getattr(out, n)) for n in NAMES})
    return outs


def main():
    torch.set_num_threads(1)
    xyz, mask = make_scene()
    init_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                          jpipe.init_state(JCFG))
    init_b = init_b._replace(frame=jnp.zeros((B,), jnp.int32))
    chains = {
        "step_b": (jax.jit(lambda s, x, m: jpipe.step_b(s, x, m, JCFG)),
                   init_b, xyz, mask,
                   lambda: tp.init_state(CFG, B, "cpu"), tp.step_b),
        "step": (jax.jit(lambda s, x, m: jpipe.step(s, x, m, JCFG)),
                 jpipe.init_state(JCFG), xyz[:, 0], mask[:, 0],
                 lambda: tp.init_state(CFG, 1, "cpu"), tp.step),
    }
    for label, (step, init, x, m, port_init, port_step) in chains.items():
        base = chain(step, init, x, m)
        own = {n: np.zeros(N_FRAMES) for n in NAMES}
        for k in range(1, N_NUDGES + 1):
            for f, out in enumerate(chain(step, init, nudged(x, k), m)):
                for n in NAMES:
                    own[n][f] = max(own[n][f],
                                    np.abs(out[n] - base[f][n]).max())
        port = {n: np.zeros(N_FRAMES) for n in NAMES}
        st = port_init()
        for f in range(N_FRAMES):
            st, out = port_step(st, torch.from_numpy(x[f]),
                                torch.from_numpy(m[f]), CFG)
            for n in NAMES:
                port[n][f] = np.abs(getattr(out, n).numpy()
                                    - base[f][n]).max()
        for n in NAMES:
            print(f"{label} {n}: JAX nudged {np.round(own[n], 6).tolist()} "
                  f"port {np.round(port[n], 6).tolist()}")


if __name__ == "__main__":
    main()
