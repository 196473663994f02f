"""Seeded scenes for the port's kernel tests (numpy only)."""

import numpy as np


def segmented_reference(rng, bsz: int, rings: int, seg: int, pad: int,
                        fill: float = 0.8):
    """A ring-segmented odometry reference in the frontend's ring_heads
    layout, planar and poisoned as window_mins takes it: (B, 4, M) f32
    [x | y | z | ring], M = rings·seg + pad; ring r's valid points first
    in rows [r·seg, (r+1)·seg), on a cone at height 0.4 r - 12.8 around
    the sensor; padding at 1e9."""
    m = rings * seg + pad
    ref = np.full((bsz, 4, m), 1e9, np.float32)
    for b in range(bsz):
        for r in range(rings):
            cnt = int(seg * fill) - int(rng.integers(0, 8))
            th = rng.uniform(-np.pi, np.pi, cnt)
            rad = rng.uniform(6, 40, cnt)
            rows = slice(r * seg, r * seg + cnt)
            ref[b, 0, rows] = rad * np.cos(th)
            ref[b, 1, rows] = rad * np.sin(th)
            ref[b, 2, rows] = 0.4 * r - 12.8 + rng.normal(0, 0.02, cnt)
            ref[b, 3, rows] = r
    return ref


def queries_near(rng, ref, q: int, rings=None):
    """(B, Q, 3) f32 queries 0.3 m off valid reference points (of the
    given rings only, if any)."""
    sel = np.zeros((ref.shape[0], q, 3), np.float32)
    for b in range(ref.shape[0]):
        ok = ref[b, 3] < 1e8
        if rings is not None:
            ok &= np.isin(ref[b, 3], rings)
        pick = rng.choice(np.flatnonzero(ok), q)
        sel[b] = ref[b, :3, pick] + rng.normal(0, 0.3, (q, 3))
    return sel
