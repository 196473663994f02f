"""The feature stage's per-ring clouds (``aloam_tpu_torch/ops/rings.py``)
on the CPU, where ``ring_clouds`` is its plain version.

``extract_features_b`` is held, from the same ring rows and curvature,
against the JAX package's and against the port's PyTorch path as it stood
before the ring kernel: the plain reference frozen in
``benchmark/reference/aloam`` (the same class sort, gathers and voxel
downsample). The ring rows (``_torch_scenes.ring_rows``) are street-canyon
rings with, in every stream, an empty ring, one of 16 points (no regions),
one of 17 (the least with regions), a full ring, one whose points all lie
in one voxel and one whose points each take a voxel (more voxels than a
ring's less-flat slots, so drops are counted). Masks, counts and the
copied clouds are exact against both; the less-flat means are bit-equal
to the frozen path's and within 1e-5 of JAX's (which sums in f32). The
kernel itself runs only on the card: ``chip_smoke.check_rings`` holds it
to this plain version on the same rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aloam_tpu import config as jconfig
from aloam_tpu import types as jtypes
from aloam_tpu.frontend import extract_features_b as j_extract_b
from aloam_tpu_torch.config import AloamConfig
from aloam_tpu_torch.frontend import extract_features_b
from aloam_tpu_torch.frontend.registration import curvature
from aloam_tpu_torch.ops import kernels
from aloam_tpu_torch.ops import rings as rings_op
from aloam_tpu_torch.types import RingCloud
from benchmark.reference.aloam import config as ref_config
from benchmark.reference.aloam import types as ref_types
from benchmark.reference.aloam.frontend import \
    extract_features_b as ref_extract_b
from _torch_scenes import RING_SPECIALS, ring_rows

torch.set_num_threads(1)

CLOUDS = ("sharp", "less_sharp", "flat", "less_flat", "full")
LF_RING = 512           # less-flat slots a ring


def _cfg(rings: int, c: int) -> AloamConfig:
    return AloamConfig(scan_lines=rings, minimum_range=0.3, ring_cap=c,
                       n_raw=rings * c, less_flat_cap=rings * LF_RING)


@pytest.mark.parametrize("streams,rings,c", [(1, 8, 2048), (3, 8, 2560)])
def test_ring_clouds_match_jax_and_the_parent_path(streams, rings, c):
    """B = 1 at VLP-16's ring_cap and B = 3 at HDL-64's, each stream's
    counts its own: every cloud and mask and the overflow against the
    frozen PyTorch path bit for bit and against JAX (copies and masks
    exact, less-flat means atol 1e-5, the batch's overflow equal); the
    special rings come out as they must."""
    rng = np.random.default_rng(1000 * streams + c)
    xyz, ins, cnt = ring_rows(rng, streams, rings, c)
    grid = np.concatenate([xyz, ins[..., None]], -1).reshape(
        streams, rings, c, 4)
    cnt = cnt.reshape(streams, rings)
    cfg = _cfg(rings, c)
    g = torch.from_numpy(grid)
    rc = RingCloud(xyz=g[..., :3], intensity=g[..., 3],
                   cnt=torch.from_numpy(cnt))
    curv = curvature(rc.xyz, cfg.edge_margin)
    got = extract_features_b(rc, curv, cfg)

    ref = ref_extract_b(
        ref_types.RingCloud(xyz=g[..., :3], intensity=g[..., 3],
                            cnt=torch.from_numpy(cnt)), curv,
        ref_config.AloamConfig(**dataclasses.asdict(cfg)))
    jcfg = jconfig.AloamConfig(**dataclasses.asdict(cfg))
    want = jax.jit(lambda r, cv: j_extract_b(r, cv, jcfg))(
        jtypes.RingCloud(xyz=jnp.asarray(grid[..., :3]),
                         intensity=jnp.asarray(grid[..., 3]),
                         cnt=jnp.asarray(cnt)), jnp.asarray(curv.numpy()))

    for name in CLOUDS:
        g_c, r_c, j_c = (getattr(f, name) for f in (got, ref, want))
        for leaf in ("xyz", "intensity", "mask"):
            a, b = getattr(g_c, leaf), getattr(r_c, leaf)
            assert a.shape == b.shape and a.dtype == b.dtype, (name, leaf)
            assert torch.equal(a, b), (name, leaf)
        np.testing.assert_array_equal(g_c.mask.numpy(), np.asarray(j_c.mask),
                                      err_msg=name)
        for leaf in ("xyz", "intensity"):
            a, b = getattr(g_c, leaf).numpy(), np.asarray(getattr(j_c, leaf))
            if name == "less_flat":
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
    assert torch.equal(got.overflow, ref.overflow)
    assert got.overflow.dtype == torch.int64
    assert int(got.overflow.sum()) == int(want.overflow)

    # the special rings: where each stream has them, and what they give
    lf = got.less_flat.mask.reshape(streams, rings, LF_RING)
    full = got.full.mask.reshape(streams, rings, c)
    picks = sum(getattr(got, n).mask.reshape(streams, rings, -1).sum(-1)
                for n in ("sharp", "less_sharp", "flat"))
    for b in range(streams):
        at = {kind: (b + k) % rings for k, kind in enumerate(RING_SPECIALS)}
        for kind in ("empty", "cnt16"):
            assert int(lf[b, at[kind]].sum()) == int(picks[b, at[kind]]) == 0
        assert int(full[b, at["cnt16"]].sum()) == 16
        assert int(picks[b, at["cnt17"]]) > 0
        assert bool(full[b, at["full"]].all())
        assert int(lf[b, at["one_voxel"]].sum()) == 1
        assert bool(lf[b, at["spread"]].all())      # more voxels than slots
        assert int(got.overflow[b]) > 0


def test_ring_clouds_refuse_rings_past_the_kernel():
    """Rows past the kernel's 4096 slots are refused on every device, by
    the wrapper and its plain twin alike, naming the cap; so are caps a
    stream's cloud cannot hold."""
    c = rings_op.MAX_SLOTS + 1
    args = (torch.zeros(2, c, 3), torch.zeros(2, c),
            torch.zeros(2, c, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 1, 6, (12, 120, 24, 64),
            (24, 240, 48, 128), 0.2)
    for fn in (rings_op.ring_clouds, rings_op.ring_clouds_plain):
        with pytest.raises(ValueError, match="4096"):
            fn(*args)
    c = 256
    ok = (torch.zeros(2, c, 3), torch.zeros(2, c),
          torch.zeros(2, c, dtype=torch.int32),
          torch.zeros(2, dtype=torch.int32), 1, 6)
    with pytest.raises(ValueError, match="into a cloud of 100"):
        rings_op.ring_clouds(*ok, (12, 120, 24, 64), (24, 240, 48, 100),
                             0.2)
    with pytest.raises(ValueError, match="regions"):
        rings_op.ring_clouds(*ok[:5], 0, (12, 120, 24, 64),
                             (24, 240, 48, 128), 0.2)
    assert rings_op.launches == 0


def test_ring_clouds_kernel_entry():
    """The kernel table's ring_clouds entry: its source exists and holds
    the C entry point that _build.SIGNATURES types, its counter is the
    module's, it replaces no pallas_call, and the front half (so every
    step) launches it, where the seg scan is mapping's alone."""
    import os

    from aloam_tpu_torch.ops import _build
    spec = kernels.KERNELS["ring_clouds"]
    assert (spec.module, spec.wrapper, spec.plain, spec.counter) == (
        "rings", "ring_clouds", "ring_clouds_plain", "launches")
    assert spec.replaces is None and spec.in_place == 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, spec.source)) as fh:
        assert 'extern "C" int aloam_ring_clouds(' in fh.read()
    assert len(_build.SIGNATURES["aloam_ring_clouds"]) == 28
    assert kernels.launches("ring_clouds") == rings_op.launches
    assert "ring_clouds" in kernels.FRONT
    assert "segmented_prefix_sums" not in kernels.FRONT
    assert {"ring_clouds", "segmented_prefix_sums"} <= set(kernels.STEP_B) \
        & set(kernels.STEP)
