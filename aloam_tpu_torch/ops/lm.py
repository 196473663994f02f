"""One-launch Levenberg-Marquardt solve (kernel module).

Port of ``aloam_tpu/ops/pallas_lm.py:lm_fused``. The CUDA kernel is
``csrc/lm.cu``: one thread block cluster per stream runs every sweep, each
block over its own slice of the factor rows held in shared memory; the
blocks exchange their sums through distributed shared memory, and each
solves the 6x6, retracts and decides on the same sums. :func:`launch_plan`
picks the cluster size from the batch and the card's SM count. The plain
version beside it unpacks the channels and runs ``solver.lm_solve``, the
batched PyTorch form of the same solve with ``torch.linalg.solve_ex``.

Factor channels are planar, (B, 10, Ne) edges [px py pz ax ay az bx by bz
mask] and (B, 8, Np) planes [px py pz nx ny nz d mask]; any Ne, Np (the
TPU kernel's multiple-of-128 rule was a Mosaic layout limit). Factors of
the distortion path carry their per-point time fractions as one more,
last channel, (B, 11, Ne) / (B, 9, Np): the kernel slerps the pose per
factor (the JAX package sends such factors to its XLA solve instead).
Both batches carry it or neither does.
"""

from __future__ import annotations

import torch

from aloam_tpu_torch.ops import _build

launches = 0    # kernel launches since the last reset
s_launches = 0  # those of them with the s channel

# output lanes of the (B, 12) result
OUT_Q = 0           # 0:4  quaternion (wxyz)
OUT_T = 4           # 4:7  translation
OUT_COST0 = 7
OUT_COST = 8
OUT_NFAC = 9
OUT_CLAMP = 10
OUT_NAN = 11
N_OUT = 12

MAX_CLUSTER = 8  # the portable cluster size on sm_90
# shared memory a block may give its factor slice (of the 227 KB a block
# may use; the kernel's static buffers take ~1.3 KB)
SLICE_BYTES = 200 * 1024


def slices(n: int, cluster: int) -> list[tuple[int, int]]:
    """Rows [start, stop) of each rank's slice of n rows, as
    ``csrc/lm.cu:slice_of`` cuts them: ceil(n / cluster) a rank, the last
    ones short or empty."""
    per = -(-n // cluster)
    return [(min(n, r * per), min(n, r * per + per)) for r in range(cluster)]


def _slice_bytes(ne: int, np_: int, cluster: int, has_s: bool = False) -> int:
    """Shared memory of one block's slice: 10 (11 with s) floats an edge
    row and 8 (9) a plane row, as ``csrc/lm.cu`` copies them."""
    return 4 * ((10 + has_s) * -(-ne // cluster)
                + (8 + has_s) * -(-np_ // cluster))


def launch_plan(bsz: int, ne: int, np_: int, n_sm: int,
                has_s: bool = False) -> int:
    """The cluster size of a launch: as many blocks a stream as keep all
    blocks within three quarters of the SMs (8 up to B = 12 on 132 SMs, 6
    at B = 16, 3 at B = 32, 1 from B = 3/4 n_sm on), raised until a
    block's slice fits its shared memory. A cluster's blocks must share a
    GPC: 16 clusters of 8 on a 132-SM H100 do not all fit one block to an
    SM, and ran 11% slower than 16 clusters of 6 (PERF.md §6). Raises
    ValueError when even 8 blocks cannot hold a stream's factors."""
    cluster = max(1, min(MAX_CLUSTER, 3 * n_sm // 4 // max(bsz, 1)))
    while _slice_bytes(ne, np_, cluster, has_s) > SLICE_BYTES \
            and cluster < MAX_CLUSTER:
        cluster += 1
    if _slice_bytes(ne, np_, cluster, has_s) > SLICE_BYTES:
        raise ValueError(f"lm_fused: {ne} edge and {np_} plane factors a "
                         f"stream exceed {MAX_CLUSTER} blocks' shared memory")
    return cluster


def _s_channel(f) -> list[torch.Tensor]:
    return [] if f.s is None else [f.s[:, None]]


def pack_edge_channels(edges) -> torch.Tensor:
    """EdgeFactors with (B, N, ·) leaves -> (B, 10, N) planar channels, or
    (B, 11, N) with the time fractions last."""
    return torch.cat([edges.p.transpose(1, 2), edges.a.transpose(1, 2),
                      edges.b.transpose(1, 2),
                      edges.mask.to(torch.float32)[:, None],
                      *_s_channel(edges)], dim=1)


def pack_plane_channels(planes) -> torch.Tensor:
    """PlaneFactors with (B, N, ·) leaves -> (B, 8, N) planar channels, or
    (B, 9, N) with the time fractions last."""
    return torch.cat([planes.p.transpose(1, 2), planes.n.transpose(1, 2),
                      planes.d[:, None],
                      planes.mask.to(torch.float32)[:, None],
                      *_s_channel(planes)], dim=1)


def _has_s(ef, pf, pose) -> bool:
    """Whether the factors carry the s channel; raises on shapes the solve
    does not take."""
    bsz = ef.shape[0]
    if ef.dim() != 3 or pf.dim() != 3 or pf.shape[0] != bsz \
            or (ef.shape[1], pf.shape[1]) not in ((10, 8), (11, 9)) \
            or tuple(pose.shape) != (bsz, 8):
        raise ValueError(f"lm_fused: ef {tuple(ef.shape)}, pf "
                         f"{tuple(pf.shape)}, pose {tuple(pose.shape)}; "
                         f"expected (B, 10, Ne) and (B, 8, Np), or (B, 11, "
                         f"Ne) and (B, 9, Np) with time fractions")
    return ef.shape[1] == 11


def lm_fused_plain(ef, pf, pose, n_iters: int, delta: float,
                   lam0: float = 1e-4) -> torch.Tensor:
    """Plain PyTorch version of :func:`lm_fused`."""
    from aloam_tpu_torch import solver
    has_s = _has_s(ef, pf, pose)
    edges = solver.EdgeFactors(p=ef[:, 0:3].transpose(1, 2),
                               a=ef[:, 3:6].transpose(1, 2),
                               b=ef[:, 6:9].transpose(1, 2),
                               mask=ef[:, 9] > 0.5,
                               s=ef[:, 10] if has_s else None)
    planes = solver.PlaneFactors(p=pf[:, 0:3].transpose(1, 2),
                                 n=pf[:, 3:6].transpose(1, 2),
                                 d=pf[:, 6], mask=pf[:, 7] > 0.5,
                                 s=pf[:, 8] if has_s else None)
    q, t, st = solver.lm_solve((edges, planes), pose[:, 0:4], pose[:, 4:7],
                               n_iters, delta, lam0)
    return torch.cat([q, t, st.cost0[:, None], st.cost[:, None],
                      torch.stack([st.n_factors, st.clamped, st.nonfinite],
                                  dim=1).to(torch.float32)], dim=1)


def lm_fused(ef: torch.Tensor, pf: torch.Tensor, pose: torch.Tensor,
             n_iters: int, delta: float, lam0: float = 1e-4) -> torch.Tensor:
    """ef (B, 10, Ne), pf (B, 8, Np) (or (B, 11, Ne), (B, 9, Np) with the
    time fractions), pose (B, 8) [qw qx qy qz tx ty tz 0], all f32. Returns
    (B, 12) f32 per the OUT_* lanes. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    has_s = _has_s(ef, pf, pose)
    if all(t.device.type == "cpu" for t in (ef, pf, pose)):
        return lm_fused_plain(ef, pf, pose, n_iters, delta, lam0)
    _build.require_cuda("lm_fused", ef, pf, pose, dtypes=(torch.float32,) * 3)
    bsz, ne, np_ = ef.shape[0], ef.shape[2], pf.shape[2]
    cluster = launch_plan(bsz, ne, np_, _build.sm_count(ef.device), has_s)
    out = torch.empty((bsz, N_OUT), dtype=torch.float32, device=ef.device)
    _build.launch("aloam_lm_solve", ef.device, ef.data_ptr(), pf.data_ptr(),
                  pose.data_ptr(), out.data_ptr(), bsz, ne, np_,
                  int(n_iters), float(delta), float(lam0), cluster,
                  int(has_s))
    global launches, s_launches
    launches += 1
    s_launches += has_s
    return out
