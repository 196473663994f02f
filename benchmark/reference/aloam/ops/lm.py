"""One-launch Levenberg-Marquardt solve (kernel module; here the frozen plain
copy: the CUDA kernel named below is not part of it, and every entry point
runs the plain version on any device).

Port of ``aloam_tpu/ops/pallas_lm.py:lm_fused``. The CUDA kernel is
``csrc/lm.cu``: one thread block cluster per stream runs every sweep, each
block over its own slice of the factor rows held in shared memory; the
blocks exchange their sums through distributed shared memory, and each
solves the 6x6, retracts and decides on the same sums. The plain
version beside it unpacks the channels and runs ``solver.lm_solve``, the
batched PyTorch form of the same solve with ``torch.linalg.solve_ex``.

Factor channels are planar, (B, 10, Ne) edges [px py pz ax ay az bx by bz
mask] and (B, 8, Np) planes [px py pz nx ny nz d mask]; any Ne, Np.
"""

from __future__ import annotations

import torch


# output lanes of the (B, 12) result
OUT_Q = 0           # 0:4  quaternion (wxyz)
OUT_T = 4           # 4:7  translation
OUT_COST0 = 7
OUT_COST = 8
OUT_NFAC = 9
OUT_CLAMP = 10
OUT_NAN = 11
N_OUT = 12


def pack_edge_channels(edges) -> torch.Tensor:
    """EdgeFactors with (B, N, ·) leaves -> (B, 10, N) planar channels."""
    return torch.cat([edges.p.transpose(1, 2), edges.a.transpose(1, 2),
                      edges.b.transpose(1, 2),
                      edges.mask.to(torch.float32)[:, None]], dim=1)


def pack_plane_channels(planes) -> torch.Tensor:
    """PlaneFactors with (B, N, ·) leaves -> (B, 8, N) planar channels."""
    return torch.cat([planes.p.transpose(1, 2), planes.n.transpose(1, 2),
                      planes.d[:, None],
                      planes.mask.to(torch.float32)[:, None]], dim=1)


def _check(ef, pf, pose) -> None:
    """Raises on shapes the solve does not take."""
    bsz = ef.shape[0]
    if ef.dim() != 3 or pf.dim() != 3 or pf.shape[0] != bsz \
            or (ef.shape[1], pf.shape[1]) != (10, 8) \
            or tuple(pose.shape) != (bsz, 8):
        raise ValueError(f"lm_fused: ef {tuple(ef.shape)}, pf "
                         f"{tuple(pf.shape)}, pose {tuple(pose.shape)}; "
                         f"expected (B, 10, Ne) and (B, 8, Np)")


def lm_fused_plain(ef, pf, pose, n_iters: int, delta: float,
                   lam0: float = 1e-4) -> torch.Tensor:
    """Plain PyTorch version of :func:`lm_fused`."""
    from benchmark.reference.aloam import solver
    _check(ef, pf, pose)
    edges = solver.EdgeFactors(p=ef[:, 0:3].transpose(1, 2),
                               a=ef[:, 3:6].transpose(1, 2),
                               b=ef[:, 6:9].transpose(1, 2),
                               mask=ef[:, 9] > 0.5)
    planes = solver.PlaneFactors(p=pf[:, 0:3].transpose(1, 2),
                                 n=pf[:, 3:6].transpose(1, 2),
                                 d=pf[:, 6], mask=pf[:, 7] > 0.5)
    q, t, st = solver.lm_solve((edges, planes), pose[:, 0:4], pose[:, 4:7],
                               n_iters, delta, lam0)
    return torch.cat([q, t, st.cost0[:, None], st.cost[:, None],
                      torch.stack([st.n_factors, st.clamped, st.nonfinite],
                                  dim=1).to(torch.float32)], dim=1)


def lm_fused(ef: torch.Tensor, pf: torch.Tensor, pose: torch.Tensor,
             n_iters: int, delta: float, lam0: float = 1e-4) -> torch.Tensor:
    """ef (B, 10, Ne), pf (B, 8, Np), pose (B, 8) [qw qx qy qz tx ty tz 0],
    all f32. Returns (B, 12) f32 per the OUT_* lanes."""
    return lm_fused_plain(ef, pf, pose, n_iters, delta, lam0)

