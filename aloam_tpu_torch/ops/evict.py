"""Rolling-window discard and local-map census of a map table (kernel
module).

Replaces no ``pallas_call``: the JAX package leaves this pass to XLA
(``aloam_tpu/ops/gridmap.py:evict_and_count``). The CUDA kernel is
``csrc/evict.cu``: blocks on grid.y take a stream each, a grid-stride
loop reads each slot's cx plane as vectors of 16 bytes (or 8 or 4: the
widest Bk and the table's address allow), reads cy and cz only where a
vector holds a live slot, writes only the slots it clears, and sums the
counts with a warp reduction and one atomic add per block. It is bound by
bytes: the three cell planes read once, where the plain version beside it,
:func:`evict_and_count_plain` (the port's PyTorch passes, as
``gridmap.evict_and_count`` ran them), rewrites every plane of both whole
tables. Counts are integers, so the order of the atomic adds does not
matter: the two agree bit for bit, tables and counts.
"""

from __future__ import annotations

import torch

from aloam_tpu_torch.ops import _build
from aloam_tpu_torch.ops import gather as gather_op

launches = 0  # kernel launches since the last reset

_THREADS = 256      # threads per block (csrc/evict.cu)
_BLOCKS_PER_SM = 4  # resident 256-thread blocks an SM (csrc/evict.cu)
_MAX_STREAMS = 65535      # grid.y
_MAX_SLOTS = 2**31 - 1    # the kernel counts a stream's slots in 32 bits


def evict_and_count_plain(pts: torch.Tensor, aux: torch.Tensor,
                          center: torch.Tensor, window_half: torch.Tensor,
                          local_half: torch.Tensor, evict: bool = True):
    """Plain PyTorch version of :func:`evict_and_count`."""
    from aloam_tpu_torch.ops.gridmap import _EMPTY, GridMap, _clear
    grid = GridMap(pts=pts, aux=aux)
    c = grid._auxv()[:, :, 1:4, :]                     # (B, H, 3, Bk)
    live = c[:, :, 0, :] != _EMPTY
    d = (c - center[:, None, :, None]).abs()
    near = live & (d <= local_half[None, None, :, None]).all(dim=2)
    if not evict:
        n_near = near.sum(dim=(1, 2))
        return torch.stack([torch.zeros_like(n_near), n_near])
    out = live & (d > window_half[None, None, :, None]).any(dim=2)
    n_near = (near & ~out).sum(dim=(1, 2))
    n_out = out.sum(dim=(1, 2))
    _clear(grid, out)
    return torch.stack([n_out, n_near])


def vector_bytes(bk: int, address: int) -> int:
    """The widest vector (16, 8 or 4 bytes) of a cell plane's slots: it
    divides a plane's 4·Bk bytes and the table's address (every plane of
    every row starts a multiple of 4·Bk bytes past it)."""
    return gather_op.vector_bytes(4 * bk, address)


def launch_plan(streams: int, vectors: int, n_sm: int) -> int:
    """Blocks a stream of ``vectors`` cx vectors gets: one vector a thread,
    up to an equal share of the blocks resident at once on the card,
    rounded down so that none waits for a second wave (one block a stream
    at least); the grid-stride loop covers the rest."""
    return max(1, min(-(-vectors // _THREADS),
                      _BLOCKS_PER_SM * n_sm // streams))


def _check(pts, aux, center, window_half, local_half) -> None:
    bsz, rows, bk = (*aux.shape[:2], aux.shape[2] // 5) if aux.dim() == 3 \
        else (-1, -1, 0)
    want = [(pts, torch.float32, (bsz, rows, 3 * bk)),
            (aux, torch.int32, (bsz, rows, 5 * bk)),
            (center, torch.int32, (bsz, 3)),
            (window_half, torch.int32, (3,)),
            (local_half, torch.int32, (3,))]
    if bk < 1 or any(t.dtype != dt or tuple(t.shape) != shape
                     for t, dt, shape in want):
        raise ValueError(
            "evict_and_count: expected pts (B, H, 3·Bk) f32, aux (B, H, "
            "5·Bk) i32, center (B, 3) and halves (3,) i32, got "
            + ", ".join(f"{tuple(t.shape)} {t.dtype}" for t, _, _ in want))


def evict_and_count(pts: torch.Tensor, aux: torch.Tensor,
                    center: torch.Tensor, window_half: torch.Tensor,
                    local_half: torch.Tensor, evict: bool = True):
    """Clear, in place, every live slot of a map table outside center ±
    window_half, and count the live slots within center ± local_half after
    the clear; with ``evict`` False clear nothing and count every live slot
    within center ± local_half.

    pts (B, H, 3·Bk) f32 and aux (B, H, 5·Bk) i32, a GridMap's planes;
    center (B, 3) i32 pose cells; window_half and local_half (3,) i32.
    Returns (2, B) int64: row 0 the slots cleared (zeros without
    ``evict``), row 1 the live slots near the pose. CPU tensors take the
    plain version; CUDA tensors, contiguous on one device, launch the
    kernel (B <= 65535, H·Bk < 2**31)."""
    _check(pts, aux, center, window_half, local_half)
    args = (pts, aux, center, window_half, local_half)
    if all(t.device.type == "cpu" for t in args):
        return evict_and_count_plain(*args, evict)
    _build.require_cuda("evict_and_count", *args,
                        dtypes=(torch.float32,) + (torch.int32,) * 4)
    bsz, rows = aux.shape[:2]
    bk = aux.shape[-1] // 5
    if bsz > _MAX_STREAMS or rows * bk > _MAX_SLOTS:
        raise ValueError(f"evict_and_count: {bsz} streams of {rows} x {bk} "
                         f"slots, past the kernel's {_MAX_STREAMS} streams "
                         f"and {_MAX_SLOTS} slots a stream")
    counts = torch.empty((2, bsz), dtype=torch.int64, device=aux.device)
    width = vector_bytes(bk, aux.data_ptr())
    blocks = launch_plan(max(bsz, 1), rows * bk * 4 // width,
                         _build.sm_count(aux.device))
    global launches
    launches += 1
    _build.launch("aloam_evict_count", aux.device,
                  *(t.data_ptr() for t in args), counts.data_ptr(), bsz,
                  rows, bk, int(evict), width, blocks)
    return counts
