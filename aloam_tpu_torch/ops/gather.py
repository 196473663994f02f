"""Batched row gather, ``bgather`` (kernel module).

Replaces no ``pallas_call``: the JAX package leaves this gather to XLA
(``aloam_tpu/utils/batch.py:bgather``). The CUDA kernel is
``csrc/gather.cu``: one flat grid-stride loop over every stream's output
rows, one thread per vector of 16 bytes (or 8 or 4: the widest the
row's bytes, its addresses and strides allow), the stream's row offset
added in the kernel, rows read in place from a strided view. It is bound
by bytes (each row read and written once, plus its index); the library's
advanced indexing it replaces launches one block per row. The plain
version beside it is that indexing, one flat gather with per-stream
offsets, which is what a CPU tensor gets. Both copy bits, so they agree
bit for bit.
"""

from __future__ import annotations

import math

import torch

from aloam_tpu_torch.ops import _build

launches = 0  # kernel launches since the last reset

_THREADS = 256      # threads per block (csrc/gather.cu)
_BLOCKS_PER_SM = 8  # a full SM of 256-thread blocks
_MAX_VECTORS = 2**31 - 1  # the kernel counts vectors in 32 bits


def bgather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bgather`."""
    b, n = x.shape[0], x.shape[1]
    flat = x.reshape((b * n,) + tuple(x.shape[2:]))
    off = torch.arange(b, device=idx.device, dtype=torch.int64) * n
    gidx = idx.to(torch.int64) + off.reshape((b,) + (1,) * (idx.dim() - 1))
    return flat[gidx.reshape(-1)].reshape(tuple(idx.shape)
                                          + tuple(x.shape[2:]))


def vector_bytes(row_bytes: int, *offsets: int) -> int:
    """The widest vector (16, 8 or 4 bytes) that divides a row's bytes and
    every byte offset given (base addresses, strides); rows that are not
    whole 4-byte words raise."""
    for width in (16, 8, 4):
        if all(o % width == 0 for o in (row_bytes, *offsets)):
            return width
    raise ValueError(f"bgather: rows of {row_bytes} bytes at offsets "
                     f"{offsets}: the kernel moves whole 4-byte words")


def launch_plan(total: int, n_sm: int) -> int:
    """Blocks of a launch over ``total`` vectors: one vector a thread up to
    a full SM of blocks on every SM, the grid-stride loop past that."""
    return max(1, min(-(-total // _THREADS), _BLOCKS_PER_SM * n_sm))


def _rows_contiguous(x: torch.Tensor) -> bool:
    """Whether each (b, i) row of x (its dims past the second) lies in
    one contiguous run of memory."""
    want = 1
    for size, stride in zip(reversed(x.shape[2:]), reversed(x.stride()[2:])):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def bgather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: (B, N, ...); idx: (B, ...) integer in [0, N). Returns
    (B, *idx.shape[1:], *x.shape[2:]), a new contiguous tensor. CPU
    tensors take the plain version; CUDA tensors (idx int32 or int64, rows
    of whole 4-byte words) launch the kernel, which reads x in place
    wherever each row is contiguous, whatever x's stream and row
    strides."""
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return bgather_plain(x, idx)
    if not x.is_cuda or idx.device != x.device:
        raise ValueError(f"bgather: expected CUDA tensors on one device, "
                         f"got {x.device} and {idx.device}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"bgather: expected int32 or int64 indices, got "
                         f"{idx.dtype}")
    if x.dim() < 2 or idx.dim() < 1 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"bgather: x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}")
    if not _rows_contiguous(x):
        x = x.contiguous()
    idx = idx.contiguous()
    b, n = x.shape[0], x.shape[1]
    out = torch.empty(tuple(idx.shape) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    es = x.element_size()
    row_bytes = math.prod(x.shape[2:]) * es
    stride_b, stride_n = x.stride(0) * es, x.stride(1) * es
    width = vector_bytes(row_bytes, x.data_ptr(), out.data_ptr(),
                         stride_b if b > 1 else 0, stride_n if n > 1 else 0)
    vpr = row_bytes // width
    total = idx.numel() * vpr
    if total > _MAX_VECTORS:
        raise ValueError(f"bgather: {total} vectors of {width} bytes, past "
                         f"the kernel's {_MAX_VECTORS}")
    global launches
    launches += 1
    _build.launch("aloam_gather_rows", x.device, x.data_ptr(),
                  idx.data_ptr(), out.data_ptr(),
                  int(idx.dtype == torch.int64), width, total,
                  idx.numel() // b, vpr, n, stride_b, stride_n,
                  launch_plan(total, _build.sm_count(x.device)))
    return out
