"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All sources under ``aloam_tpu_torch/csrc/`` compile into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds): one ``nvcc -c`` per ``.cu`` source, all started together, then
one link. The library lands in ``aloam_tpu_torch/_build/`` under a name
keyed on a hash of the sources, the shared ``.cuh`` headers and the
flags, so an edited source or header rebuilds.
``-fmad=false`` keeps every multiply and add rounded on its own, as the
kernels' plain PyTorch versions round them, so a kernel and its plain
version can agree bit for bit.
The build runs at first use, never at import: importing the package needs
no CUDA toolkit, and the CPU paths never build anything.

Every C entry point takes device pointers and a ``cudaStream_t`` and
returns the ``cudaError_t`` of its launch; :func:`check` turns a non-zero
code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

# C signatures: (name, argument types); every function returns int
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "aloam_seg_scan": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "aloam_select_rings": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                           _P),
    "aloam_odom_window": (_P,) * 7 + (_I, _I, _I, _F, _I, _I, _I, _I, _I,
                                      _P),
    "aloam_lm_solve": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    "aloam_assoc_cell": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                         _F, _P),
    "aloam_merge_tiles": (_P,) * 17 + (_I, _I, _I, _I, _F, _F, _P),
    "aloam_knn_select": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (on PATH or /usr/local/cuda)")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libaloam_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    procs = []
    try:
        for cmd in jobs:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        for cmd, proc in zip(jobs, procs):
            _, err = proc.communicate()
            _check(cmd, proc.returncode, err)
        tmp = out.with_name(f"{tag}.tmp")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        _check(link, proc.returncode, proc.stderr)
        os.replace(tmp, out)  # atomic: a loader never sees half a file
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def _check(cmd: list[str], returncode: int, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{stderr}")


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.aloam_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aloam_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().aloam_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require_cuda(name: str, *tensors, dtypes) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    with the matching dtype."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes, strict=True):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on {dev}, got "
                             f"{t.device}")
        if t.dtype != dt:
            raise ValueError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (launch plans size their
    grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(c_name: str, device: torch.device, *args) -> None:
    """Call a kernel's C entry point on ``device``'s current stream (the
    stream is appended as the last argument) and raise on a launch
    error."""
    fn = getattr(library(), c_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, c_name)
