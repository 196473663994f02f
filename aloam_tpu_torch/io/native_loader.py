"""ctypes bindings for the native KITTI loader/prefetcher.

The compute path is PyTorch/CUDA; the IO runtime around it is native C++
(like the reference's kittiHelper node). The shared library is built on
demand with g++ from ``native/kitti_loader.cpp`` into the package's
``_build/`` directory (rebuilt when the source is newer); everything
degrades gracefully to the NumPy loader when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "kitti_loader.cpp")
_LIB = os.path.join(_PKG_DIR, "_build", "libkitti_loader.so")

_lib = None


def _build() -> str:
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", _LIB, _SRC, "-lpthread"],
            check=True, capture_output=True)
    return _LIB


def load_library():
    """Load (building if needed) the native library; raises on failure."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build())
        lib.kl_read_bin.restype = ctypes.c_int
        lib.kl_read_bin.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_float)]
        lib.kl_prefetcher_create.restype = ctypes.c_void_p
        lib.kl_prefetcher_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.kl_prefetcher_next.restype = ctypes.c_int
        lib.kl_prefetcher_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_float)]
        lib.kl_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    try:
        load_library()
        return True
    except Exception:
        return False


def _ptrs(xyz, mask, refl):
    return (xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            refl.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))


def read_bin_padded(path: str, n_pad: int):
    """Native one-shot read -> (xyz (n_pad,3) f32, mask bool, refl f32)."""
    lib = load_library()
    xyz = np.zeros((n_pad, 3), np.float32)
    mask = np.zeros((n_pad,), np.uint8)
    refl = np.zeros((n_pad,), np.float32)
    n = lib.kl_read_bin(path.encode(), n_pad, *_ptrs(xyz, mask, refl))
    if n < 0:
        raise IOError(f"failed to read {path}")
    return xyz, mask.astype(bool), refl


class Prefetcher:
    """Multi-threaded read-ahead over a list of .bin files, emitting padded
    frames in order — the host-side input pipeline feeding the device."""

    def __init__(self, paths: list[str], n_pad: int, depth: int = 4,
                 n_threads: int = 2):
        self._lib = load_library()
        self._n_pad = n_pad
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._n = len(paths)
        self._h = self._lib.kl_prefetcher_create(arr, len(paths), n_pad,
                                                 depth, n_threads)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        xyz = np.zeros((self._n_pad, 3), np.float32)
        mask = np.zeros((self._n_pad,), np.uint8)
        refl = np.zeros((self._n_pad,), np.float32)
        n = self._lib.kl_prefetcher_next(self._h, *_ptrs(xyz, mask, refl))
        if n == -1:
            raise StopIteration
        if n == -2:
            raise IOError("prefetcher read error")
        return xyz, mask.astype(bool), refl

    def close(self):
        if self._h:
            self._lib.kl_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
