"""ctypes bindings for the native host library (``native/spt_native.cpp``).

The counterpart of ``spt_tpu.io.native``: the host work that is serial,
the Radiance RGBE scanline decode (the stbi_loadf role, Cubemap.cpp:18-46)
and the median-split cluster build (the rtcCommitScene role,
EmbreeBackend.cpp:181), runs in C++ when ``g++`` can build the shared
source.  The library is built at first use into
``build/spt_tpu_torch/native/<hash of the source>/`` (the committed
``native/`` directory is only read).  Where ``g++`` is missing or the build
fails, every entry point returns None and its caller takes the numpy path,
which gives the same result bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "spt_native.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build" / "spt_tpu_torch"
              / "native")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build(lib_path: Path) -> bool:
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        return False
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([cxx, "-O3", "-std=c++17", "-fPIC", "-shared",
                        str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, lib_path)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None if it cannot be."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if not SOURCE.exists():
            return None
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        lib_path = BUILD_ROOT / digest / "libspt_native.so"
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        f, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
        lib.spt_rgbe_decode.restype = ctypes.c_int
        lib.spt_rgbe_decode.argtypes = [ctypes.POINTER(ctypes.c_uint8), i64,
                                        ctypes.c_int, ctypes.c_int, f]
        lib.spt_split_build.restype = ctypes.c_int
        lib.spt_split_build.argtypes = [f, f, f, i64, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int64), f, f]
        _LIB = lib
        return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def rgbe_decode(payload: bytes, width: int, height: int) -> Optional[np.ndarray]:
    """Native RGBE decode of the pixel payload -> (H, W, 3) float32, or None
    to take the numpy decode."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(payload, np.uint8)
    out = np.empty((height, width, 3), np.float32)
    rc = lib.spt_rgbe_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.size), width, height, _fptr(out))
    if rc != 0:
        raise ValueError(f"spt_rgbe_decode failed: {rc}")
    return out


def cluster_build(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                  cluster_size: int):
    """Native median-split cluster build (spt_split_build): the triangle
    order and the cluster AABBs of ``ops/bvh``'s numpy build, bit for bit.
    The inputs are padded to a multiple of cluster_size.  Returns (order
    (N,) int64, lo (C, 3), hi (C, 3)) float32, or None to take the numpy
    build."""
    lib = load()
    if lib is None:
        return None
    n = v0.shape[0]
    if n % cluster_size:
        raise ValueError(f"{n} triangles are not a multiple of the cluster "
                         f"size {cluster_size}")
    v0, e1, e2 = (np.ascontiguousarray(a, np.float32).reshape(n, 3)
                  for a in (v0, e1, e2))
    order = np.empty(n, np.int64)
    c = n // cluster_size
    lo = np.empty((c, 3), np.float32)
    hi = np.empty((c, 3), np.float32)
    rc = lib.spt_split_build(
        _fptr(v0), _fptr(e1), _fptr(e2), ctypes.c_int64(n), cluster_size,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _fptr(lo), _fptr(hi))
    if rc != 0:
        raise ValueError(f"native cluster build failed: {rc}")
    return order, lo, hi
