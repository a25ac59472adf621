"""Build and load the port's CUDA kernels (``csrc/*.cu``) with nvcc + ctypes.

Every source compiles to an object in its own nvcc process, all started
together, and the objects link into one shared library under
``build/spt_tpu_torch/<hash of flags and sources>/``; a second build of the
same sources loads the cached library.  Each C entry point returns the CUDA
error of its launch, which ``check`` turns into an exception: there is no
fallback.  Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused_frame.cu", "fused_bounce.cu", "cluster_trace.cu",
           "inst_trace.cu", "stream_trace.cu", "sort_chunks.cu",
           "env_sample.cu")
HEADERS = ("spt_common.cuh", "spt_tracers.cuh", "spt_trace_io.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "spt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

# The mesh forms' per-warp staging buffers (csrc/spt_common.cuh): kWarps 4
# warps a block, each kStageRows 64 rows x kMtCols 9 floats and a lock word.
STAGE_BYTES = 4 * (64 * 9 * 4 + 4)

# Filled by build(): seconds per source (0 when the cached library loaded)
# and the ptxas report (registers, spill stores and loads per kernel).
BUILD_SECONDS: dict = {}
PTXAS_LOG = ""

_LIB = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return path


def _compile(out_dir: Path, lib_path: Path) -> None:
    global PTXAS_LOG
    exe = nvcc()
    procs = []
    for name in SOURCES:
        obj = out_dir / f"{Path(name).stem}.{os.getpid()}.o"
        cmd = [exe, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
        procs.append((name, obj, cmd, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for name, obj, cmd, t0, proc in procs:
        out, err = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        logs.append(f"== {name}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                          f"{out}{err}")
    PTXAS_LOG = "".join(logs)
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f"libspt_kernels.{os.getpid()}.tmp.so"
    cmd = [exe, "-shared", "-o", str(tmp), *(str(p[1]) for p in procs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    for p in procs:
        p[1].unlink(missing_ok=True)


def build() -> ctypes.CDLL:
    """Compile csrc (once per source hash) and load it.  Raises on a failed
    build."""
    global _LIB
    if _LIB is not None:
        return _LIB
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libspt_kernels.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        _compile(out_dir, lib_path)
    else:
        BUILD_SECONDS.update({name: 0.0 for name in SOURCES})
    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # tables, n_tris, n_sphs, n_mats, n_lights, n_emit, flags, pack,
    # pack_w, n_clusters, cluster_size, n_inst, n_meshes, tex, tex_res,
    # cbox, corder
    scene = [p, i, i, i, i, i, i, p, i, i, i, i, i, p, i, p, p]
    lib.spt_fused_frame.argtypes = [p] * 26 + scene + [i] * 4 + [f] * 3 + [p]
    lib.spt_small_frame.argtypes = lib.spt_fused_frame.argtypes
    lib.spt_fused_bounce.argtypes = [p] * 31 + scene + [i] * 4 + [f] * 3 + [p]
    # tables, n_sphs, pack, pack_w, n_clusters, cluster_size, n_inst,
    # n_meshes, n, tmin, stream
    trace = [i, p] + [i] * 6 + [f, p]
    for fn in ("spt_closest_hit", "spt_inst_closest_hit"):
        getattr(lib, fn).argtypes = [p] * 16 + trace
    for fn in ("spt_any_hit", "spt_inst_any_hit"):
        getattr(lib, fn).argtypes = [p] * 9 + trace
    # the stream tracer: tables, n_sphs, pack, pack_w, n_supers,
    # cluster_size, cbox, corder, n, tmin, stream
    stream = [i, p, i, i, i, p, p, i, f, p]
    lib.spt_stream_closest_hit.argtypes = [p] * 16 + stream
    lib.spt_stream_any_hit.argtypes = [p] * 9 + stream
    # dx, dy, dz, need, map, h, w, max_clamp, intensity, out rgb, n, stream
    lib.spt_env_sample.argtypes = [p] * 5 + [i, i, f, f] + [p] * 3 + [i, p]
    lib.spt_sort_chunks.argtypes = [p] * 6 + [i, i, i, p]
    # form, dynamic shared bytes, registers, local bytes, blocks per SM
    for fn in ("spt_fused_frame_kernel_info", "spt_fused_bounce_kernel_info",
               "spt_trace_kernel_info", "spt_inst_trace_kernel_info",
               "spt_stream_trace_kernel_info"):
        getattr(lib, fn).argtypes = [i, i, p, p, p]
    # chunk, cluster, threads, shared bytes, active clusters, registers,
    # local bytes
    lib.spt_sort_kernel_info.argtypes = [i] + [p] * 6
    lib.spt_env_sample_kernel_info.argtypes = [p, p]
    for fn in ("spt_fused_frame", "spt_small_frame", "spt_fused_bounce",
               "spt_closest_hit",
               "spt_any_hit", "spt_inst_closest_hit", "spt_inst_any_hit",
               "spt_stream_closest_hit", "spt_stream_any_hit",
               "spt_sort_chunks", "spt_env_sample",
               "spt_fused_frame_kernel_info", "spt_fused_bounce_kernel_info",
               "spt_trace_kernel_info", "spt_inst_trace_kernel_info",
               "spt_stream_trace_kernel_info", "spt_sort_kernel_info",
               "spt_env_sample_kernel_info"):
        getattr(lib, fn).restype = i
    lib.spt_cuda_error_string.argtypes = [i]
    lib.spt_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = build().spt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def shared_bytes(table_bytes: int, mesh: bool) -> int:
    """Dynamic shared memory of a block whose tables and visit orders take
    `table_bytes` (csrc/spt_common.cuh smem_bytes): in a mesh form the
    staging buffers of its warps follow at the next 16-byte boundary."""
    if not mesh:
        return table_bytes
    return (table_bytes + 15) // 16 * 16 + STAGE_BYTES


def sort_kernel_info(chunk: int) -> dict:
    """The sort kernel's launch shape at `chunk` (blocks per cluster,
    threads and dynamic shared bytes a block), the clusters of that shape
    the current device holds at once, and its registers per thread and
    local (spill) bytes."""
    vals = [ctypes.c_int(0) for _ in range(6)]
    err = build().spt_sort_kernel_info(chunk,
                                       *(ctypes.addressof(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"kernel info of sort_chunks at chunk {chunk} "
                           f"failed: CUDA error {err}")
    return dict(zip(("cluster", "threads", "smem_bytes", "active_clusters",
                     "registers", "local_bytes"), (v.value for v in vals)))


def kernel_info(smem: dict | None = None, sort_chunk: int = 32768) -> dict:
    """Registers per thread and local (spill) bytes of every kernel; for the
    kernels named in `smem` (name -> dynamic shared bytes of a launch) also
    those bytes and the blocks an SM holds at once with them; for the sort,
    its launch shape and active clusters at `sort_chunk`
    (``sort_kernel_info``)."""
    lib = build()
    smem = smem or {}
    out = {}
    modes = (
        ("fused_frame", lib.spt_fused_frame_kernel_info, 0),
        ("fused_frame_resident", lib.spt_fused_frame_kernel_info, 1),
        ("fused_frame_instanced", lib.spt_fused_frame_kernel_info, 2),
        ("fused_frame_stream", lib.spt_fused_frame_kernel_info, 3),
        ("fused_bounce", lib.spt_fused_bounce_kernel_info, 0),
        ("fused_bounce_resident", lib.spt_fused_bounce_kernel_info, 1),
        ("fused_bounce_instanced", lib.spt_fused_bounce_kernel_info, 2),
        ("fused_bounce_stream", lib.spt_fused_bounce_kernel_info, 3),
        ("closest_hit", lib.spt_trace_kernel_info, 0),
        ("any_hit", lib.spt_trace_kernel_info, 1),
        ("closest_hit_inst", lib.spt_inst_trace_kernel_info, 0),
        ("any_hit_inst", lib.spt_inst_trace_kernel_info, 1),
        ("closest_hit_stream", lib.spt_stream_trace_kernel_info, 0),
        ("any_hit_stream", lib.spt_stream_trace_kernel_info, 1))
    for name, fn, mode in modes:
        regs, local, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        err = fn(mode, smem.get(name, 0), ctypes.addressof(regs),
                 ctypes.addressof(local), ctypes.addressof(blocks))
        if err != 0:
            raise RuntimeError(f"kernel info of {name} failed: CUDA error {err}")
        out[name] = {"registers": regs.value, "local_bytes": local.value}
        if name in smem:
            out[name].update(smem_bytes=smem[name], blocks_per_sm=blocks.value)
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.spt_env_sample_kernel_info(ctypes.addressof(regs),
                                         ctypes.addressof(local))
    if err != 0:
        raise RuntimeError("cudaFuncGetAttributes(env_sample) failed: "
                           f"CUDA error {err}")
    out["env_sample"] = {"registers": regs.value, "local_bytes": local.value}
    out["sort_chunks"] = dict(sort_kernel_info(sort_chunk), chunk=sort_chunk)
    return out
