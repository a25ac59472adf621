"""The whole-frame wavefront kernel: ``fused_frame`` for Hopper.

The counterpart of ``spt_tpu.ops.pallas_bounce.fused_frame`` in its
small-scene form (accel mode None).  It runs bounces
[start_bounce, max_depth) of one sample — closest hit, emission, direct
light with shadow rays, NEE, and the scatter branches — and returns what the
deferred environment term needs.

- On a CUDA tensor it launches the hand-written kernel in
  ``csrc/fused_frame.cu`` (built with nvcc at first use, bound with ctypes)
  or raises: there is no fallback.
- On a CPU tensor it runs :func:`fused_frame_reference`, the plain PyTorch
  version (``transport.trace_bounce`` + ``transport.shade_core`` in a bounce
  loop).  Nothing on the CUDA path calls it; tests and ``chip_smoke.py``
  hold the kernel against it.

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.integrators import transport
from spt_tpu_torch.lights import DeviceLights
from spt_tpu_torch.ops.vec3 import Vec3
from spt_tpu_torch.scene.flatten import DeviceScene

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0

# Caps of the small-scene form, as pallas_bounce's (MAX_PALLAS_PRIMS,
# MAX_PALLAS_MATERIALS, MAX_PALLAS_EMITTERS); the tables must also fit the
# 48 KiB of shared memory a block gets without opting in.
MAX_PRIMS = 192
MAX_MATERIALS = 64
MAX_EMITTERS = 32
MAX_TABLE_BYTES = 48 * 1024

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("fused_frame.cu",)
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "spt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false")

# Words per table row, as the k*Words constants in csrc/fused_frame.cu.
_TRI, _SPH, _MAT, _LIGHT, _EMIT, _NS = 10, 5, 11, 11, 13, 9

# RenderConfig toggles, as the k* flag bits in csrc/fused_frame.cu.
_NEE, _SHADOW_RAYS, _METAL_VNDF, _METAL_MIRROR = 1, 2, 4, 8
_CPU_TRANSPARENCY, _NORMAL_VIS, _DIRECT_DIELECTRIC, _HAS_NS = 16, 32, 64, 128

_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "fused_frame kernel cannot be built")
    return path


def build() -> ctypes.CDLL:
    """Compile ``csrc/fused_frame.cu`` (once per source hash) into
    ``build/spt_tpu_torch/`` and load it.  Raises on a failed build."""
    global _LIB
    if _LIB is not None:
        return _LIB
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libspt_fused_frame.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libspt_fused_frame.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(_CSRC / s) for s in _SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.spt_fused_frame.argtypes = [p] * 27 + [i] * 10 + [f] * 3 + [p]
    lib.spt_fused_frame.restype = i
    lib.spt_fused_frame_kernel_info.argtypes = [p, p]
    lib.spt_fused_frame_kernel_info.restype = i
    lib.spt_cuda_error_string.argtypes = [i]
    lib.spt_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def kernel_info() -> dict:
    """Registers per thread and spill bytes of the built kernel."""
    lib = build()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.spt_fused_frame_kernel_info(ctypes.addressof(regs),
                                          ctypes.addressof(local))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return {"registers": regs.value, "local_bytes": local.value}


def _table_words(scene: DeviceScene, lights: DeviceLights, nee_on: bool) -> int:
    e = scene.emitters.count if nee_on else 0
    ns = scene.num_triangles if scene.tri_ns is not None else 0
    return (scene.num_triangles * _TRI + scene.num_spheres * _SPH
            + scene.materials.count * _MAT + lights.count * _LIGHT
            + e * _EMIT + ns * _NS)


def explain_decline(cfg: RenderConfig, scene: DeviceScene,
                    lights: DeviceLights):
    """Why the kernel cannot take this workload, or None when it can."""
    reasons = []
    n_prims = scene.num_triangles + scene.num_spheres
    if n_prims > MAX_PRIMS:
        reasons.append(f"{n_prims} primitives > MAX_PRIMS={MAX_PRIMS}")
    if scene.materials.count > MAX_MATERIALS:
        reasons.append(f"{scene.materials.count} materials > "
                       f"MAX_MATERIALS={MAX_MATERIALS}")
    nee_on = cfg.nee and scene.emitters is not None
    if nee_on and scene.emitters.count > MAX_EMITTERS:
        reasons.append(f"{scene.emitters.count} emitters > "
                       f"MAX_EMITTERS={MAX_EMITTERS}")
    nbytes = 4 * _table_words(scene, lights, nee_on)
    if nbytes > MAX_TABLE_BYTES:
        reasons.append(f"scene tables take {nbytes} B > "
                       f"MAX_TABLE_BYTES={MAX_TABLE_BYTES}")
    return "; ".join(reasons) if reasons else None


def rays_from_counts(bounces_done: torch.Tensor, max_depth: int,
                     start_bounce: int) -> torch.Tensor:
    """Per-bounce live counts from per-lane bounce totals: a lane alive at
    bounce b contributes iff it ran more than b - start_bounce bounces
    (pallas_bounce.py:1314-1321)."""
    zero = torch.zeros((), dtype=torch.int64, device=bounces_done.device)
    return torch.stack([
        (bounces_done > b - start_bounce).sum() if b >= start_bounce else zero
        for b in range(max_depth)])


def fused_frame_reference(cfg: RenderConfig, scene: DeviceScene,
                          lights: DeviceLights, ps, start_bounce: int = 0):
    """The plain PyTorch version of the kernel: the same bounces through
    ``transport.trace_bounce`` and ``transport.shade_core``.  Every bounce
    runs over every lane: dead lanes come back unchanged, so the result is
    the kernel's, and no host sync is needed to stop early."""
    counts = torch.zeros(ps.num_paths, dtype=torch.int32, device=ps.rng.device)
    missed_ever = torch.zeros_like(ps.alive)
    for bounce in range(start_bounce, cfg.max_depth):
        counts = counts + ps.alive.to(torch.int32)
        hit = transport.trace_bounce(scene, ps)
        ps, missed = transport.shade_core(cfg, scene, lights, ps, hit, bounce,
                                          bounce == cfg.max_depth - 1)
        missed_ever = missed_ever | missed
    rays = rays_from_counts(counts, cfg.max_depth, start_bounce)
    return ps.radiance, ps.direction, ps.throughput, missed_ever, rays


def _pack_tables(scene: DeviceScene, lights: DeviceLights, nee_on: bool):
    """The scene, material, light and emitter tables as one float32 buffer
    in the kernel's row layout (int columns stored as their bits)."""
    def col(t):
        return t.to(torch.float32).reshape(-1, 1)

    def bits(t):
        return t.to(torch.int32).contiguous().view(torch.float32).reshape(-1, 1)

    m = scene.materials
    parts = [
        torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2,
                   bits(scene.tri_mat)], 1),
        torch.cat([scene.sph_center, col(scene.sph_radius),
                   bits(scene.sph_mat)], 1),
        torch.cat([m.base_color, col(m.metallic), col(m.roughness),
                   col(m.ior), bits(m.mat_type), m.emission,
                   col(m.transparency)], 1),
        torch.cat([bits(lights.kind), lights.vec, lights.color,
                   col(lights.intensity), lights.attenuation], 1),
    ]
    if nee_on:
        e = scene.emitters
        parts.append(torch.cat([e.v0, e.e1, e.e2, e.le, col(e.area)], 1))
    if scene.tri_ns is not None:
        parts.append(scene.tri_ns)
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def _flags(cfg: RenderConfig, scene: DeviceScene, nee_on: bool) -> int:
    return ((_NEE if nee_on else 0)
            | (_SHADOW_RAYS if cfg.shadow_rays else 0)
            | (_METAL_VNDF if cfg.metal_vndf else 0)
            | (_METAL_MIRROR if cfg.metal_mirror else 0)
            | (_CPU_TRANSPARENCY if cfg.cpu_transparency else 0)
            | (_NORMAL_VIS if cfg.depth_term_normal_vis else 0)
            | (_DIRECT_DIELECTRIC if cfg.direct_light_dielectric else 0)
            | (_HAS_NS if scene.tri_ns is not None else 0))


def _rng_bits(rng: torch.Tensor) -> torch.Tensor:
    """int64-held uint32 words -> their int32 bit pattern."""
    return torch.where(rng >= 2 ** 31, rng - 2 ** 32, rng).to(torch.int32)


def fused_frame(cfg: RenderConfig, scene: DeviceScene, lights: DeviceLights,
                ps, start_bounce: int = 0):
    """Bounces [start_bounce, max_depth) of one sample.

    Returns (radiance Vec3, final_direction Vec3, final_throughput Vec3,
    missed_ever (N,) bool, rays_per_bounce (max_depth,) int64; entries below
    start_bounce are zero).  The caller owes `throughput * env(direction)`
    to missed lanes (the deferred-env contract).
    """
    global LAUNCHES
    device = ps.rng.device
    if device.type == "cpu":
        return fused_frame_reference(cfg, scene, lights, ps, start_bounce)
    if device.type != "cuda":
        raise ValueError(f"fused_frame runs on CUDA or CPU tensors, not {device}")
    reason = explain_decline(cfg, scene, lights)
    if reason:
        raise NotImplementedError(f"the fused_frame kernel cannot take this "
                                  f"scene: {reason}")
    n = ps.num_paths
    planes = [*ps.origin, *ps.direction, *ps.throughput, *ps.radiance]
    for name, t in zip(("origin", "direction", "throughput", "radiance"),
                       (planes[0:3], planes[3:6], planes[6:9], planes[9:12])):
        for c in t:
            if (c.device != device or c.dtype != torch.float32
                    or c.shape != (n,) or not c.is_contiguous()):
                raise ValueError(f"{name} planes must be contiguous float32 "
                                 f"({n},) tensors on {device}")
    for name, t, dt in (("rng", ps.rng, torch.int64),
                        ("alive", ps.alive, torch.bool),
                        ("emission_ok", ps.emission_ok, torch.bool)):
        if t.device != device or t.dtype != dt or t.shape != (n,):
            raise ValueError(f"{name} must be a ({n},) {dt} tensor on {device}")
    if not 0 <= start_bounce <= cfg.max_depth:
        raise ValueError(f"start_bounce {start_bounce} outside "
                         f"[0, {cfg.max_depth}]")

    nee_on = cfg.nee and scene.emitters is not None
    tables = _pack_tables(scene, lights, nee_on)
    rng = _rng_bits(ps.rng)
    alive = ps.alive.to(torch.int32)
    emok = ps.emission_ok.to(torch.int32)
    outs_f = [torch.empty(n, dtype=torch.float32, device=device)
              for _ in range(9)]
    missed = torch.empty(n, dtype=torch.int32, device=device)
    bounces = torch.empty(n, dtype=torch.int32, device=device)

    lib = build()
    e_count = scene.emitters.count if nee_on else 0
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.spt_fused_frame(
            *(t.data_ptr() for t in planes),
            rng.data_ptr(), alive.data_ptr(), emok.data_ptr(),
            *(t.data_ptr() for t in outs_f),
            missed.data_ptr(), bounces.data_ptr(), tables.data_ptr(),
            scene.num_triangles, scene.num_spheres, scene.materials.count,
            lights.count, e_count, n, start_bounce, cfg.max_depth,
            min(cfg.rr_after, 2 ** 31 - 1), _flags(cfg, scene, nee_on),
            cfg.hit_eps, cfg.ray_offset_dir, cfg.firefly_clamp, stream)
    if err != 0:
        raise RuntimeError(f"fused_frame launch failed: CUDA error {err} "
                           f"({lib.spt_cuda_error_string(err).decode()})")
    LAUNCHES += 1

    direction = Vec3(*outs_f[0:3])
    throughput = Vec3(*outs_f[3:6])
    radiance = Vec3(*outs_f[6:9])
    rays = rays_from_counts(bounces, cfg.max_depth, start_bounce)
    return radiance, direction, throughput, missed != 0, rays
