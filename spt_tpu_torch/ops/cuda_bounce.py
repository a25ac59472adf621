"""The wavefront kernels for Hopper: ``fused_frame`` and ``fused_bounce``.

The counterparts of ``spt_tpu.ops.pallas_bounce.fused_frame`` (K1) and
``fused_bounce`` (K3) in four accel modes (``_accel_mode``, as
pallas_bounce._accel_mode :161-182): None, the small scenes of at most
``MAX_PRIMS`` primitives traced by brute force; "resident", mesh scenes
whose cluster accel (``ops/bvh``) holds at most ``MAX_ACCEL_TRIS``
triangles, traced by the cluster tracer; "instanced", scenes with an
instanced TLAS/BLAS pair (``ops/bvh.InstAccel``), traced by the instanced
tracer; "stream", cluster accels past ``MAX_ACCEL_TRIS`` of at most
``bvh.MAX_STREAM_CLUSTERS`` clusters, traced by the two-level supercluster
tracer (K8), whose cluster boxes and orders stay in global memory.  Every
mode samples the scene's texture table in-kernel (K6) when
it has one.  ``fused_frame`` runs bounces [start_bounce, max_depth) of one
sample and returns what the deferred environment term needs;
``fused_bounce`` runs one bounce and returns the new path state and the
missed mask.

- On a CUDA tensor each launches its hand-written kernel
  (``csrc/fused_frame.cu``, ``csrc/fused_bounce.cu``, built by
  ``ops/cuda_lib``) or raises: there is no fallback.
- On a CPU tensor each runs its plain PyTorch version
  (``fused_frame_reference``, ``fused_bounce_reference``:
  ``transport.trace_bounce`` + ``transport.shade_core``, tracing through the
  plain versions of the tracers and sampling through
  ``transport.sample_texture_v``).  Nothing on the CUDA path calls them;
  tests and ``chip_smoke.py`` hold the kernels against them.

The small form of fused_frame (``csrc/fused_frame.cu``
``small_frame_kernel``) reads the path state in the dtypes the port keeps
it in and counts the rays per bounce itself; the mesh forms and
fused_bounce take the RNG words and flags as int32.

``LAUNCHES`` counts fused_frame launches and ``BOUNCE_LAUNCHES``
fused_bounce launches, so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import torch

from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.integrators import transport
from spt_tpu_torch.lights import DeviceLights
from spt_tpu_torch.materials import tex_res_of
from spt_tpu_torch.ops import bvh, cuda_lib, cuda_trace
from spt_tpu_torch.ops.vec3 import Vec3
from spt_tpu_torch.scene.flatten import MAX_ACCEL_SPHERES, DeviceScene

# Kernel launches since import (or since a caller reset them).
LAUNCHES = 0
BOUNCE_LAUNCHES = 0

# The small form of fused_frame as a profiler trace names it.
SMALL_KERNEL = "small_frame_kernel"

# Caps, as pallas_bounce's (MAX_PALLAS_PRIMS, MAX_PALLAS_MATERIALS,
# MAX_PALLAS_EMITTERS, MAX_ACCEL_TRIS).  The small form's tables must fit
# the 48 KiB of shared memory a block gets without opting in; the resident
# form's small tables, the 227 KiB it may opt in to.
MAX_PRIMS = 192
MAX_MATERIALS = 64
MAX_EMITTERS = 32
MAX_ACCEL_TRIS = 12288
MAX_TABLE_BYTES = 48 * 1024
MAX_RESIDENT_TABLE_BYTES = 227 * 1024

# Words per table row, as the k*Words constants in csrc/spt_common.cuh;
# the small forms' triangle and sphere rows are padded to 16-byte words
# (kSmallTriWords, kSmallSphWords).
_SPH, _MAT, _LIGHT, _EMIT, _NS, _UV, _BOX, _OKEY = (5, 12, 11, 13, 9, 6, 6, 8)
_SMALL_TRI, _SMALL_SPH = 12, 8

# RenderConfig toggles, as the k* flag bits in csrc/spt_common.cuh.
_NEE, _SHADOW_RAYS, _METAL_VNDF, _METAL_MIRROR = 1, 2, 4, 8
_CPU_TRANSPARENCY, _NORMAL_VIS, _DIRECT_DIELECTRIC, _HAS_NS = 16, 32, 64, 128
_TEXTURED = 256


def _accel_mode(scene: DeviceScene):
    """None (small scene, brute force), "resident" (cluster tracer over the
    accel), "instanced" (the TLAS/BLAS tracer over scene.inst) or "stream"
    (the supercluster tracer over an accel past MAX_ACCEL_TRIS), as
    pallas_bounce._accel_mode (:161-182); raises where that returns None on
    a scene past MAX_PRIMS."""
    if scene.num_triangles + scene.num_spheres <= MAX_PRIMS:
        return None
    if scene.num_spheres > MAX_ACCEL_SPHERES:
        raise NotImplementedError(f"{scene.num_spheres} spheres > "
                                  f"MAX_ACCEL_SPHERES={MAX_ACCEL_SPHERES}")
    if scene.inst is not None:
        return "instanced"
    a = scene.accel
    if a is None:
        raise NotImplementedError(
            f"{scene.num_triangles + scene.num_spheres} primitives > "
            f"MAX_PRIMS={MAX_PRIMS} and no cluster accel built")
    if a.num_clusters * a.cluster_size <= MAX_ACCEL_TRIS:
        return "resident"
    if a.num_clusters > bvh.MAX_STREAM_CLUSTERS:
        raise NotImplementedError(
            f"{a.num_clusters} clusters > "
            f"MAX_STREAM_CLUSTERS={bvh.MAX_STREAM_CLUSTERS}")
    return "stream"


def _clusters(scene: DeviceScene, mode) -> int:
    """Boxes in the kernels' shared tables: the accel's clusters, every
    BLAS's, or in the stream mode the superclusters only."""
    if mode == "resident":
        return scene.accel.num_clusters
    if mode == "instanced":
        return scene.inst.num_meshes * scene.inst.cmax
    if mode == "stream":
        return scene.accel.sup_lo.shape[0]
    return 0


def _table_words(scene: DeviceScene, lights: DeviceLights, nee_on: bool,
                 mode=None) -> int:
    e = scene.emitters.count if nee_on else 0
    words = (scene.materials.count * _MAT + lights.count * _LIGHT + e * _EMIT
             + _clusters(scene, mode) * (_BOX + _OKEY))
    if mode is None:
        ns = scene.num_triangles if scene.tri_ns is not None else 0
        uv = scene.num_triangles if scene.textures is not None else 0
        return (words + scene.num_triangles * _SMALL_TRI
                + scene.num_spheres * _SMALL_SPH + ns * _NS + uv * _UV)
    words += scene.num_spheres * _SPH
    if mode == "instanced":
        return words + scene.inst.num_instances * cuda_trace.INST_WORDS
    return words


def shared_bytes(cfg: RenderConfig, scene: DeviceScene,
                 lights: DeviceLights) -> int:
    """Dynamic shared memory of a fused_frame block on this workload (a
    fused_bounce block takes no more): the tables, the visit orders and, in
    a mesh form, the warps' staging buffers (cuda_lib.shared_bytes); in the
    small form the histogram of bounces run from bounce 0."""
    mode = _accel_mode(scene)
    nee_on = cfg.nee and scene.emitters is not None
    hist = 4 * (cfg.max_depth + 1) if mode is None else 0
    return cuda_lib.shared_bytes(
        4 * _table_words(scene, lights, nee_on, mode)
        + 2 * 8 * _clusters(scene, mode) + hist, mode is not None)


def explain_decline(cfg: RenderConfig, scene: DeviceScene,
                    lights: DeviceLights):
    """Why the kernels cannot take this workload, or None when they can.

    The JAX package's texture gates (pallas_bounce.py:222-228: a textured
    scene needs an accel mode, and the packed table at most
    MAX_TEX_TABLE_BYTES) bound the table in a TPU core's VMEM.  Here the
    table stays in global memory and is read through L2, so neither
    applies: textured scenes take every mode, small ones included."""
    reasons = []
    try:
        mode = _accel_mode(scene)
    except NotImplementedError as e:
        return str(e)
    if scene.materials.count > MAX_MATERIALS:
        reasons.append(f"{scene.materials.count} materials > "
                       f"MAX_MATERIALS={MAX_MATERIALS}")
    nee_on = cfg.nee and scene.emitters is not None
    if nee_on and scene.emitters.count > MAX_EMITTERS:
        reasons.append(f"{scene.emitters.count} emitters > "
                       f"MAX_EMITTERS={MAX_EMITTERS}")
    nbytes = shared_bytes(cfg, scene, lights)
    cap = MAX_TABLE_BYTES if mode is None else MAX_RESIDENT_TABLE_BYTES
    if nbytes > cap:
        reasons.append(f"a block's shared memory (scene tables and staging "
                       f"buffers) takes {nbytes} B > {cap} B")
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
    """The plain PyTorch version of fused_frame: the same bounces through
    fused_bounce_reference.  Every bounce
    runs over every lane: dead lanes come back unchanged, so the result is
    the kernel's, and no host sync is needed to stop early."""
    counts = torch.zeros(ps.num_paths, dtype=torch.int32, device=ps.rng.device)
    missed_ever = torch.zeros_like(ps.alive)
    for bounce in range(start_bounce, cfg.max_depth):
        counts = counts + ps.alive.to(torch.int32)
        ps, missed = fused_bounce_reference(cfg, scene, lights, ps, bounce,
                                            bounce == cfg.max_depth - 1)
        missed_ever = missed_ever | missed
    rays = rays_from_counts(counts, cfg.max_depth, start_bounce)
    return ps.radiance, ps.direction, ps.throughput, missed_ever, rays


def fused_bounce_reference(cfg: RenderConfig, scene: DeviceScene,
                           lights: DeviceLights, ps, bounce: int,
                           is_last: bool):
    """The plain PyTorch version of fused_bounce: one trace_bounce +
    shade_core, tracing through the plain versions of the tracers."""
    hit = transport.trace_bounce(scene, ps, plain=True)
    return transport.shade_core(cfg, scene, lights, ps, hit, bounce, is_last,
                                plain=True)


def _pack_tables(scene: DeviceScene, lights: DeviceLights, nee_on: bool,
                 mode=None):
    """The scene, material, light and emitter tables as one float32 buffer
    in the kernels' row layout (int columns stored as their bits); in the
    small mode the triangle and sphere rows padded to 16-byte words with
    zeros, in the resident mode the cluster boxes and octant keys instead
    of the triangles, in the stream mode the supercluster boxes and keys."""
    def col(t):
        return t.to(torch.float32).reshape(-1, 1)

    def bits(t):
        return t.to(torch.int32).contiguous().view(torch.float32).reshape(-1, 1)

    m = scene.materials
    nt, ns = scene.num_triangles, scene.num_spheres
    sph = [scene.sph_center, col(scene.sph_radius), bits(scene.sph_mat)]
    if mode is None:
        pad = torch.zeros(max(2 * nt, 3 * ns), dtype=torch.float32,
                          device=scene.sph_center.device)
        parts = [torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2,
                            bits(scene.tri_mat), pad[:2 * nt].view(nt, 2)], 1),
                 torch.cat(sph + [pad[:3 * ns].view(ns, 3)], 1)]
    else:
        parts = [torch.cat(sph, 1)]
    parts += [
        torch.cat([m.base_color, col(m.metallic), col(m.roughness),
                   col(m.ior), bits(m.mat_type), m.emission,
                   col(m.transparency), bits(m.tex_id)], 1),
        torch.cat([bits(lights.kind), lights.vec, lights.color,
                   col(lights.intensity), lights.attenuation], 1),
    ]
    if nee_on:
        e = scene.emitters
        parts.append(torch.cat([e.v0, e.e1, e.e2, e.le, col(e.area)], 1))
    if mode == "resident":
        a = scene.accel
        parts += [torch.cat([a.cluster_lo, a.cluster_hi], 1), bits(a.cl_okey)]
    elif mode == "stream":
        a = scene.accel
        parts += [cuda_trace.super_boxes(a), bits(a.sup_okey)]
    elif mode == "instanced":
        ia = scene.inst
        parts += [torch.cat([ia.blas_lo, ia.blas_hi], 2),
                  cuda_trace.inst_rows(ia),
                  bits(cuda_trace.visit_keys(
                      ia.blas_okey.reshape(8 * ia.num_meshes, ia.cmax)))]
    else:
        if scene.tri_ns is not None:
            parts.append(scene.tri_ns)
        if scene.textures is not None:
            parts.append(scene.tri_uv)
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def _flags(cfg: RenderConfig, scene: DeviceScene, nee_on: bool,
           mode=None) -> int:
    has_ns = mode is None and scene.tri_ns is not None
    return ((_NEE if nee_on else 0)
            | (_SHADOW_RAYS if cfg.shadow_rays else 0)
            | (_METAL_VNDF if cfg.metal_vndf else 0)
            | (_METAL_MIRROR if cfg.metal_mirror else 0)
            | (_CPU_TRANSPARENCY if cfg.cpu_transparency else 0)
            | (_NORMAL_VIS if cfg.depth_term_normal_vis else 0)
            | (_DIRECT_DIELECTRIC if cfg.direct_light_dielectric else 0)
            | (_HAS_NS if has_ns else 0)
            | (_TEXTURED if scene.textures is not None else 0))


def _rng_bits(rng: torch.Tensor) -> torch.Tensor:
    """int64-held uint32 words -> their int32 bit pattern."""
    return torch.where(rng >= 2 ** 31, rng - 2 ** 32, rng).to(torch.int32)


def _kernel_inputs(cfg: RenderConfig, scene: DeviceScene,
                   lights: DeviceLights, ps, what: str, raw_state=False):
    """Checks the lanes and the scene, and returns (state pointers, scene
    arguments, keep-alive tensors) for a launch: the RNG words and flags as
    the port holds them (int64, bool) with `raw_state`, else as int32."""
    device = ps.rng.device
    reason = explain_decline(cfg, scene, lights)
    if reason:
        raise NotImplementedError(f"the {what} kernel cannot take this "
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
    mode = _accel_mode(scene)
    nee_on = cfg.nee and scene.emitters is not None
    tables = _pack_tables(scene, lights, nee_on, mode)
    if raw_state:
        ints = [ps.rng.contiguous(), ps.alive.contiguous(),
                ps.emission_ok.contiguous()]
    else:
        ints = [_rng_bits(ps.rng), ps.alive.to(torch.int32),
                ps.emission_ok.to(torch.int32)]
    keep = planes + ints + [tables]
    if mode is None:
        accel = (None, 0, 0, 0, 0, 1)
        n_tris = scene.num_triangles
    else:
        src = scene.inst if mode == "instanced" else scene.accel
        pack = src.tri_pack.contiguous()
        keep.append(pack)
        inst = ((scene.inst.num_instances, scene.inst.num_meshes)
                if mode == "instanced" else (0, 1))
        accel = (pack.data_ptr(), pack.shape[-1], _clusters(scene, mode),
                 src.cluster_size) + inst
        n_tris = 0
    tex = (None, 0)
    if scene.textures is not None:
        textures = scene.textures.contiguous()
        keep.append(textures)
        tex = (textures.data_ptr(), tex_res_of(textures))
    stream = (None, None)
    if mode == "stream":
        cbox, corder = cuda_trace.stream_globals(scene.accel)
        keep += [cbox, corder]
        stream = (cbox.data_ptr(), corder.data_ptr())
    scene_args = (tables.data_ptr(), n_tris, scene.num_spheres,
                  scene.materials.count, lights.count,
                  scene.emitters.count if nee_on else 0,
                  _flags(cfg, scene, nee_on, mode)) + accel + tex + stream
    return [t.data_ptr() for t in planes + ints], scene_args, keep


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
    if not 0 <= start_bounce <= cfg.max_depth:
        raise ValueError(f"start_bounce {start_bounce} outside "
                         f"[0, {cfg.max_depth}]")
    small = _accel_mode(scene) is None
    ins, scene_args, keep = _kernel_inputs(cfg, scene, lights, ps,
                                           "fused_frame", raw_state=small)
    n = ps.num_paths
    outs_f = [torch.empty(n, dtype=torch.float32, device=device)
              for _ in range(9)]
    if small:
        missed = torch.empty(n, dtype=torch.bool, device=device)
        # the rays per bounce, then the kernel's counter of lanes handed out
        counts = torch.zeros(cfg.max_depth + 1, dtype=torch.int64,
                             device=device)
        launch, outs_i = "spt_small_frame", (missed, counts)
    else:
        missed = torch.empty(n, dtype=torch.int32, device=device)
        bounces = torch.empty(n, dtype=torch.int32, device=device)
        launch, outs_i = "spt_fused_frame", (missed, bounces)

    lib = cuda_lib.build()
    with torch.cuda.device(device):
        err = getattr(lib, launch)(
            *ins, *(t.data_ptr() for t in outs_f),
            *(t.data_ptr() for t in outs_i), *scene_args, n, start_bounce,
            cfg.max_depth, min(cfg.rr_after, 2 ** 31 - 1), cfg.hit_eps,
            cfg.ray_offset_dir, cfg.firefly_clamp, cuda_lib.stream_of(device))
    cuda_lib.check(err, "fused_frame")
    del keep
    LAUNCHES += 1

    direction = Vec3(*outs_f[0:3])
    throughput = Vec3(*outs_f[3:6])
    radiance = Vec3(*outs_f[6:9])
    if small:
        return radiance, direction, throughput, missed, counts[:cfg.max_depth]
    rays = rays_from_counts(bounces, cfg.max_depth, start_bounce)
    return radiance, direction, throughput, missed != 0, rays


def fused_bounce(cfg: RenderConfig, scene: DeviceScene, lights: DeviceLights,
                 ps, bounce: int, is_last: bool):
    """One bounce of every lane (trace_bounce + shade_core).  Returns
    (new PathState, missed (N,) bool); the caller owes
    `throughput * env(direction)` to the missed lanes, which keep their
    direction and throughput."""
    global BOUNCE_LAUNCHES
    device = ps.rng.device
    if device.type == "cpu":
        return fused_bounce_reference(cfg, scene, lights, ps, bounce, is_last)
    if device.type != "cuda":
        raise ValueError(f"fused_bounce runs on CUDA or CPU tensors, not {device}")
    ins, scene_args, keep = _kernel_inputs(cfg, scene, lights, ps,
                                           "fused_bounce")
    n = ps.num_paths
    outs_f = [torch.empty(n, dtype=torch.float32, device=device)
              for _ in range(12)]
    rng = torch.empty(n, dtype=torch.int64, device=device)
    flags = [torch.empty(n, dtype=torch.bool, device=device) for _ in range(3)]

    lib = cuda_lib.build()
    with torch.cuda.device(device):
        err = lib.spt_fused_bounce(
            *ins, *(t.data_ptr() for t in outs_f), rng.data_ptr(),
            *(t.data_ptr() for t in flags), *scene_args, n, bounce,
            int(bool(is_last)), min(cfg.rr_after, 2 ** 31 - 1), cfg.hit_eps,
            cfg.ray_offset_dir, cfg.firefly_clamp, cuda_lib.stream_of(device))
    cuda_lib.check(err, "fused_bounce")
    del keep
    BOUNCE_LAUNCHES += 1
    return transport.PathState(
        origin=Vec3(*outs_f[0:3]), direction=Vec3(*outs_f[3:6]),
        throughput=Vec3(*outs_f[6:9]), radiance=Vec3(*outs_f[9:12]),
        rng=rng, alive=flags[0], emission_ok=flags[1]), flags[2]
