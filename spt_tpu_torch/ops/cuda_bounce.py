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
missed mask.  A scene they decline (``explain_decline``: the JAX package's
caps) is never handed to them: its frames take the unfused bounce
(``integrators/wavefront._fused_ok``).  Every other scene runs them, in one
of two placements of its tables (``tables_in_global``): copied into each
block's shared memory, or, when they do not fit there (thousands of lights
or instances), read from global memory by kernels of the same code
(``*_global_kernel``).

- On a CUDA tensor each launches its hand-written kernel
  (``csrc/fused_frame.cu``, ``csrc/fused_bounce.cu``, built by
  ``ops/cuda_lib``) or raises: there is no fallback.
- On a CPU tensor each runs its plain PyTorch version
  (``fused_frame_reference``, ``fused_bounce_reference``:
  ``transport.trace_bounce`` + ``transport.shade_core``, tracing through the
  plain versions of the tracers and sampling through
  ``transport.sample_texture_v``).  Nothing on the CUDA path calls them;
  tests and ``chip_smoke.py`` hold the kernels against them.

Every form of both reads the path state in the dtypes the port keeps it in
(the RNG words as int64, the flags as bool), so the wrapper converts
nothing; fused_frame counts the rays per bounce itself.  The mesh forms of
fused_frame (``fused_frame_kernel<1..3>``) and the resident form of
fused_bounce (``fused_bounce_queue_kernel<1>``) are persistent cooperative
queue kernels (``csrc/spt_queue.cuh``): they queue the live lanes on the
device and run a few paths a warp when the live lanes are few.  Their
counters (lanes handed out, lanes queued, blocks launched) follow the rays
per bounce, and in fused_bounce the new RNG words, in the same buffer.
The small forms are persistent too: fused_frame's (``small_frame_kernel``)
refills its warps from a counter in that buffer, fused_bounce's
(``small_bounce_kernel``) walks the lanes in a grid-stride loop and needs
no counter.

``whole_frame`` is fused_frame's small form run from a lane index to the
render state's accumulation (``whole_frame_kernel``): the masked frame at
spp 1 under the procedural sky in one launch, primary rays made and the sky
term and the accumulation added in the kernel, op for op as the PyTorch
code around fused_frame computes them, on tables packed once
(``frame_tables``).  It has no plain version of its own: its plain version
is the split frame's chain (``transport.primary_lanes``,
``fused_frame_reference``, the sky term and the sum), which the CPU runs.

``LAUNCHES`` counts fused_frame launches, ``BOUNCE_LAUNCHES``
fused_bounce launches and ``WHOLE_LAUNCHES`` whole_frame launches in the
shared placement, ``GLOBAL_LAUNCHES``, ``GLOBAL_BOUNCE_LAUNCHES`` and
``WHOLE_GLOBAL_LAUNCHES`` those in the global one, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import torch

from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.env import SUN_DIRECTION
from spt_tpu_torch.integrators import transport
from spt_tpu_torch.lights import DeviceLights
from spt_tpu_torch.materials import tex_res_of
from spt_tpu_torch.ops import bvh, cuda_lib, cuda_trace
from spt_tpu_torch.ops.vec3 import Vec3
from spt_tpu_torch.scene.flatten import DeviceScene

# Kernel launches since import (or since a caller reset them).
LAUNCHES = 0
BOUNCE_LAUNCHES = 0
GLOBAL_LAUNCHES = 0
GLOBAL_BOUNCE_LAUNCHES = 0
WHOLE_LAUNCHES = 0
WHOLE_GLOBAL_LAUNCHES = 0

# Each form of fused_frame and of fused_bounce as a profiler trace names it,
# by accel mode; then the same in the global placement.
FRAME_KERNELS = {None: "small_frame_kernel",
                 "resident": "fused_frame_kernel<1>",
                 "instanced": "fused_frame_kernel<2>",
                 "stream": "fused_frame_kernel<3>"}
SMALL_KERNEL = FRAME_KERNELS[None]
BOUNCE_KERNELS = {None: "small_bounce_kernel",
                  "resident": "fused_bounce_queue_kernel<1>",
                  "instanced": "fused_bounce_kernel<2>",
                  "stream": "fused_bounce_kernel<3>"}
FRAME_KERNELS_GLOBAL = {None: "small_frame_global_kernel",
                        "resident": "fused_frame_global_kernel<1>",
                        "instanced": "fused_frame_global_kernel<2>",
                        "stream": "fused_frame_global_kernel<3>"}
BOUNCE_KERNELS_GLOBAL = {None: "small_bounce_global_kernel",
                         "resident": "fused_bounce_queue_global_kernel<1>",
                         "instanced": "fused_bounce_global_kernel<2>",
                         "stream": "fused_bounce_global_kernel<3>"}

# Caps, as pallas_bounce's (MAX_PALLAS_PRIMS, MAX_PALLAS_MATERIALS,
# MAX_PALLAS_EMITTERS, MAX_ACCEL_TRIS, MAX_ACCEL_SPHERES); a scene past one
# takes the unfused bounce.  A block copies the tables into its shared
# memory while they fit: in the small forms the 48 KiB a block gets without
# opting in, in the mesh forms the 227 KiB it may opt in to; past those the
# kernels read them from global memory (``tables_in_global``).
MAX_PRIMS = 192
MAX_MATERIALS = 64
MAX_EMITTERS = 32
MAX_ACCEL_TRIS = 12288
MAX_ACCEL_SPHERES = 32
MAX_TABLE_BYTES = cuda_lib.SMALL_SHARED_BYTES
MAX_RESIDENT_TABLE_BYTES = cuda_lib.MAX_SHARED_BYTES

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
    """None (brute force: a small scene, or one the fused kernels decline),
    "resident" (cluster tracer over the accel), "instanced" (the TLAS/BLAS
    tracer over scene.inst) or "stream" (the supercluster tracer over an
    accel past MAX_ACCEL_TRIS), as pallas_bounce._accel_mode (:161-182):
    None also past MAX_PRIMS with more than MAX_ACCEL_SPHERES spheres or
    no cluster accel, which ``explain_decline`` names; raises past
    bvh.MAX_STREAM_CLUSTERS, where the JAX package asserts
    (spt_tpu/ops/bvh.py:520-522)."""
    if scene.num_triangles + scene.num_spheres <= MAX_PRIMS:
        return None
    if scene.num_spheres > MAX_ACCEL_SPHERES:
        return None
    if scene.inst is not None:
        return "instanced"
    a = scene.accel
    if a is None:
        return None
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
                 lights: DeviceLights, in_global: bool = False) -> int:
    """Dynamic shared memory of a fused_frame block on this workload (a
    fused_bounce block takes no more): the tables (not in the global
    placement, `in_global`), the visit orders and, in a mesh form, the
    warps' staging buffers (cuda_lib.shared_bytes), then the histogram of
    bounces run from bounce 0."""
    mode = _accel_mode(scene)
    nee_on = cfg.nee and scene.emitters is not None
    tables = 0 if in_global else 4 * _table_words(scene, lights, nee_on, mode)
    return cuda_lib.shared_bytes(
        tables + 2 * 8 * _clusters(scene, mode), mode is not None) + 4 * (
            cfg.max_depth + 1)


def explain_decline(cfg: RenderConfig, scene: DeviceScene,
                    lights: DeviceLights):
    """Why the fused kernels decline this workload, or None when they take
    it: the JAX package's reasons (pallas_bounce.py:185-233) — past
    MAX_PRIMS primitives with no cluster accel or with more than
    MAX_ACCEL_SPHERES spheres beside it, more than MAX_MATERIALS materials,
    more than MAX_EMITTERS emitters under NEE.  A declined scene renders
    through the unfused bounce (``integrators/wavefront._fused_ok``).

    The JAX package's texture gates (pallas_bounce.py:222-228: a textured
    scene needs an accel mode, and the packed table at most
    MAX_TEX_TABLE_BYTES) bound the table in a TPU core's VMEM.  Here the
    table stays in global memory and is read through L2, so neither
    applies: textured scenes take every mode, small ones included."""
    reasons = []
    mode = _accel_mode(scene)
    n_prims = scene.num_triangles + scene.num_spheres
    if mode is None and n_prims > MAX_PRIMS:
        if scene.accel is None:
            reasons.append(f"{n_prims} primitives > MAX_PRIMS={MAX_PRIMS} "
                           "and no cluster accel built")
        else:
            reasons.append(f"{scene.num_spheres} spheres > "
                           f"MAX_ACCEL_SPHERES={MAX_ACCEL_SPHERES}")
    if scene.materials.count > MAX_MATERIALS:
        reasons.append(f"{scene.materials.count} materials > "
                       f"MAX_MATERIALS={MAX_MATERIALS}")
    nee_on = cfg.nee and scene.emitters is not None
    if nee_on and scene.emitters.count > MAX_EMITTERS:
        reasons.append(f"{scene.emitters.count} emitters > "
                       f"MAX_EMITTERS={MAX_EMITTERS}")
    return "; ".join(reasons) if reasons else None


def tables_in_global(cfg: RenderConfig, scene: DeviceScene,
                     lights: DeviceLights) -> bool:
    """Whether the fused kernels read this workload's tables from global
    memory: whether a block's shared copy of them (``shared_bytes``) passes
    MAX_TABLE_BYTES in the small forms, MAX_RESIDENT_TABLE_BYTES in the
    mesh forms, as with a thousand lights or thousands of instances
    (``cuda_lib.tables_in_global``)."""
    return cuda_lib.tables_in_global(shared_bytes(cfg, scene, lights),
                                     _accel_mode(scene) is not None)


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
    the plain versions of the tracers (``transport.bounce_loop``).  Every
    bounce runs over every lane: dead lanes come back unchanged, so the
    result is the kernel's, and no host sync is needed to stop early."""
    ps, missed_ever, rays, _ = transport.bounce_loop(
        cfg, scene, lights, ps, start_bounce, plain=True)
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


def _kernel_inputs(cfg: RenderConfig, scene: DeviceScene,
                   lights: DeviceLights, ps, what: str,
                   in_global: bool | None = None):
    """Checks the lanes and the scene, and returns (state pointers, scene
    arguments, keep-alive tensors) for a launch: the RNG words and flags as
    the port holds them (int64, bool), handed over as they are; the last
    scene argument is the placement of the tables, ``tables_in_global``'s
    unless `in_global` forces one (tests and chip_smoke.py compare the
    two).  A scene that ``explain_decline`` names raises: its frames take
    the unfused bounce, so a launch on it is the caller's fault."""
    device = ps.rng.device
    reason = explain_decline(cfg, scene, lights)
    if reason:
        raise NotImplementedError(f"the {what} kernel cannot take this "
                                  f"scene: {reason}")
    if in_global is None:
        in_global = tables_in_global(cfg, scene, lights)
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
        if (t.device != device or t.dtype != dt or t.shape != (n,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({n},) {dt} tensor "
                             f"on {device}")
    mode = _accel_mode(scene)
    nee_on = cfg.nee and scene.emitters is not None
    tables = _pack_tables(scene, lights, nee_on, mode)
    ints = [ps.rng, ps.alive, ps.emission_ok]
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
                  _flags(cfg, scene, nee_on, mode)) + accel + tex + stream + (
                      int(bool(in_global)),)
    return [t.data_ptr() for t in planes + ints], scene_args, keep


def fused_frame(cfg: RenderConfig, scene: DeviceScene, lights: DeviceLights,
                ps, start_bounce: int = 0, *, _in_global: bool | None = None):
    """Bounces [start_bounce, max_depth) of one sample.

    Returns (radiance Vec3, final_direction Vec3, final_throughput Vec3,
    missed_ever (N,) bool, rays_per_bounce (max_depth,) int64; entries below
    start_bounce are zero).  The caller owes `throughput * env(direction)`
    to missed lanes (the deferred-env contract).  `_in_global` forces a
    placement of the tables on the card (see ``_kernel_inputs``); no entry
    point passes it.
    """
    global LAUNCHES, GLOBAL_LAUNCHES
    device = ps.rng.device
    if device.type == "cpu":
        return fused_frame_reference(cfg, scene, lights, ps, start_bounce)
    if device.type != "cuda":
        raise ValueError(f"fused_frame runs on CUDA or CPU tensors, not {device}")
    if not 0 <= start_bounce <= cfg.max_depth:
        raise ValueError(f"start_bounce {start_bounce} outside "
                         f"[0, {cfg.max_depth}]")
    ins, scene_args, keep = _kernel_inputs(cfg, scene, lights, ps,
                                           "fused_frame", _in_global)
    n = ps.num_paths
    outs_f = [torch.empty(n, dtype=torch.float32, device=device)
              for _ in range(9)]
    missed = torch.empty(n, dtype=torch.bool, device=device)
    # the rays per bounce, then the kernel's counters (csrc/fused_frame.cu
    # FrameIO); a mesh form queues the live lanes' ids
    counts = torch.zeros(cfg.max_depth + 3, dtype=torch.int64, device=device)
    queue = (None if _accel_mode(scene) is None
             else torch.empty(n, dtype=torch.int32, device=device))

    lib = cuda_lib.build()
    with torch.cuda.device(device):
        err = lib.spt_fused_frame(
            *ins, *(t.data_ptr() for t in outs_f), missed.data_ptr(),
            counts.data_ptr(), None if queue is None else queue.data_ptr(),
            *scene_args, n, start_bounce, cfg.max_depth,
            min(cfg.rr_after, 2 ** 31 - 1), cfg.hit_eps, cfg.ray_offset_dir,
            cfg.firefly_clamp, cuda_lib.stream_of(device))
    cuda_lib.check(err, "fused_frame")
    del keep, queue
    if scene_args[-1]:
        GLOBAL_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return (Vec3(*outs_f[6:9]), Vec3(*outs_f[0:3]), Vec3(*outs_f[3:6]),
            missed, counts[:cfg.max_depth])


def frame_tables(cfg: RenderConfig, scene: DeviceScene,
                 lights: DeviceLights) -> torch.Tensor:
    """The tables the kernels read for this workload (``_pack_tables`` in
    its accel mode), packed once by a caller that launches on them frame
    after frame (``whole_frame``)."""
    return _pack_tables(scene, lights, cfg.nee and scene.emitters is not None,
                        _accel_mode(scene))


def whole_frame(cfg: RenderConfig, scene: DeviceScene, lights: DeviceLights,
                camera: torch.Tensor, accum: torch.Tensor,
                frame_index: torch.Tensor, tables: torch.Tensor,
                row0: int = 0, *, _in_global: bool | None = None):
    """One masked frame at spp 1 under the procedural sky on the card, in
    one launch of the whole-frame kernel: the band of ``accum``'s
    n = width x rows pixels from row `row0`, each pixel's primary ray
    (transport.primary_lanes) run through bounces [0, max_depth) as
    fused_frame runs them, the sky term of a missed path and the sample
    added into ``accum`` ((n, 3) float32) in place, as
    ``wavefront._wavefront_masked``, ``render_wavefront`` and
    ``state.accumulate_`` add them.  ``camera`` is the 14-float buffer of
    the camera rays (position, forward, right, up, half_width,
    half_height) and ``frame_index`` the render state's int32 epoch: the
    kernel reads both on the device, so a captured launch reads each
    replay's.  ``tables`` is ``frame_tables``'.  Returns rays_per_bounce
    (max_depth,) int64.  The caller decides that the frame takes this form
    (``wavefront._whole_frame_ok``); `_in_global` forces a placement of
    the tables as fused_frame's."""
    global WHOLE_LAUNCHES, WHOLE_GLOBAL_LAUNCHES
    device = accum.device
    if device.type != "cuda":
        raise ValueError(f"whole_frame runs on CUDA tensors, not {device}")
    n = accum.shape[0]
    if (accum.dtype != torch.float32 or accum.shape != (n, 3)
            or not accum.is_contiguous() or n % cfg.width):
        raise ValueError(f"accum must be a contiguous float32 (width x rows, "
                         f"3) tensor, not {tuple(accum.shape)} "
                         f"{accum.dtype}")
    for name, t, dt, numel in (("camera", camera, torch.float32, 14),
                               ("frame_index", frame_index, torch.int32, 1),
                               ("tables", tables, torch.float32,
                                tables.numel())):
        if (t.device != device or t.dtype != dt or t.numel() != numel
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                             f"{numel} elements on {device}")
    if _in_global is None:
        _in_global = tables_in_global(cfg, scene, lights)
    nee_on = cfg.nee and scene.emitters is not None
    tex = (None, 0)
    keep = []
    if scene.textures is not None:
        textures = scene.textures.contiguous()
        keep.append(textures)
        tex = (textures.data_ptr(), tex_res_of(textures))
    counts = torch.zeros(cfg.max_depth + 3, dtype=torch.int64, device=device)
    sun = SUN_DIRECTION.astype("float32")
    lib = cuda_lib.build()
    with torch.cuda.device(device):
        err = lib.spt_whole_frame(
            camera.data_ptr(), frame_index.data_ptr(), accum.data_ptr(),
            counts.data_ptr(), tables.data_ptr(), scene.num_triangles,
            scene.num_spheres, scene.materials.count, lights.count,
            scene.emitters.count if nee_on else 0,
            _flags(cfg, scene, nee_on), *tex, int(bool(_in_global)), n,
            cfg.width, cfg.height, row0, cfg.max_depth, int(bool(cfg.jitter)),
            *(float(c) for c in sun), min(cfg.rr_after, 2 ** 31 - 1),
            cfg.hit_eps, cfg.ray_offset_dir, cfg.firefly_clamp,
            cuda_lib.stream_of(device))
    cuda_lib.check(err, "whole_frame")
    del keep
    if _in_global:
        WHOLE_GLOBAL_LAUNCHES += 1
    else:
        WHOLE_LAUNCHES += 1
    return counts[:cfg.max_depth]


def fused_bounce(cfg: RenderConfig, scene: DeviceScene, lights: DeviceLights,
                 ps, bounce: int, is_last: bool, *,
                 _in_global: bool | None = None):
    """One bounce of every lane (trace_bounce + shade_core).  Returns
    (new PathState, missed (N,) bool); the caller owes
    `throughput * env(direction)` to the missed lanes, which keep their
    direction and throughput.  The new state is in fresh tensors; in the
    resident form the kernel's counters follow the new RNG words in their
    buffer.  `_in_global` as fused_frame's."""
    global BOUNCE_LAUNCHES, GLOBAL_BOUNCE_LAUNCHES
    device = ps.rng.device
    if device.type == "cpu":
        return fused_bounce_reference(cfg, scene, lights, ps, bounce, is_last)
    if device.type != "cuda":
        raise ValueError(f"fused_bounce runs on CUDA or CPU tensors, not {device}")
    ins, scene_args, keep = _kernel_inputs(cfg, scene, lights, ps,
                                           "fused_bounce", _in_global)
    n = ps.num_paths
    outs_f = [torch.empty(n, dtype=torch.float32, device=device)
              for _ in range(12)]
    flags = [torch.empty(n, dtype=torch.bool, device=device) for _ in range(3)]
    # the resident form's counters (csrc/fused_bounce.cu BounceIO) after
    # the RNG words, zeroed, and its queue of the live lanes' ids
    queued = _accel_mode(scene) == "resident"
    rng = torch.empty(n + 3 * queued, dtype=torch.int64, device=device)
    counters = queue = None
    if queued:
        counters = rng[n:]
        counters.zero_()
        queue = torch.empty(n, dtype=torch.int32, device=device)

    lib = cuda_lib.build()
    with torch.cuda.device(device):
        err = lib.spt_fused_bounce(
            *ins, *(t.data_ptr() for t in outs_f), rng.data_ptr(),
            *(t.data_ptr() for t in flags),
            None if counters is None else counters.data_ptr(),
            None if queue is None else queue.data_ptr(), *scene_args, n,
            bounce, int(bool(is_last)), min(cfg.rr_after, 2 ** 31 - 1),
            cfg.hit_eps, cfg.ray_offset_dir, cfg.firefly_clamp,
            cuda_lib.stream_of(device))
    cuda_lib.check(err, "fused_bounce")
    del keep, queue
    if scene_args[-1]:
        GLOBAL_BOUNCE_LAUNCHES += 1
    else:
        BOUNCE_LAUNCHES += 1
    return transport.PathState(
        origin=Vec3(*outs_f[0:3]), direction=Vec3(*outs_f[3:6]),
        throughput=Vec3(*outs_f[6:9]), radiance=Vec3(*outs_f[9:12]),
        rng=rng[:n], alive=flags[0], emission_ok=flags[1]), flags[2]
