#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and a checkout of this repository around
this file; exits non-zero (printing no result) without them.  Phases:

0. build every CUDA kernel from ``spt_tpu_torch/csrc`` (one nvcc per
   source, all at once); build seconds, registers and spills per kernel;
1. small-scene fused_frame vs its plain PyTorch version on the card, from
   the same primary rays at 1920x1080: default depth 6, Cornell depth 8 and
   HDR glass depth 6, every plane bit for bit and the rays per bounce
   exact; at each, its device time (torch.profiler), the wrapper's and the
   plain version's time, its bound, registers, spill and blocks per SM,
   and the SIMT efficiency of warps and blocks of lanes in pixel order,
   from the plain version's per-lane bounce counts;
2. the small-scene main path: ``Renderer.render_frames(8)`` on default
   1920x1080 depth 6, Cornell (NEE) and HDR glass with a 1024x2048
   synthetic map, launch counts reset before and read after;
3. the small-scene kernel image against the plain path's image, 320x240;
4. small-scene times: ms/frame and Mrays/s, kernel path and plain path;
   the kernel path's device busy time and launches per frame (profiler);
5. the mesh kernels vs their plain versions on the card, on the procedural
   mesh scene (``mesh_scene``) at 512x384, every returned plane per lane:
   each at the inputs its main path gives it, recorded from one frame of
   that path (fused_bounce, the resident fused_frame and sort_chunks from
   the sorted frame, closest_hit / any_hit from regen), where its time and
   bound are taken; besides, closest_hit / any_hit on camera rays and on
   196 608 random rays, the resident fused_frame from bounce 0 on all
   lanes, sort_chunks at chunks 8192 and 32768 with 15 random planes, and
   the sort's launch shape (cluster size, registers, shared bytes, active
   clusters) at each chunk; sort_chunks is held to its plain version (a
   stable torch.sort) bit for bit in keys, lane ids and every plane;
6. the mesh main path: ``Renderer.render_frames(8)`` at 512x384 depth 4 in
   accel mode "resident" through the sorted frame, launch counts reset
   before and read after;
7. the standalone cluster tracer's main path: ``Renderer.render_frames(2)``
   with ``integrator="regen"`` on the mesh scene, which traces through
   ``intersect_v`` / ``occluded_v`` (closest_hit / any_hit);
8. mesh images: the sorted kernel path against the unsorted kernel path
   and against the plain path, 8 frames;
9. mesh times at 512x384 depth 4: ms/frame and Mrays/s, per-kernel device
   time and launches per frame (torch.profiler), torch.sort + gather beside
   sort_chunks;
10. the instanced kernels vs their plain versions on the card, on the
    textured instanced grid (``inst_grid_scene``, 104 448 world triangles)
    at 512x384, every returned plane per lane, at the inputs recorded from
    one regen frame (closest_hit_inst / any_hit_inst) and one sorted frame
    (fused_bounce and fused_frame instanced, textured, their radiance bit
    for bit; sort_chunks at the full-width calls), where their times and
    bounds are taken; the textured fused_frame's time without its
    texture table (the sampler's share); the instanced fused_frame from
    bounce 0 on all lanes; the textured resident forms on the mesh scene;
11. the instanced main path: ``Renderer.render_frames(8)`` on the grid at
    512x384 depth 4 in accel mode "instanced", textured, through the sorted
    frame, launch counts reset before and read after; ms/frame, Mrays/s
    and device busy;
12. the instanced tracer's standalone path: ``Renderer.render_frames(2)``
    with ``integrator="regen"`` on the grid (closest_hit_inst /
    any_hit_inst);
13. grid images: the sorted kernel path against the unsorted one (8 frames)
    and against the plain path (2 frames);
14. the stream-tier kernels vs their plain versions on the card, on the
    baked grid (``unique_grid_scene``, 104 448 unique world triangles,
    accel mode "stream") at 512x384, every returned plane per lane, at the
    inputs recorded from one regen frame (closest_hit_stream /
    any_hit_stream) and one sorted frame (fused_bounce and fused_frame
    stream, textured, their radiance bit for bit; sort_chunks at the
    full-width calls), where their times and bounds are taken;
15. the stream main path: ``Renderer.render_frames(8)`` on the baked grid
    at 512x384 depth 4 through the sorted frame, launch counts reset before
    and read after; ms/frame, Mrays/s, device busy and idle share, sorted
    and unsorted;
16. the stream tracer's standalone path: ``Renderer.render_frames(2)`` with
    ``integrator="regen"`` on the baked grid;
17. baked-grid images: the sorted kernel path against the unsorted one (8
    frames) and against the plain path (1 frame);
18. the stream tier at any size: the baked grid at 144 x 192 tessellation
    (about 940k triangles, a tri_pack past the L2), the stream tracer per
    launch at one regen frame's calls and against its plain version on
    16 384 lanes;
19. the equirect sampler (K2) on the hdr config at 1920x1080 depth 6 (its
    map through the .hdr round trip) at the inputs of one frame of its main
    path: kernel against plain on the lanes that need the term, 0 on the
    others; device ms, bound, plain ms and ``grid_sample``'s time; its
    registers and the bytes of the map in its texel layout; the poles and the u
    seam, bit for bit;
20. integrator "compact" on default d6, cornell d8 and hdr d6 at 1920x1080
    and on the mesh scene at 512x384 d4: K3 at the path's bounce-0 call
    against its plain version (every plane bit for bit on the small scenes,
    where it runs its small form), with its device time, bound and plain
    time; K2 at each of the hdr frame's calls (one a bounce), bit for bit;
    ``Renderer.render_frames(8)`` with the counts reset before and read
    after, its image against the masked path's (< 1 % relative RMSE) and
    its rays per bounce equal; ms/frame and device busy beside the masked
    path's;
21. integrator "megakernel" on default 1920x1080 d6 against the masked
    path (< 1 % relative RMSE), ms/frame and launches a frame; the gradient
    of an image MSE with respect to base_color on the card at 64x48 d3
    against the CPU's; ``toggle_integrator`` resets accumulation;
22. the five debug views on the default scene and the mesh scene at
    512x384 against the CPU plain run on the card's primary rays
    (every 4th pixel row on the mesh scene): geomtype, hitmiss and matid
    equal, normal and depth within 1e-5;
23. the entry points in subprocesses: ``python -m spt_tpu_torch.cli`` at
    its defaults (800x600, spp 4, d6, 4 frames), with ``--integrator
    compact``, ``--integrator megakernel``, ``--debug-mode normal``,
    ``--stats`` and ``--i`` on a synthetic textured .glb, each exit 0 and a
    PNG; ``python -m spt_tpu_torch.bench`` on default, cornell, hdr and
    anim, each exit 0 and its JSON line, echoed.

A mesh kernel's bound counts the operations of its walks from the plain
version's own results: each traced ray's box tests and the 64 triangle
tests of every cluster its final bound reaches (``_walk_ops``: the closest
hit and every shadow and NEE ray of the fused kernels).  Phases 5, 10, 14
and 18 print each mesh form's registers, spill bytes, shared memory per
block and blocks per SM at their tables.

PNGs go to ``build/chip_smoke/`` beside this file.  The line before the last
lists the kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

W, H = 1920, 1080
MW, MH = 512, 384          # the JAX package's mesh resolution (bench.py:195-203)
MESH_DEPTH = 4

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32 outside
# the tensor cores (also used for the sort's integer operations).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over the float32 peak."""
    tb, to = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ops_note(flops: float) -> str:
    """A launch's counted operations and their time at the float32 peak,
    for a log line beside its bound."""
    return f"{flops:.4g} operations: {flops / PEAK_F32 * 1e3:.4f} ms"


# --- scenes -------------------------------------------------------------------

def mesh_scene(scene_mod, materials_mod, desc_mod, stacks=32, slices=48):
    """The procedural stand-in of the glTF chair (6156 triangles at the
    default tessellation): two smooth UV spheres (diffuse, gold), a glass
    cube scaled to 0.4, an analytic glass sphere, no ground plane.  Takes
    the scene, materials and scene.desc modules of either package.
    Returns (SceneDesc, camera keyword arguments without aspect_ratio): the
    camera of bench.py's gltf config (bench.py:135-148) — bounding-box
    centre, position centre + (0, 0.35, 1.1) * extent, fov 60."""
    import numpy as np

    d = scene_mod.SceneDesc()
    d.add_material(scene_mod.Material([0.7, 0.7, 0.7], roughness=0.8))
    d.add_material(materials_mod.gold())
    d.add_material(materials_mod.glass())
    eye = np.eye(4, dtype=np.float32)
    sph = d.add_mesh(scene_mod.create_sphere_mesh(stacks=stacks, slices=slices,
                                                  radius=0.5))
    d.add_instance(sph, desc_mod.translate(eye, [-0.6, 0.5, 0.0]), material_id=0)
    d.add_instance(sph, desc_mod.translate(eye, [0.6, 0.5, 0.0]), material_id=1)
    cube = d.add_mesh(scene_mod.create_cube_mesh())
    d.add_instance(cube, desc_mod.scale(desc_mod.translate(eye, [0.0, 0.2, 0.7]),
                                        [0.4, 0.4, 0.4]), material_id=2)
    d.add_sphere([0.0, 1.2, 0.3], 0.25, 2)

    lo, hi = np.full(3, np.inf), np.full(3, -np.inf)
    for inst in d.instances:
        mesh = d.meshes[inst.mesh_id]
        ph = np.concatenate([mesh.positions,
                             np.ones((len(mesh.positions), 1), np.float32)], 1)
        world = (ph @ inst.world_from_object.T)[:, :3]
        lo, hi = np.minimum(lo, world.min(0)), np.maximum(hi, world.max(0))
    for s in d.spheres:
        lo = np.minimum(lo, s.center - s.radius)
        hi = np.maximum(hi, s.center + s.radius)
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    center = (lo + hi) / 2
    extent = float(np.linalg.norm(hi - lo))
    cam = dict(position=center + np.array([0.0, 0.35, 1.1]) * extent,
               target=center, fov_degrees=60.0)
    return d, cam


def _checker_texture(np, rng, res=512):
    """(res, res, 3) baseColor: an 8x8 checker of two random colours times a
    smooth gradient, and (res, res, 3) metallicRoughness: G (roughness) a
    gradient in [0.2, 1], B (metallic) stripes of 0 and 1."""
    y, x = np.meshgrid(np.arange(res) / res, np.arange(res) / res,
                       indexing="ij")
    colours = rng.uniform(0.15, 1.0, (2, 3))
    cell = ((np.floor(x * 8) + np.floor(y * 8)) % 2).astype(np.int64)
    grad = 0.55 + 0.45 * np.sin(np.pi * x)[..., None] * np.cos(
        0.5 * np.pi * y)[..., None]
    base = (colours[cell] * grad).astype(np.float32)
    mr = np.zeros((res, res, 3), np.float32)
    mr[..., 1] = 0.2 + 0.8 * y
    mr[..., 2] = (np.floor(x * 6) % 2 == 1)
    return base, mr


def inst_grid_scene(scene_mod, materials_mod, desc_mod, stacks=48, slices=64,
                    seed=0):
    """The procedural stand-in of bench.py's bigmesh config (a 4x4 grid of
    the textured glTF chair, bench.py:104-118, spt_tpu/scene/builder.py:148-163): 16
    instances of a textured UV sphere A (stacks x slices x 2 triangles,
    6144 at the default, the chair's size), rotated about y by
    0.4 * (gx * 4 + gz), cell (1, 2) mirrored, cells with (gx + gz) % 4 of 1
    gold and of 3 glass; four instances of an untextured sphere B
    (stacks/2 x slices/2 x 2 triangles) scaled (0.6, 0.3, 0.6) over the
    centres of the 2x2 blocks; an analytic glass sphere above the grid's
    centre; no ground plane.  At the default size 104 448 world triangles
    over a 2 x 96-cluster BLAS of 12 288 slots, exactly MAX_RESIDENT_TRIS,
    so both packages instance it.  Takes the scene, materials and
    scene.desc modules of either package.  Returns (SceneDesc, camera
    keyword arguments without aspect_ratio): bench.py's bigmesh camera,
    radius = 4 |hi - lo| of one A instance, position centre + (0.3, 0.35,
    1.0) * radius, fov 45."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base_tex, mr_tex = _checker_texture(np, rng)
    d = scene_mod.SceneDesc()
    d.add_material(scene_mod.Material([1.0, 1.0, 1.0], roughness=1.0,
                                      metallic=1.0,
                                      base_color_texture=base_tex,
                                      metallic_roughness_texture=mr_tex))
    d.add_material(materials_mod.gold())
    d.add_material(materials_mod.glass())
    d.add_material(scene_mod.Material([0.6, 0.6, 0.6], roughness=0.7))
    a = d.add_mesh(scene_mod.create_sphere_mesh(stacks=stacks, slices=slices,
                                                radius=0.5, material_id=0))
    b = d.add_mesh(scene_mod.create_sphere_mesh(
        stacks=max(stacks // 2, 2), slices=max(slices // 2, 3), radius=0.5,
        material_id=3))
    pos = d.meshes[a].positions
    lo, hi = pos.min(0).astype(np.float32), pos.max(0).astype(np.float32)
    dx, dz = float(hi[0] - lo[0]) * 1.3, float(hi[2] - lo[2]) * 1.3

    def xform(t, angle=0.0, s=(1.0, 1.0, 1.0)):
        m = np.eye(4, dtype=np.float64)
        c, sn = np.cos(angle), np.sin(angle)
        m[:3, :3] = np.array([[c, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, c]])
        m[:3, :3] = m[:3, :3] @ np.diag(s)
        m[:3, 3] = t
        return m.astype(np.float32)

    for gx in range(4):
        for gz in range(4):
            mirror = (-1.0, 1.0, 1.0) if (gx, gz) == (1, 2) else (1.0, 1.0, 1.0)
            xf = xform((gx * dx, 0.0, gz * dz), 0.4 * (gx * 4 + gz), mirror)
            over = {1: 1, 3: 2}.get((gx + gz) % 4)
            if over is None:
                d.add_instance(a, xf)
            else:
                d.add_instance(a, xf, material_id=over)
    for bx in range(2):
        for bz in range(2):
            d.add_instance(b, xform(((2 * bx + 0.5) * dx, 0.6,
                                     (2 * bz + 0.5) * dz),
                                    s=(0.6, 0.3, 0.6)))
    center = 0.5 * (lo + hi)
    center[0] += 3 * dx / 2
    center[2] += 3 * dz / 2
    d.add_sphere([float(center[0]), 1.2, float(center[2])], 0.4, 2)
    radius = float(np.linalg.norm(hi - lo)) * 4
    cam = dict(position=center + np.array([0.3, 0.35, 1.0]) * radius,
               target=center, fov_degrees=45.0)
    return d, cam


def unique_grid_scene(scene_mod, materials_mod, desc_mod, stacks=48,
                      slices=64, seed=0):
    """The procedural stand-in of bench.py's stream config (the chair grid
    baked to unique meshes, bench.py:119-134,
    spt_tpu/scene/builder.py:167-217): inst_grid_scene with every instance
    baked to a mesh of its own as builder.py:187-212 bakes them — positions
    transformed, normals by the inverse-transpose and renormalized,
    texture coordinates and material overrides kept — and one instance per
    mesh.  At the default size 104 448 unique world triangles in 20 meshes:
    no shared BLAS fits MAX_RESIDENT_TRIS, so both packages trace it in
    accel mode "stream" (1632 clusters in 102 superclusters).  Takes the
    scene, materials and scene.desc modules of either package.  Returns
    (SceneDesc, camera keyword arguments without aspect_ratio), the camera
    of inst_grid_scene."""
    import numpy as np

    src, cam = inst_grid_scene(scene_mod, materials_mod, desc_mod, stacks,
                               slices, seed)
    d = scene_mod.SceneDesc()
    for m in src.materials:
        d.add_material(m)
    for inst in src.instances:
        mesh = src.meshes[inst.mesh_id]
        xf = inst.world_from_object
        pos_h = np.concatenate(
            [mesh.positions, np.ones((mesh.vertex_count, 1), np.float32)], 1)
        world = (pos_h @ xf.T)[:, :3].astype(np.float32)
        nrm = None
        if mesh.normals is not None:
            ofw = np.linalg.inv(np.asarray(xf, np.float64))[:3, :3]
            nrm = mesh.normals.astype(np.float64) @ ofw
            nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True),
                              1e-20)
            nrm = nrm.astype(np.float32)
        mid = d.add_mesh(scene_mod.MeshData(
            positions=world, indices=mesh.indices, normals=nrm,
            texcoords=mesh.texcoords, material_id=mesh.material_id))
        d.add_instance(mid, material_id=inst.material_id)
    for sph in src.spheres:
        d.add_sphere(sph.center, sph.radius, sph.material_id)
    return d, cam


def port_stream_scene(stacks=48, slices=64, **cfg_kw):
    """(SceneDesc, RenderConfig, Camera) of the baked grid in the port at
    MWxMH."""
    from spt_tpu_torch import materials
    from spt_tpu_torch import scene as tscene
    from spt_tpu_torch.camera import Camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.scene import desc as tdesc

    desc, cam = unique_grid_scene(tscene, materials, tdesc, stacks, slices)
    cfg = RenderConfig(width=MW, height=MH, spp=1, max_depth=MESH_DEPTH,
                       **cfg_kw)
    return desc, cfg, Camera(aspect_ratio=MW / MH, **cam)


def port_inst_scene(stacks=48, slices=64, **cfg_kw):
    """(SceneDesc, RenderConfig, Camera) of the instanced grid in the port
    at MWxMH."""
    from spt_tpu_torch import materials
    from spt_tpu_torch import scene as tscene
    from spt_tpu_torch.camera import Camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.scene import desc as tdesc

    desc, cam = inst_grid_scene(tscene, materials, tdesc, stacks, slices)
    cfg = RenderConfig(width=MW, height=MH, spp=1, max_depth=MESH_DEPTH,
                       **cfg_kw)
    return desc, cfg, Camera(aspect_ratio=MW / MH, **cam)


def port_mesh_scene(stacks=32, slices=48, **cfg_kw):
    """(SceneDesc, RenderConfig, Camera) of the mesh scene in the port at
    MWxMH."""
    from spt_tpu_torch import materials
    from spt_tpu_torch import scene as tscene
    from spt_tpu_torch.camera import Camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.scene import desc as tdesc

    desc, cam = mesh_scene(tscene, materials, tdesc, stacks, slices)
    cfg = RenderConfig(width=MW, height=MH, spp=1, max_depth=MESH_DEPTH,
                       **cfg_kw)
    return desc, cfg, Camera(aspect_ratio=MW / MH, **cam)


# The cases the cooperative cluster walk (csrc/spt_tracers.cuh) has to get
# right beside a coherent frame; the card tests hold the kernels to their
# plain versions on each.
WALK_CASES = ("mixed_octants", "every_other_dead", "ragged", "blocked_early")


def walk_case(torch, np, case, scene, lights, ps):
    """(lights, PathState) of one of WALK_CASES, from a mesh scene's primary
    state: every lane a random direction (warps of mixed octants); every
    other lane dead (partial active masks); 13 lanes fewer (a lane count
    that is not a multiple of 32); or, beside the scene's light, a light
    grazing along the scene and a point light at its centre, whose shadow
    rays other geometry blocks a few clusters out."""
    from spt_tpu_torch.lights import LightManager
    from spt_tpu_torch.ops.vec3 import Vec3

    dev = ps.rng.device
    n = ps.num_paths
    if case == "mixed_octants":
        d = np.random.default_rng(11).normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return lights, ps._replace(direction=Vec3(*(
            torch.from_numpy(np.ascontiguousarray(d[:, k])).to(dev)
            for k in range(3))))
    if case == "every_other_dead":
        return lights, ps._replace(
            alive=ps.alive & (torch.arange(n, device=dev) % 2 == 0))
    if case == "ragged":
        return lights, type(ps)(*(
            Vec3(*(c[:n - 13].contiguous() for c in f)) if isinstance(f, Vec3)
            else f[:n - 13].contiguous() for f in ps))
    if case != "blocked_early":
        raise ValueError(f"unknown walk case {case!r}")
    if scene.inst is not None:
        lo = scene.inst.inst_lo.min(0).values
        hi = scene.inst.inst_hi.max(0).values
    else:
        a = scene.accel
        real = a.cluster_lo[:, 0] <= a.cluster_hi[:, 0]
        lo = a.cluster_lo[real].min(0).values
        hi = a.cluster_hi[real].max(0).values
    lm = LightManager()
    lm.add_directional_light([-0.5, -1.0, 0.3], [1.0, 0.95, 0.8], 2.0)
    lm.add_directional_light([-1.0, -0.05, 0.0], [0.8, 0.9, 1.0], 1.0)
    lm.add_point_light(((lo + hi) * 0.5).cpu().numpy(), intensity=3.0)
    return lm.device(dev), ps


def hdr_file() -> str:
    """The hdr config's map as bench.py:79-94 makes it: the 1024x2048
    synthetic sun-sky written once as a Radiance .hdr file (here under
    build/chip_smoke/ beside this file)."""
    from spt_tpu_torch.env import synthetic_equirect
    from spt_tpu_torch.io.hdr import write_hdr

    path = os.path.join(HERE, "build", "chip_smoke", "sunsky_1024.hdr")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        write_hdr(tmp, synthetic_equirect(1024))
        os.replace(tmp, path)
    return path


def workload(name, width, height, dev):
    """(SceneDesc, RenderConfig, env, lights, Camera) of a BASELINE config
    as the JAX package's bench.py builds it (the hdr config's map through
    the .hdr round trip: write_hdr -> load_environment)."""
    from spt_tpu_torch.camera import Camera, default_camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.env import load_environment
    from spt_tpu_torch.lights import LightManager, default_lights
    from spt_tpu_torch.scene import (build_cornell_box_scene,
                                     build_default_scene,
                                     build_hdr_glass_scene)

    aspect = width / height
    if name == "cornell":
        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=8)
        cam = Camera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                     fov_degrees=50.0, aspect_ratio=aspect)
        return (build_cornell_box_scene(), cfg, None,
                LightManager().device(dev), cam)
    if name == "hdr":
        lm = LightManager()
        lm.add_directional_light((0.4, -1.0, -0.3), (1.0, 0.95, 0.9), 1.0)
        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=6)
        cam = Camera(position=(0, 2.0, 6.0), target=(0, 1.0, 0.0),
                     fov_degrees=50.0, aspect_ratio=aspect)
        env = load_environment(hdr_file(), dev)
        return build_hdr_glass_scene(), cfg, env, lm.device(dev), cam
    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=6)
    return (build_default_scene(), cfg, None, default_lights(dev),
            default_camera(width, height))


def renderer(name, width, height, dev, **cfg_kw):
    from spt_tpu_torch.engine.renderer import Renderer

    desc, cfg, env, lights, cam = workload(name, width, height, dev)
    return Renderer(desc, cfg.replace(**cfg_kw), env=env, lights=lights,
                    camera=cam, device=dev)


def mesh_renderer(dev, **cfg_kw):
    from spt_tpu_torch.engine.renderer import Renderer

    desc, cfg, cam = port_mesh_scene(**cfg_kw)
    return Renderer(desc, cfg, camera=cam, device=dev)


# --- the plain versions on the card (comparison and timing only) --------------

@contextlib.contextmanager
def plain_path():
    """Route the wavefront's kernels to their plain PyTorch versions (which
    trace through the plain tracers themselves)."""
    from spt_tpu_torch.ops import cuda_bounce, cuda_env, cuda_sort

    swaps = [(cuda_bounce, "fused_frame", cuda_bounce.fused_frame_reference),
             (cuda_bounce, "fused_bounce", cuda_bounce.fused_bounce_reference),
             (cuda_sort, "sort_chunks", cuda_sort.sort_chunks_reference),
             (cuda_env, "env_sample", cuda_env.env_sample_reference)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    try:
        for m, name, ref in swaps:
            setattr(m, name, ref)
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def reset_counts():
    from spt_tpu_torch.integrators import wavefront
    from spt_tpu_torch.ops import cuda_bounce, cuda_env, cuda_sort, cuda_trace

    cuda_bounce.LAUNCHES = cuda_bounce.BOUNCE_LAUNCHES = 0
    cuda_sort.LAUNCHES = 0
    cuda_env.LAUNCHES = 0
    cuda_trace.CLOSEST_LAUNCHES = cuda_trace.ANY_LAUNCHES = 0
    cuda_trace.INST_CLOSEST_LAUNCHES = cuda_trace.INST_ANY_LAUNCHES = 0
    cuda_trace.STREAM_CLOSEST_LAUNCHES = cuda_trace.STREAM_ANY_LAUNCHES = 0
    wavefront.SORTED_SAMPLES.clear()


def read_counts() -> dict:
    from spt_tpu_torch.ops import cuda_bounce, cuda_env, cuda_sort, cuda_trace

    return {"fused_frame": cuda_bounce.LAUNCHES,
            "fused_bounce": cuda_bounce.BOUNCE_LAUNCHES,
            "sort_chunks": cuda_sort.LAUNCHES,
            "closest_hit": cuda_trace.CLOSEST_LAUNCHES,
            "any_hit": cuda_trace.ANY_LAUNCHES,
            "closest_hit_inst": cuda_trace.INST_CLOSEST_LAUNCHES,
            "any_hit_inst": cuda_trace.INST_ANY_LAUNCHES,
            "closest_hit_stream": cuda_trace.STREAM_CLOSEST_LAUNCHES,
            "any_hit_stream": cuda_trace.STREAM_ANY_LAUNCHES,
            "env_sample": cuda_env.LAUNCHES}


# --- timing -------------------------------------------------------------------

def _kernel_key(key: str, name: str) -> bool:
    """Whether a profiler event key is the kernel `name`, where name may
    carry a template argument: "trace_kernel<true>", "fused_frame_kernel<2>"."""
    if "<" not in name:
        return name in key
    base, flag = name[:-1].split("<")
    if base not in key:
        return False
    tail = key[key.index(base) + len(base):]
    forms = {"true": ("<true>", "<(bool)1>", "<1>"),
             "false": ("<false>", "<(bool)0>", "<0>")}.get(
                 flag, (f"<{flag}>", f"<(int){flag}>"))
    return tail.startswith(forms)


def profile_kernels(torch, fn, names, iters: int = 10) -> dict:
    """{name: (device ms per launch, launches the trace saw)} from a
    torch.profiler trace of `iters` calls of `fn` after one warm-up (the
    trace may miss a launch at its start, so launches are counted by the
    wrappers, not here)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        events = [e for e in prof.key_averages() if _kernel_key(e.key, name)]
        total = sum(e.self_device_time_total for e in events)
        count = sum(e.count for e in events)
        out[name] = (total / max(count, 1) / 1e3, count)
    return out


def kernel_device_ms(torch, fn, kernel_name: str, iters: int = 10,
                     launches_per_call: int = 1) -> float:
    """Mean device time of the named kernel per launch, from a trace of
    `iters` calls of `fn` that each launch it `launches_per_call` times (the
    trace has dropped up to a fifth of a short kernel's launches, and once
    every launch of a 0.04 ms kernel; the mean is over those it saw).  A
    trace that sees fewer than half is taken again; after two, the calls
    are timed with CUDA events behind a spin kernel (queued_device_ms)."""
    for _ in range(2):
        ms, count = profile_kernels(torch, fn, [kernel_name],
                                    iters)[kernel_name]
        if count >= iters * launches_per_call // 2 and ms > 0:
            return ms
    ms = queued_device_ms(torch, fn, iters) / launches_per_call
    log(f"  the profiler saw {count} launches of {kernel_name} in {iters} "
        f"calls; CUDA events behind a spin kernel: {ms:.4f} ms per launch")
    return ms


def queued_device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device ms per call of `fn`, for a call that launches one short
    kernel and nothing else: the calls are queued behind a spin kernel, so
    the CUDA events around them bracket device time only, not the host's
    enqueue (the profiler's trace drops most launches of a kernel this
    short)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # ~25 ms at the H100's ~2 GHz
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def time_call(torch, fn, warmup: int, iters: int) -> float:
    """Mean ms per call, CUDA events around `iters` calls after `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def check_image(np, r, name, out_dir, frames):
    hdr = r.hdr_image()
    img = r.image()
    if hdr.shape != (r.cfg.height, r.cfg.width, 3) or not np.isfinite(hdr).all():
        raise AssertionError(f"{name}: image not finite or of the wrong shape")
    if not (img.max() > 0.05):
        raise AssertionError(f"{name}: image is black")
    rays = r.last_stats.rays_per_bounce.cpu().numpy()
    if int(rays[0]) != frames * r.cfg.width * r.cfg.height:
        raise AssertionError(f"{name}: rays_per_bounce[0] = {rays[0]}, "
                             f"expected {frames * r.cfg.width * r.cfg.height}")
    path = os.path.join(out_dir, f"{name}_{r.cfg.width}x{r.cfg.height}.png")
    r.save_png(path)
    return rays, path


def rel_rmse(np, a, b) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


# --- small-scene phases (1-4) -------------------------------------------------

def simt_efficiency(torch, lane_bounces, group: int) -> float:
    """Share of the slots that do work when lanes run in pixel order in
    groups of `group` (a warp, a block) and a group runs as long as its
    longest path: lane-bounces over group size x the longest path in the
    group, summed over the groups (the ragged end padded with idle lanes)."""
    c = lane_bounces.to(torch.int64)
    c = torch.nn.functional.pad(c, (0, -c.shape[0] % group)).reshape(-1, group)
    return float(c.sum()) / max(float(c.amax(1).sum()) * group, 1.0)


def phase_kernel_vs_plain(torch, cuda_bounce, dev, smi):
    """Phase 1.  Returns the default-scene numbers for the kernel line."""
    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.ops import cuda_lib
    from spt_tpu_torch.scene import flatten_scene

    result = {}
    for name in ("default", "cornell", "hdr"):
        desc, cfg, _, lights, cam = workload(name, W, H, dev)
        scene = flatten_scene(desc, dev)
        ps = transport.gen_primary(cfg, cam.rays(dev), 0)
        k = cuda_bounce.fused_frame(cfg, scene, lights, ps)
        # the plain version, bounce by bounce: its tracers' operations and
        # each lane's bounces (the lanes alive when each bounce starts)
        with capture_calls([(cuda_bounce, "fused_bounce_reference")]) as bounces:
            p, ops = _walk_ops(torch, scene,
                               lambda: cuda_bounce.fused_frame_reference(
                                   cfg, scene, lights, ps))
        lane_bounces = sum(a[3].alive.to(torch.int32) for _, a, _ in bounces)
        torch.cuda.synchronize()
        planes = {"radiance": (_v(torch, k[0]), _v(torch, p[0])),
                  "direction": (_v(torch, k[1]), _v(torch, p[1])),
                  "throughput": (_v(torch, k[2]), _v(torch, p[2])),
                  "missed_ever": (k[3], p[3])}
        max_abs = check_planes(torch, f"fused_frame small, {name} {W}x{H} "
                               f"d{cfg.max_depth} from bounce 0", planes,
                               phase=1, exact=tuple(planes))
        rk, rp = k[4].tolist(), p[4].tolist()
        log(f"phase 1 {name}: rays_per_bounce kernel {rk} plain {rp} "
            f"(equal: {rk == rp})")
        if rk != rp:
            raise AssertionError(f"fused_frame's rays per bounce differ from "
                                 f"the plain version's on {name}")
        # times at the main path's shape: the kernel's own device time,
        # the wrapper's (table packing and counter included) and the plain
        # version's
        call = lambda: cuda_bounce.fused_frame(cfg, scene, lights, ps)
        wrapper_ms = time_call(torch, call, warmup=3, iters=20)
        ms = kernel_device_ms(torch, call, cuda_bounce.SMALL_KERNEL)
        plain_ms = time_call(torch, lambda: cuda_bounce.fused_frame_reference(
            cfg, scene, lights, ps), warmup=1, iters=3)
        # bytes a lane: 12 float planes, the int64 RNG word and two byte
        # flags in (58 B), 9 float planes and the missed byte out (37 B);
        # then the (max_depth + 1) int64 counts; operations: the triangle
        # and sphere tests of every closest-hit, shadow and NEE ray
        # (_brute_trace_ops)
        b = bound(cfg.width * cfg.height * (12 * 4 + 8 + 2 + 9 * 4 + 1)
                  + (cfg.max_depth + 1) * 8, ops)
        smem = cuda_bounce.shared_bytes(cfg, scene, lights)
        info = cuda_lib.kernel_info({"fused_frame": smem})["fused_frame"]
        log(f"phase 1 fused_frame small at {name} {W}x{H} d{cfg.max_depth}: "
            f"kernel {ms:.4f} ms (device time), wrapper {wrapper_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms per call, bound {b[0]:.4f} ms ({b[1]}; "
            f"{ops_note(ops)}); {info['registers']} registers, "
            f"{info['local_bytes']} B local, {smem} B shared a block, "
            f"{info['blocks_per_sm']} blocks/SM; SIMT efficiency of the "
            f"plain version's paths in pixel order: warps of 32 "
            f"{simt_efficiency(torch, lane_bounces, 32):.4f}, blocks of 128 "
            f"{simt_efficiency(torch, lane_bounces, 128):.4f} [{smi}]")
        if name == "default":
            result = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                          bound=b)
    return result


def phase_main_path(torch, np, cuda_bounce, dev, out_dir):
    """Phase 2: the small-scene Renderer on the card; returns the launch
    counts of fused_frame and of the environment sampler (on hdr, whose map
    made the .hdr round trip)."""
    from spt_tpu_torch.ops import cuda_env

    frames = 8
    renderers = {name: renderer(name, W, H, dev)
                 for name in ("default", "cornell", "hdr")}
    torch.cuda.synchronize()
    reset_counts()
    for name, r in renderers.items():
        before, env_before = cuda_bounce.LAUNCHES, cuda_env.LAUNCHES
        r.render_frames(frames)
        torch.cuda.synchronize()
        grew = cuda_bounce.LAUNCHES - before
        env_grew = cuda_env.LAUNCHES - env_before
        rays, path = check_image(np, r, name, out_dir, frames)
        log(f"phase 2 {name} {W}x{H} d{r.cfg.max_depth}: {frames} frames, "
            f"LAUNCHES +{grew}, env_sample +{env_grew}, rays_per_bounce "
            f"{rays.tolist()}, mean hdr {float(r.hdr_image().mean()):.6g}, "
            f"png {path}")
        if grew != frames:
            raise AssertionError(f"{name}: LAUNCHES grew by {grew}, "
                                 f"expected {frames}")
        if env_grew != (frames if name == "hdr" else 0):
            raise AssertionError(f"{name}: env_sample grew by {env_grew}")
    counts = read_counts()
    if counts["fused_frame"] == 0:
        raise AssertionError("the main path launched no kernel")
    return counts["fused_frame"], counts["env_sample"]


def phase_image_vs_plain(torch, np, dev):
    """Phase 3: kernel image vs plain image, 8 frames at 320x240."""
    for name in ("default", "cornell", "hdr"):
        a = renderer(name, 320, 240, dev)
        a.render_frames(8)
        b = renderer(name, 320, 240, dev)
        with plain_path():
            b.render_frames(8)
        rel = rel_rmse(np, a.hdr_image(), b.hdr_image())
        log(f"phase 3 {name} 320x240 8 frames: kernel vs plain relative "
            f"RMSE {rel * 100:.5f} % (limit 1 %)")
        if not rel < 0.01:
            raise AssertionError(f"{name}: kernel image differs from plain")


def phase_times(torch, dev, smi):
    """Phase 4: end-to-end ms/frame and Mrays/s, kernel and plain path."""
    from spt_tpu_torch.bench import count_rays, shadow_rays_per_surface_lane

    out = {}
    for label, frames, ctx in (("kernel", 32, contextlib.nullcontext),
                               ("plain", 3, plain_path)):
        r = renderer("default", W, H, dev)
        n_shadow = shadow_rays_per_surface_lane(r)
        with ctx():
            r.render_frames(2)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            r.render_frames(frames)
            t1.record()
            torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / frames
        mrays = count_rays(r.last_stats, n_shadow) / frames / (ms * 1e-3) / 1e6
        out[label] = ms
        busy = ""
        if label == "kernel":
            ms_busy, launches = device_busy_ms(torch, lambda: r.render_frames(1))
            busy = (f"; device busy {ms_busy:.4f} ms/frame over {launches:.1f} "
                    f"launches a frame (kernels, copies and fills; profiled)")
        log(f"phase 4 {label} path, default {W}x{H} d6, {frames} frames: "
            f"{ms:.4f} ms/frame, {mrays:.2f} Mrays/s{busy} [{smi}]")
    return out


# --- mesh phases (5-9) --------------------------------------------------------

def _mesh_inputs(torch, dev):
    """(cfg, scene, lights, camera rays) of the mesh scene at MWxMH."""
    from spt_tpu_torch.lights import default_lights
    from spt_tpu_torch.ops import cuda_bounce
    from spt_tpu_torch.scene import flatten_scene

    desc, cfg, cam = port_mesh_scene()
    scene = flatten_scene(desc, dev)
    mode = cuda_bounce._accel_mode(scene)
    if mode != "resident":
        raise AssertionError(f"mesh scene in accel mode {mode!r}, expected "
                             "'resident'")
    return cfg, scene, default_lights(dev), cam.rays(dev)


def _cluster_trace_ops(torch, scene, o, d, tmin, tmax, t_end, blocked=None):
    """The operations the resident tracer needs on these rays, counted from
    the plain version's result: every lane with a non-empty interval
    slab-tests every real cluster box (~24 flops) and every sphere (~20),
    and runs the 64 Moller-Trumbore tests (~40 flops each) of every cluster
    box its final bound min(tmax, t_end) still reaches.  A blocked any-hit
    lane counts one test."""
    from spt_tpu_torch.ops import cuda_trace as ct
    from spt_tpu_torch.ops.vec3 import Vec3

    a = scene.accel
    n = o.x.shape[0]
    tmax = torch.broadcast_to(torch.as_tensor(tmax, device=o.x.device,
                                              dtype=torch.float32), (n,))
    live = tmax > tmin
    if blocked is not None:
        live = live & ~blocked
    bound = torch.minimum(tmax, t_end).clamp(max=1e30)
    real = a.cluster_lo[:, 0] <= a.cluster_hi[:, 0]
    lo, hi = a.cluster_lo[real], a.cluster_hi[real]
    ops = float(live.sum()) * (int(real.sum()) * 24 + scene.num_spheres * 20)
    for s0 in range(0, n, 16384):
        sl = slice(s0, min(n, s0 + 16384))
        tn, tf = ct._slab(lo, hi, Vec3(*(c[sl] for c in o)),
                          Vec3(*(ct._inv_dir(c[sl]) for c in d)), tmin,
                          bound[sl])
        ops += float(((tn <= tf) & live[sl][None]).sum()) * a.cluster_size * 40
    if blocked is not None:
        ops += 20.0 * int((blocked & (tmax > tmin)).sum())
    return ops


def _brute_trace_ops(torch, scene, o, d, tmin, tmax, t_end, blocked=None):
    """The operations the small form's brute-force loops need on these rays:
    every lane with a non-empty interval tests every triangle (~30 flops)
    and every sphere (~20); a blocked any-hit lane, which stops at its first
    blocker, counts one test."""
    n = o.x.shape[0]
    tmax = torch.broadcast_to(torch.as_tensor(tmax, device=o.x.device,
                                              dtype=torch.float32), (n,))
    live = tmax > tmin
    per_lane = scene.num_triangles * 30 + scene.num_spheres * 20
    if blocked is None:
        return float(live.sum()) * per_lane
    return (float((live & ~blocked).sum()) * per_lane
            + 30.0 * int((live & blocked).sum()))


def _walk_ops(torch, scene, plain):
    """(plain(), operations): runs the plain version of a fused kernel and
    counts, from the plain tracers' own results, the operations of every
    walk the kernel's tracer makes on the scene: each live lane's closest
    hit to its final t and each shadow or NEE ray that shade_core traces
    (intersect_v / occluded_v)."""
    from spt_tpu_torch.ops import cuda_bounce
    from spt_tpu_torch.ops import intersect as isect

    trace_ops = {None: _brute_trace_ops, "resident": _cluster_trace_ops,
                 "instanced": _inst_trace_ops,
                 "stream": _stream_trace_ops}[cuda_bounce._accel_mode(scene)]

    with capture_calls([(isect, "intersect_v"), (isect, "occluded_v")],
                       results=True) as calls:
        out = plain()
    ops = 0.0
    for name, args, kw, res in calls:
        _, o, d = args
        tmin, tmax = kw["tmin"], kw["tmax"]
        if name == "intersect_v":
            ops += trace_ops(torch, scene, o, d, tmin, tmax, res.t)
        else:
            t_end = torch.as_tensor(tmax, device=o.x.device,
                                    dtype=torch.float32)
            ops += trace_ops(torch, scene, o, d, tmin, tmax, t_end,
                             blocked=res)
    return out, ops


@contextlib.contextmanager
def capture_calls(targets, results=False):
    """Record (name, args, kwargs) of every call of the (module, function
    name) targets made while the context is open, with the call's result
    appended when `results`; the calls still run."""
    calls = []
    saved = [(m, name, getattr(m, name)) for m, name in targets]

    def recording(name, fn):
        def call(*args, **kw):
            if not results:
                calls.append((name, args, kw))
                return fn(*args, **kw)
            out = fn(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return call

    try:
        for m, name, fn in saved:
            setattr(m, name, recording(name, fn))
        yield calls
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def lanes_off(torch, k, p):
    """(N,) mask of the lanes where the kernel's plane k, (N,) or (N, 3),
    differs from the plain version's p: by more than 1e-3 for floats (NaN
    against a number counts), at all for the others."""
    if k.dtype.is_floating_point:
        off = ~((k == p) | (torch.isnan(k) & torch.isnan(p))
                | ((k - p).abs() <= 1e-3))
    else:
        off = k != p
    return off.any(-1) if off.dim() > 1 else off


def ulps_apart(torch, k, p):
    """(share of lanes not bit-equal, largest distance in float32 ulps over
    the lanes where both are finite) of two float32 planes."""
    k, p = k.reshape(k.shape[0], -1), p.reshape(p.shape[0], -1)
    unequal = ~((k == p) | (torch.isnan(k) & torch.isnan(p))).all(-1)

    def ordered(x):   # float32 bits as integers in the order of the values
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    fin = torch.isfinite(k) & torch.isfinite(p)
    d = (ordered(k) - ordered(p)).abs()[fin]
    return float(unequal.float().mean()), int(d.max()) if d.numel() else 0


def check_planes(torch, what, planes: dict, phase: int = 5,
                 exact=()) -> float:
    """Hold every plane of a kernel's result against the plain version's;
    fails when more than 0.1 % of the lanes differ in any one plane (by
    more than 1e-3 for floats), and when a plane named in `exact` is not
    bit-equal (equal, for an integer or boolean plane) on every lane.  Reports, per float plane, the share of
    lanes that are not bit-equal and the largest distance in ulps.
    Returns the largest finite |kernel - plain| over the float and the
    boolean planes."""
    worst, report, bad = 0.0, [], []
    for name, (k, p) in planes.items():
        off = lanes_off(torch, k, p)
        frac = float(off.float().mean())
        if k.dtype == torch.float32:
            neq, ulps = ulps_apart(torch, k, p)
            report.append(f"{name} {frac * 100:.4f} % (not bit-equal "
                          f"{neq * 100:.5f} %, max {ulps} ulp"
                          f"{', limit 0' if name in exact else ''})")
            if name in exact and neq > 0:
                bad.append(name)
        else:
            report.append(f"{name} {frac * 100:.4f} %"
                          f"{' (limit 0)' if name in exact else ''}")
            if name in exact and frac > 0:
                bad.append(name)
        if k.dtype.is_floating_point:
            d = (k - p).abs()
            d = d[torch.isfinite(d)]
            if d.numel():
                worst = max(worst, float(d.max()))
        elif k.dtype == torch.bool:
            worst = max(worst, float(off.any()))
        if frac > 1e-3 and name not in bad:
            bad.append(name)
    log(f"phase {phase} {what}: lanes off per plane: {', '.join(report)} (limit "
        f"0.1 % each), max |d| {worst:.6g}")
    if bad:
        raise AssertionError(f"{what} disagrees with its plain version in "
                             f"{bad}")
    return worst


def _v(torch, x):
    return torch.stack([*x], -1)


def _hit_planes(torch, hk, hp):
    """The planes of two closest-hit records; normal and material only on
    the lanes both hit."""
    both = (hk.kind != 0) & (hp.kind != 0)
    return {"t": (hk.t, hp.t), "kind": (hk.kind, hp.kind),
            "mat_id": (torch.where(both, hk.mat_id, 0),
                       torch.where(both, hp.mat_id, 0)),
            "normal": (torch.where(both[:, None], _v(torch, hk.normal), 0.0),
                       torch.where(both[:, None], _v(torch, hp.normal), 0.0))}


def _state_planes(torch, ks, km, ps_, pm):
    """The planes of two fused_bounce results (PathState, missed)."""
    out = {name: (_v(torch, getattr(ks, name)), _v(torch, getattr(ps_, name)))
           for name in ("origin", "direction", "throughput", "radiance")}
    out.update(rng=(ks.rng, ps_.rng), alive=(ks.alive, ps_.alive),
               emission_ok=(ks.emission_ok, ps_.emission_ok),
               missed=(km, pm))
    return out


def _trace_shared_bytes(fn_name, acc, scene) -> int:
    """Dynamic shared memory of a standalone tracer's block on this scene."""
    from spt_tpu_torch.ops import cuda_lib
    from spt_tpu_torch.ops import cuda_trace as ct

    inputs = {"closest_hit": ct._resident_inputs, "any_hit": ct._resident_inputs,
              "inst_closest_hit": ct._inst_inputs, "inst_any_hit": ct._inst_inputs,
              "stream_closest_hit": ct._stream_inputs,
              "stream_any_hit": ct._stream_inputs}[fn_name]
    tables, _, dims = inputs(acc, scene)[:3]
    return cuda_lib.shared_bytes(4 * tables.numel() + 2 * 8 * dims[0], True)


def log_occupancy(phase: int, smi: str, smem: dict) -> dict:
    """Registers, spill bytes, dynamic shared memory per block and blocks
    per SM of each mesh form in `smem` (name -> shared bytes of its main
    path's launch); logs and returns them."""
    from spt_tpu_torch.ops import cuda_lib

    info = cuda_lib.kernel_info(smem)
    rows = {k: info[k] for k in smem}
    log(f"phase {phase} occupancy at the main path's tables: " + "; ".join(
        f"{k} {v['registers']} registers, {v['local_bytes']} B local, "
        f"{v['smem_bytes']} B shared a block, {v['blocks_per_sm']} blocks/SM"
        for k, v in rows.items()) + f" [{smi}]")
    return rows


def _over_calls(torch, fn, calls, kernel_name, plain, plain_iters=2):
    """(device ms per launch, plain ms per call), each the mean over the
    recorded calls: the kernel from a torch.profiler trace of all of them,
    the plain version with CUDA events."""
    ms = kernel_device_ms(
        torch, lambda: [fn(*a, **k) for a, k in calls], kernel_name,
        iters=10, launches_per_call=len(calls))
    plain_ms = time_call(torch, lambda: [plain(*a, **k) for a, k in calls],
                         warmup=1, iters=plain_iters) / len(calls)
    return ms, plain_ms


def _same_bits(torch, a, b) -> bool:
    """Whether two tensors of one dtype hold the same bits."""
    if a.dtype.is_floating_point:
        a = a.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()])
        b = b.view(a.dtype)
    return torch.equal(a, b)


def check_sort(torch, phase, what, key, ops, chunk) -> float:
    """sort_chunks against its plain version (a stable torch.sort and a
    gather per plane): the keys, the lane ids and every plane bit for bit.
    Returns the largest |kernel key - plain key| (0)."""
    from spt_tpu_torch.ops import cuda_sort

    sk, lane, so = cuda_sort.sort_chunks(key, ops, chunk)
    rk, rl, ro = cuda_sort.sort_chunks_reference(key, ops, chunk)
    keys_ok = torch.equal(sk, rk)
    lanes_ok = torch.equal(lane, rl)
    planes_ok = all(_same_bits(torch, a, b) for a, b in zip(so, ro))
    log(f"phase {phase} sort_chunks {what}: chunk {chunk} x "
        f"{key.shape[0] // chunk} chunks, {len(ops)} planes, "
        f"{int((key == 0xFFFFFFFF).sum())} dead lanes: equal bit for bit to "
        f"the plain version's keys {keys_ok}, lane ids {lanes_ok}, planes "
        f"{planes_ok}")
    if not (keys_ok and lanes_ok and planes_ok):
        raise AssertionError(f"sort_chunks wrong ({what})")
    return float((sk - rk).abs().max())


def sort_bound(torch, key, ops, chunk):
    """(bytes, operations) of one sort: the key in (8 B), every plane in and
    out, the keys and lane ids out (8 B each); the radix passes these keys
    need (a pass whose 8-bit digit is one value over a chunk is skipped),
    about 6 integer operations a key a pass."""
    k = key.reshape(-1, chunk)
    passes = 0
    for p in range(4):
        digit = (k >> (8 * p)) & 255
        passes += int((digit.amax(1) != digit.amin(1)).sum())
    return (key.shape[0] * (8 + 2 * sum(x.element_size() for x in ops) + 16),
            passes * chunk * 6.0)


def sort_at_calls(torch, phase, label, calls, smi) -> dict:
    """K5 at a frame's recorded sort_chunks calls: each held to its plain
    version bit for bit, then the kernel's device time per launch, the
    time of torch.sort + gathers (the plain version, and the one-call
    library equivalent) and the bound, means over the calls."""
    from spt_tpu_torch.ops import cuda_sort

    if not calls:
        raise AssertionError(f"{label} frame made no sort_chunks call")
    err = nbytes = flops = 0.0
    for i, (args, kw) in enumerate(calls):
        key, ops, chunk = args
        err = max(err, check_sort(torch, phase, f"{label} call {i + 1} of "
                                  f"{len(calls)}", key, ops, chunk))
        by, fl = sort_bound(torch, key, ops, chunk)
        nbytes, flops = nbytes + by, flops + fl
    ms, lib_ms = _over_calls(torch, cuda_sort.sort_chunks, calls,
                             "sort_chunks_kernel",
                             cuda_sort.sort_chunks_reference, plain_iters=10)
    b = bound(nbytes / len(calls), flops / len(calls))
    log(f"phase {phase} sort_chunks at {label} {len(calls)} calls: kernel "
        f"{ms:.4f} ms per launch (device time), torch.sort + gathers "
        f"{lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; "
        f"{ops_note(flops / len(calls))}) [{smi}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=lib_ms, bound=b,
                library_ms=lib_ms)


def phase_mesh_kernels(torch, np, dev, smi):
    """Phase 5: every mesh kernel against its plain version on the card, at
    the inputs its main path gives it (recorded from one frame of that
    path) and on the checks' own rays and keys.  Returns the kernel-line
    numbers per kernel, measured at the main path's inputs."""
    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.ops import cuda_bounce, cuda_lib, cuda_sort, cuda_trace
    from spt_tpu_torch.ops.vec3 import Vec3

    cfg, scene, lights, cam = _mesh_inputs(torch, dev)
    a = scene.accel
    n = cfg.width * cfg.height
    out = {}
    log(f"phase 5 mesh scene: {scene.num_triangles} triangles, "
        f"{scene.num_spheres} sphere, {a.num_clusters} clusters of "
        f"{a.cluster_size}, tri_pack {tuple(a.tri_pack.shape)}, accel mode "
        f"{cuda_bounce._accel_mode(scene)}")

    # --- K4 on camera rays and on random rays ---
    ps0 = transport.gen_primary(cfg, cam, 0)
    g = torch.Generator(device="cpu").manual_seed(7)
    real = a.cluster_lo[:, 0] <= a.cluster_hi[:, 0]
    lo = a.cluster_lo[real].min(0).values.cpu()
    hi = a.cluster_hi[real].max(0).values.cpu()
    ro = (lo - 0.5 + (hi - lo + 1.0) * torch.rand((n, 3), generator=g)).to(dev)
    rd = torch.randn((n, 3), generator=g)
    rd = (rd / rd.norm(dim=1, keepdim=True)).to(dev)
    ray_sets = {"camera": (ps0.origin, ps0.direction),
                "random": (Vec3(*ro.unbind(1)), Vec3(*rd.unbind(1)))}
    worst = {"closest_hit": 0.0, "any_hit": 0.0}
    for rname, (o, d) in ray_sets.items():
        o = Vec3(*(c.contiguous() for c in o))
        d = Vec3(*(c.contiguous() for c in d))
        hk = cuda_trace.closest_hit(a, scene, o, d, 0.0, 1e30)
        hp = cuda_trace.closest_hit_reference(a, scene, o, d, 0.0, 1e30)
        worst["closest_hit"] = max(worst["closest_hit"], check_planes(
            torch, f"closest_hit on {n} {rname} rays "
            f"({int(torch.isfinite(hp.t).sum())} hits)",
            _hit_planes(torch, hk, hp)))
        tmax = torch.full((n,), 4.0, device=dev)
        bk = cuda_trace.any_hit(a, scene, o, d, 1e-4, tmax)
        bp = cuda_trace.any_hit_reference(a, scene, o, d, 1e-4, tmax)
        worst["any_hit"] = max(worst["any_hit"], check_planes(
            torch, f"any_hit on {n} {rname} rays ({int(bp.sum())} blocked)",
            {"blocked": (bk, bp)}))

    # --- K4 at its main path's inputs: one frame of the regen path ---
    r = mesh_renderer(dev, integrator="regen")
    with capture_calls([(cuda_trace, "closest_hit"),
                        (cuda_trace, "any_hit")]) as calls:
        r.render_frames(1)
        torch.cuda.synchronize()
    for kname, kern, ref, kernel_name in (
            ("closest_hit", cuda_trace.closest_hit,
             cuda_trace.closest_hit_reference, "trace_kernel<false>"),
            ("any_hit", cuda_trace.any_hit, cuda_trace.any_hit_reference,
             "trace_kernel<true>")):
        mine = [(args, kw) for name, args, kw in calls if name == kname]
        if not mine:
            raise AssertionError(f"the regen frame made no {kname} call")
        nbytes = flops = 0.0
        for i, (args, kw) in enumerate(mine):
            _, _, o, d, tmin, tmax = args
            rays = o.x.shape[0]
            pk, pp = kern(*args, **kw), ref(*args, **kw)
            if kname == "closest_hit":
                planes = _hit_planes(torch, pk, pp)
                flops += _cluster_trace_ops(torch, scene, o, d, tmin, tmax,
                                            pp.t)
                nbytes += rays * (7 * 4 + 24)
            else:
                planes = {"blocked": (pk, pp)}
                t_end = torch.as_tensor(tmax, device=o.x.device,
                                        dtype=torch.float32)
                flops += _cluster_trace_ops(torch, scene, o, d, tmin, tmax,
                                            t_end, blocked=pp)
                nbytes += rays * (7 * 4 + 1)
            worst[kname] = max(worst[kname], check_planes(
                torch, f"{kname} regen call {i + 1} of {len(mine)} ({rays} "
                f"rays)", planes))
        ms, plain_ms = _over_calls(torch, kern, mine, kernel_name, ref)
        b = bound((nbytes + len(mine) * a.tri_pack.numel() * 4) / len(mine),
                  flops / len(mine))
        out[kname] = dict(max_abs_err=worst[kname], ms=ms, plain_ms=plain_ms,
                          bound=b, library_ms=None)
        log(f"phase 5 {kname} at the regen frame's {len(mine)} calls: kernel "
            f"{ms:.4f} ms per launch (device time), plain {plain_ms:.4f} ms, "
            f"bound {b[0]:.4f} ms ({b[1]}; {ops_note(flops / len(mine))}) "
            f"[{smi}]")

    # --- K3, K1 resident and K5 at their main path's inputs: one frame of
    # --- the sorted mesh frame ---
    r = mesh_renderer(dev)
    with capture_calls([(cuda_bounce, "fused_bounce"),
                        (cuda_bounce, "fused_frame"),
                        (cuda_sort, "sort_chunks")]) as calls:
        r.render_frames(1)
        torch.cuda.synchronize()
    by_name = {name: [(args, kw) for nm, args, kw in calls if nm == name]
               for name in ("fused_bounce", "fused_frame", "sort_chunks")}
    log(f"phase 5 the sorted frame's calls: "
        f"{ {k: len(v) for k, v in by_name.items()} }")

    mine = by_name["fused_bounce"]
    nbytes = flops = 0.0
    worst_b = 0.0
    for args, kw in mine:
        bcfg, bscene, blights, bps, bounce, is_last = args
        ks, km = cuda_bounce.fused_bounce(*args, **kw)
        (ps_, pm), ops = _walk_ops(
            torch, scene,
            lambda: cuda_bounce.fused_bounce_reference(*args, **kw))
        lanes = bps.num_paths
        worst_b = max(worst_b, check_planes(
            torch, f"fused_bounce bounce {bounce} ({lanes} lanes, "
            f"{int(bps.alive.sum())} alive)",
            _state_planes(torch, ks, km, ps_, pm)))
        # 15 planes in, 16 out (12 float, int64 rng, three byte flags)
        nbytes += lanes * (15 * 4 + 12 * 4 + 8 + 3) + a.tri_pack.numel() * 4
        flops += ops
    ms, plain_ms = _over_calls(torch, cuda_bounce.fused_bounce, mine,
                               "fused_bounce_kernel<1>",
                               cuda_bounce.fused_bounce_reference)
    b = bound(nbytes / len(mine), flops / len(mine))
    out["fused_bounce"] = dict(max_abs_err=worst_b, ms=ms, plain_ms=plain_ms,
                               bound=b, library_ms=None)
    log(f"phase 5 fused_bounce at the sorted frame's {len(mine)} calls: "
        f"kernel {ms:.4f} ms per launch (device time), plain {plain_ms:.4f} "
        f"ms, bound {b[0]:.4f} ms ({b[1]}; {ops_note(flops / len(mine))}) "
        f"[{smi}]")

    def check_frame(what, args, kw):
        """fused_frame against its plain version: every plane per lane, and
        rays_per_bounce within 0.1 %.  Returns (max |d|, the operations of
        its walks)."""
        fk = cuda_bounce.fused_frame(*args, **kw)
        fp, ops = _walk_ops(torch, args[1],
                            lambda: cuda_bounce.fused_frame_reference(*args, **kw))
        rk, rp = fk[4].cpu().numpy(), fp[4].cpu().numpy()
        ray_diff = float((abs(rk - rp) / rp.clip(min=1)).max())
        worst_f = check_planes(
            torch, f"{what}; rays_per_bounce kernel {rk.tolist()} plain "
            f"{rp.tolist()}, max rel diff {ray_diff * 100:.4f} % (limit "
            f"0.1 %)",
            {"radiance": (_v(torch, fk[0]), _v(torch, fp[0])),
             "direction": (_v(torch, fk[1]), _v(torch, fp[1])),
             "throughput": (_v(torch, fk[2]), _v(torch, fp[2])),
             "missed": (fk[3], fp[3])})
        if ray_diff > 1e-3:
            raise AssertionError(f"{what}: rays_per_bounce differ from the "
                                 "plain version's")
        return worst_f, ops

    mine = by_name["fused_frame"]
    if len(mine) != 1:
        raise AssertionError(f"the sorted frame called fused_frame "
                             f"{len(mine)} times")
    (args, kw), = mine
    fps = args[3]
    start = kw.get("start_bounce", args[4] if len(args) > 4 else 0)
    worst_f, ops = check_frame(
        f"fused_frame resident from bounce {start} ({fps.num_paths} lanes, "
        f"{int(fps.alive.sum())} alive)", args, kw)
    ms, plain_ms = _over_calls(torch, cuda_bounce.fused_frame, mine,
                               "fused_frame_kernel<1>",
                               cuda_bounce.fused_frame_reference, plain_iters=3)
    b = bound(fps.num_paths * 26 * 4 + a.tri_pack.numel() * 4, ops)
    out["fused_frame_resident"] = dict(max_abs_err=worst_f, ms=ms,
                                       plain_ms=plain_ms, bound=b,
                                       library_ms=None)
    log(f"phase 5 fused_frame resident at the sorted frame's call: kernel "
        f"{ms:.4f} ms (device time), plain {plain_ms:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]}; {ops_note(ops)}) [{smi}]")

    # the resident fused_frame over every bounce of all lanes: the route of
    # ray_sort=False and of lane counts the sort cannot take
    check_frame(f"fused_frame resident from bounce 0 ({n} lanes)",
                (cfg, scene, lights, ps0), {})
    ms0 = kernel_device_ms(torch, lambda: cuda_bounce.fused_frame(
        cfg, scene, lights, ps0), "fused_frame_kernel<1>")
    log(f"phase 5 fused_frame resident from bounce 0 at {MW}x{MH} "
        f"d{cfg.max_depth}: kernel {ms0:.4f} ms (device time) [{smi}]")

    log_occupancy(5, smi, {
        "closest_hit": _trace_shared_bytes("closest_hit", a, scene),
        "any_hit": _trace_shared_bytes("any_hit", a, scene),
        "fused_bounce_resident": cuda_bounce.shared_bytes(*args[:3]),
        "fused_frame_resident": cuda_bounce.shared_bytes(*args[:3])})

    # --- K5: at the sorted frame's inputs, then with 15 random planes ---
    out["sort_chunks"] = sort_at_calls(torch, 5, "the sorted frame's",
                                       by_name["sort_chunks"], smi)
    for chunk in sorted({args[2] for args, _ in by_name["sort_chunks"]}
                        | {8192, 32768}):
        info = cuda_lib.kernel_info(sort_chunk=chunk)["sort_chunks"]
        log(f"phase 5 sort_chunks launch at chunk {chunk}: clusters of "
            f"{info['cluster']} blocks x {info['threads']} threads, "
            f"{info['registers']} registers, {info['local_bytes']} B local, "
            f"{info['smem_bytes']} B shared a block, {info['active_clusters']} "
            f"clusters active per device [{smi}]")

    g = torch.Generator(device="cpu").manual_seed(11)
    for chunk, width in ((8192, n), (32768, 65536)):
        key = torch.randint(0, 2 ** 32, (width,), generator=g,
                            dtype=torch.int64)
        key[torch.rand(width, generator=g) < 0.5] = 0xFFFFFFFF  # dead lanes
        key = key.to(dev)
        ops = ([torch.randn(width, generator=g).to(dev) for _ in range(12)]
               + [torch.randint(0, 2 ** 32, (width,), generator=g).to(dev),
                  torch.randint(0, 7, (width,), generator=g,
                                dtype=torch.int32).to(dev),
                  torch.arange(width, dtype=torch.int64, device=dev)])
        check_sort(torch, 5, "random keys", key, ops, chunk)
        ms = kernel_device_ms(torch, lambda: cuda_sort.sort_chunks(
            key, ops, chunk), "sort_chunks_kernel")
        lib_ms = time_call(torch, lambda: cuda_sort.sort_chunks_reference(
            key, ops, chunk), warmup=2, iters=10)
        b = bound(*sort_bound(torch, key, ops, chunk))
        log(f"phase 5 sort_chunks random keys, chunk {chunk} x {width}: "
            f"kernel {ms:.4f} ms (device time), torch.sort + 15 gathers "
            f"{lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) [{smi}]")
    return out


def phase_mesh_main_path(torch, np, dev, out_dir):
    """Phase 6: the mesh Renderer on the card; returns the launch counts."""
    from spt_tpu_torch.integrators import wavefront
    from spt_tpu_torch.ops import cuda_bounce

    frames = 8
    r = mesh_renderer(dev)
    if cuda_bounce._accel_mode(r.scene) != "resident":
        raise AssertionError("mesh scene not in accel mode 'resident'")
    torch.cuda.synchronize()
    reset_counts()
    r.render_frames(frames)
    torch.cuda.synchronize()
    counts = read_counts()
    branches = dict(wavefront.SORTED_SAMPLES)
    rays, path = check_image(np, r, "mesh", out_dir, frames)
    log(f"phase 6 mesh {MW}x{MH} d{MESH_DEPTH}: {frames} frames, launches "
        f"{counts}, sorted-frame branches {branches}, rays_per_bounce "
        f"{rays.tolist()}, mean hdr {float(r.hdr_image().mean()):.6g}, png "
        f"{path}")
    if sum(branches.values()) != frames:
        raise AssertionError(f"the sorted frame ran {branches}, expected "
                             f"{frames} samples")
    if counts["fused_bounce"] != 3 * frames or counts["fused_frame"] != frames:
        raise AssertionError(f"launch counts {counts}: expected fused_bounce "
                             f"{3 * frames} and fused_frame {frames}")
    want_sorts = 3 * branches.get("full_width", 0) + 4 * branches.get(
        "condensed", 0)
    if counts["sort_chunks"] != want_sorts:
        raise AssertionError(f"sort_chunks launched {counts['sort_chunks']} "
                             f"times, expected {want_sorts}")
    return counts, branches


def phase_regen_path(torch, np, dev, out_dir):
    """Phase 7: integrator "regen" on the mesh scene traces through the
    standalone cluster tracer; returns the launch counts."""
    frames = 2
    r = mesh_renderer(dev, integrator="regen")
    torch.cuda.synchronize()
    reset_counts()
    r.render_frames(frames)
    torch.cuda.synchronize()
    counts = read_counts()
    rays, path = check_image(np, r, "mesh_regen", out_dir, frames)
    log(f"phase 7 mesh regen {MW}x{MH} d{MESH_DEPTH}: {frames} frames, "
        f"launches {counts}, rays_per_bounce {rays.tolist()}, png {path}")
    if counts["closest_hit"] == 0 or counts["any_hit"] == 0:
        raise AssertionError(f"the regen path launched {counts}")
    return counts


def phase_mesh_images(torch, np, dev):
    """Phase 8: sorted kernel path vs unsorted kernel path vs plain path."""
    frames = 8
    imgs, rays = {}, {}
    for label, kw, ctx in (("sorted", {}, contextlib.nullcontext),
                           ("unsorted", {"ray_sort": False},
                            contextlib.nullcontext),
                           ("plain", {}, plain_path)):
        r = mesh_renderer(dev, **kw)
        t0 = time.perf_counter()
        with ctx():
            r.render_frames(frames)
            torch.cuda.synchronize()
        imgs[label] = r.hdr_image()
        rays[label] = r.last_stats.rays_per_bounce.cpu().numpy()
        log(f"phase 8 mesh {label} path: {frames} frames in "
            f"{time.perf_counter() - t0:.2f} s (host clock), rays_per_bounce "
            f"{rays[label].tolist()}")
    for other in ("unsorted", "plain"):
        rel = rel_rmse(np, imgs["sorted"], imgs[other])
        log(f"phase 8 mesh sorted kernel path vs {other}: relative RMSE "
            f"{rel * 100:.5f} % (limit 1 %)")
        if not rel < 0.01:
            raise AssertionError(f"mesh image differs from the {other} path")
    if not np.array_equal(rays["sorted"], rays["unsorted"]):
        raise AssertionError("sorted and unsorted rays_per_bounce differ")


def device_busy_ms(torch, fn, iters: int = 8):
    """(device ms of all kernels per call of fn, kernel launches per call)
    from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / iters / 1e3,
            sum(e.count for e in kernels) / iters)


def phase_mesh_times(torch, dev, smi):
    """Phase 9: the mesh path's ms/frame and Mrays/s (sorted, as the
    Renderer runs it, and unsorted), its device busy time, and per-kernel
    device time and launches per frame."""
    from spt_tpu_torch.bench import count_rays, shadow_rays_per_surface_lane

    frames = 16
    for label, kw in (("sorted", {}), ("unsorted", {"ray_sort": False})):
        r = mesh_renderer(dev, **kw)
        n_shadow = shadow_rays_per_surface_lane(r)
        r.render_frames(2)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        r.render_frames(frames)
        t1.record()
        torch.cuda.synchronize()
        ms_l = t0.elapsed_time(t1) / frames
        mrays = count_rays(r.last_stats, n_shadow) / frames / (ms_l * 1e-3) / 1e6
        busy, n_kernels = device_busy_ms(torch, lambda: r.render_frames(1))
        log(f"phase 9 mesh kernel path ({label}) {MW}x{MH} d{MESH_DEPTH}, "
            f"{frames} frames: {ms_l:.4f} ms/frame, {mrays:.2f} Mrays/s; "
            f"device busy {busy:.4f} ms/frame over {n_kernels:.1f} kernel "
            f"launches (profiled) [{smi}]")
        if label == "sorted":
            ms = ms_l
    r = mesh_renderer(dev)
    r.render_frames(1)
    names = {"fused_bounce": "fused_bounce_kernel<1>",
             "fused_frame": "fused_frame_kernel<1>",
             "sort_chunks": "sort_chunks_kernel"}
    iters = 8
    reset_counts()
    prof = profile_kernels(torch, lambda: r.render_frames(1),
                           list(names.values()), iters=iters)
    counts = read_counts()
    out = {}
    for label, name in names.items():
        per_launch, _ = prof[name]
        per_frame = counts[label] / (iters + 1)
        out[label] = (per_launch * per_frame, per_frame)
        log(f"phase 9 {name}: {per_launch:.4f} ms per launch, "
            f"{per_frame:.2f} launches and {per_launch * per_frame:.4f} ms of "
            f"device time per frame [{smi}]")
    return ms, out


# --- instanced phases (10-13) -------------------------------------------------

def inst_renderer(dev, **cfg_kw):
    from spt_tpu_torch.engine.renderer import Renderer

    desc, cfg, cam = port_inst_scene(**cfg_kw)
    return Renderer(desc, cfg, camera=cam, device=dev)


def _check_inst_scene(scene):
    from spt_tpu_torch.ops import cuda_bounce

    mode = cuda_bounce._accel_mode(scene)
    if mode != "instanced" or scene.textures is None:
        raise AssertionError(f"instanced grid in accel mode {mode!r}, "
                             f"textured {scene.textures is not None}: "
                             "expected 'instanced' and textured")


def _inst_trace_ops(torch, scene, o, d, tmin, tmax, t_end, blocked=None):
    """The operations the instanced tracer needs on these rays, counted from
    the plain version's result: every lane with a non-empty interval
    slab-tests every instance box (~24 flops) and every sphere (~20); for
    each instance it crosses within min(tmax, its final t) it slab-tests the
    mesh's real cluster boxes in object space (~24 flops each) and runs the
    64 Moller-Trumbore tests (~40 flops each) of every cluster box that
    final bound still reaches.  A blocked any-hit lane counts one test."""
    from spt_tpu_torch.ops import cuda_trace as ct
    from spt_tpu_torch.ops.vec3 import Vec3

    ia = scene.inst
    n = o.x.shape[0]
    tmax = torch.broadcast_to(torch.as_tensor(tmax, device=o.x.device,
                                              dtype=torch.float32), (n,))
    live = tmax > tmin
    if blocked is not None:
        live = live & ~blocked
    bound = torch.minimum(tmax, t_end).clamp(max=1e30)
    inv = Vec3(*(ct._inv_dir(c) for c in d))
    tnear, tfar = ct._slab(ia.inst_lo, ia.inst_hi, o, inv, tmin, bound)
    crossed = (tnear <= tfar) & live[None]
    ops = float(live.sum()) * (ia.num_instances * 24 + scene.num_spheres * 20)
    k = ia.cluster_size
    for i in range(ia.num_instances):
        lanes = torch.nonzero(crossed[i]).flatten()
        if lanes.numel() == 0:
            continue
        mesh = int(ia.inst[i, 12])
        real = ct._real_clusters(ia, mesh)
        oo, dd = ct._xform(ia.inst[i:i + 1].expand(lanes.numel(), 16),
                           Vec3(*(c[lanes] for c in o)),
                           Vec3(*(c[lanes] for c in d)))
        iinv = Vec3(*(ct._inv_dir(c) for c in dd))
        opened = 0
        for c0 in range(0, real.numel(), 16):
            cl = real[c0:c0 + 16]
            cn, cf = ct._slab(ia.blas_lo[mesh, cl], ia.blas_hi[mesh, cl], oo,
                              iinv, tmin, bound[lanes])
            opened += int((cn <= cf).sum())
        ops += lanes.numel() * real.numel() * 24.0 + opened * k * 40.0
    if blocked is not None:
        ops += 20.0 * int((blocked & (tmax > tmin)).sum())
    return ops


def phase_inst_kernels(torch, np, dev, smi):
    """Phase 10: the instanced kernels (K1, K3, K7) and the texture sampler
    against their plain versions on the card, at the inputs recorded from
    one sorted frame and one regen frame of the instanced grid, where their
    times and bounds are taken; and the textured resident forms on the mesh
    scene (K6 in the resident form).  Returns the kernel-line numbers."""
    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.lights import default_lights
    from spt_tpu_torch.ops import cuda_bounce, cuda_sort, cuda_trace
    from spt_tpu_torch.scene import flatten_scene

    out = {}
    # --- K7 at its main path's inputs: one frame of the regen path ---
    r = inst_renderer(dev, integrator="regen")
    scene = r.scene
    _check_inst_scene(scene)
    ia = scene.inst
    log(f"phase 10 instanced grid: {scene.num_triangles} world triangles, "
        f"{ia.num_instances} instances of {ia.num_meshes} meshes, BLAS "
        f"{ia.num_meshes} x {ia.cmax} clusters of {ia.cluster_size} "
        f"(tri_pack {tuple(ia.tri_pack.shape)}), {scene.num_spheres} sphere, "
        f"texture table {tuple(scene.textures.shape)}")
    with capture_calls([(cuda_trace, "inst_closest_hit"),
                        (cuda_trace, "inst_any_hit")]) as calls:
        r.render_frames(1)
        torch.cuda.synchronize()
    pack_bytes = ia.tri_pack.numel() * 4
    for kname, kern, ref, kernel_name in (
            ("closest_hit_inst", cuda_trace.inst_closest_hit,
             cuda_trace.inst_closest_hit_reference, "inst_trace_kernel<false>"),
            ("any_hit_inst", cuda_trace.inst_any_hit,
             cuda_trace.inst_any_hit_reference, "inst_trace_kernel<true>")):
        fn_name = "inst_closest_hit" if kname == "closest_hit_inst" \
            else "inst_any_hit"
        mine = [(args, kw) for name, args, kw in calls if name == fn_name]
        if not mine:
            raise AssertionError(f"the regen frame made no {fn_name} call")
        worst = nbytes = flops = 0.0
        for i, (args, kw) in enumerate(mine):
            _, _, o, d, tmin, tmax = args
            rays = o.x.shape[0]
            pk, pp = kern(*args, **kw), ref(*args, **kw)
            if kname == "closest_hit_inst":
                planes = _hit_planes(torch, pk, pp)
                both = (pk.kind != 0) & (pp.kind != 0)
                planes.update(uv=(torch.where(both[:, None], torch.stack(
                    [pk.uvx, pk.uvy], -1), 0.0), torch.where(
                    both[:, None], torch.stack([pp.uvx, pp.uvy], -1), 0.0)))
                flops += _inst_trace_ops(torch, scene, o, d, tmin, tmax, pp.t)
                nbytes += rays * (7 * 4 + 32)
            else:
                planes = {"blocked": (pk, pp)}
                t_end = torch.as_tensor(tmax, device=o.x.device,
                                        dtype=torch.float32)
                flops += _inst_trace_ops(torch, scene, o, d, tmin, tmax,
                                         t_end, blocked=pp)
                nbytes += rays * (7 * 4 + 1)
            worst = max(worst, check_planes(
                torch, f"{kname} regen call {i + 1} of {len(mine)} ({rays} "
                f"rays)", planes, phase=10))
        ms, plain_ms = _over_calls(torch, kern, mine, kernel_name, ref,
                                   plain_iters=1)
        b = bound((nbytes + len(mine) * pack_bytes) / len(mine),
                  flops / len(mine))
        out[kname] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                          bound=b, library_ms=None)
        log(f"phase 10 {kname} at the regen frame's {len(mine)} calls: kernel "
            f"{ms:.4f} ms per launch (device time), plain {plain_ms:.4f} ms, "
            f"bound {b[0]:.4f} ms ({b[1]}; {ops_note(flops / len(mine))}, "
            f"counting the triangle tests of the clusters each lane's final "
            f"bound reaches) [{smi}]")

    # --- K3 and K1 instanced (textured) at the sorted frame's inputs ---
    r = inst_renderer(dev)
    with capture_calls([(cuda_bounce, "fused_bounce"),
                        (cuda_bounce, "fused_frame"),
                        (cuda_sort, "sort_chunks")]) as calls:
        r.render_frames(1)
        torch.cuda.synchronize()
    by_name = {name: [(args, kw) for nm, args, kw in calls if nm == name]
               for name in ("fused_bounce", "fused_frame", "sort_chunks")}
    log(f"phase 10 the instanced sorted frame's calls: "
        f"{ {k: len(v) for k, v in by_name.items()} }")
    tex_bytes = scene.textures.numel() * 4
    out["sort_chunks"] = sort_at_calls(torch, 10, "the instanced sorted "
                                       "frame's", by_name["sort_chunks"], smi)

    mine = by_name["fused_bounce"]
    nbytes = flops = worst = 0.0
    for args, kw in mine:
        bps, bounce = args[3], args[4]
        ks, km = cuda_bounce.fused_bounce(*args, **kw)
        (ps_, pm), ops = _walk_ops(
            torch, scene,
            lambda: cuda_bounce.fused_bounce_reference(*args, **kw))
        worst = max(worst, check_planes(
            torch, f"fused_bounce instanced bounce {bounce} "
            f"({bps.num_paths} lanes, {int(bps.alive.sum())} alive)",
            _state_planes(torch, ks, km, ps_, pm), phase=10,
            exact=("radiance",)))
        nbytes += (bps.num_paths * (15 * 4 + 12 * 4 + 8 + 3) + pack_bytes
                   + tex_bytes)
        flops += ops
    ms, plain_ms = _over_calls(torch, cuda_bounce.fused_bounce, mine,
                               "fused_bounce_kernel<2>",
                               cuda_bounce.fused_bounce_reference,
                               plain_iters=1)
    b = bound(nbytes / len(mine), flops / len(mine))
    out["fused_bounce_instanced"] = dict(max_abs_err=worst, ms=ms,
                                         plain_ms=plain_ms, bound=b,
                                         library_ms=None)
    log(f"phase 10 fused_bounce instanced at the sorted frame's {len(mine)} "
        f"calls: kernel {ms:.4f} ms per launch (device time), plain "
        f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; "
        f"{ops_note(flops / len(mine))}) [{smi}]")

    def check_frame(what, args, kw):
        """fused_frame against its plain version on every plane; returns
        (max |d|, the operations of its walks)."""
        fk = cuda_bounce.fused_frame(*args, **kw)
        fp, ops = _walk_ops(torch, args[1],
                            lambda: cuda_bounce.fused_frame_reference(*args, **kw))
        rk, rp = fk[4].cpu().numpy(), fp[4].cpu().numpy()
        if not np.array_equal(rk, rp):
            raise AssertionError(f"{what}: rays_per_bounce kernel "
                                 f"{rk.tolist()} plain {rp.tolist()}")
        return check_planes(
            torch, f"{what}; rays_per_bounce {rk.tolist()} (= plain)",
            {"radiance": (_v(torch, fk[0]), _v(torch, fp[0])),
             "direction": (_v(torch, fk[1]), _v(torch, fp[1])),
             "throughput": (_v(torch, fk[2]), _v(torch, fp[2])),
             "missed": (fk[3], fp[3])}, phase=10, exact=("radiance",)), ops

    mine = by_name["fused_frame"]
    if len(mine) != 1:
        raise AssertionError(f"the instanced sorted frame called fused_frame "
                             f"{len(mine)} times")
    (args, kw), = mine
    fps = args[3]
    worst, ops = check_frame(
        f"fused_frame instanced from bounce {kw.get('start_bounce')} "
        f"({fps.num_paths} lanes, {int(fps.alive.sum())} alive)", args, kw)
    ms, plain_ms = _over_calls(torch, cuda_bounce.fused_frame, mine,
                               "fused_frame_kernel<2>",
                               cuda_bounce.fused_frame_reference,
                               plain_iters=1)
    b = bound(fps.num_paths * 26 * 4 + pack_bytes + tex_bytes, ops)
    out["fused_frame_instanced"] = dict(max_abs_err=worst, ms=ms,
                                        plain_ms=plain_ms, bound=b,
                                        library_ms=None)
    log(f"phase 10 fused_frame instanced at the sorted frame's call: kernel "
        f"{ms:.4f} ms (device time), plain {plain_ms:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]}; {ops_note(ops)}) [{smi}]")
    log_occupancy(10, smi, {
        "closest_hit_inst": _trace_shared_bytes("inst_closest_hit", ia, scene),
        "any_hit_inst": _trace_shared_bytes("inst_any_hit", ia, scene),
        "fused_bounce_instanced": cuda_bounce.shared_bytes(*args[:3]),
        "fused_frame_instanced": cuda_bounce.shared_bytes(*args[:3])})
    # the sampler's share of that launch: the same call without the table
    bare = (args[0], args[1]._replace(textures=None)) + tuple(args[2:])
    check_frame("fused_frame instanced on the same call without the "
                "texture table", bare, kw)
    bare_ms = kernel_device_ms(torch, lambda: cuda_bounce.fused_frame(
        *bare, **kw), "fused_frame_kernel<2>")
    out["texture_sampler"] = dict(out["fused_frame_instanced"],
                                  untextured_ms=bare_ms)
    log(f"phase 10 texture_sampler (the textured fused_frame instanced "
        f"launch): {ms:.4f} ms textured, {bare_ms:.4f} ms on the same call "
        f"without the texture table [{smi}]")

    # the instanced fused_frame over every bounce of all lanes (ray_sort off)
    cfg, lights = r.cfg, default_lights(dev)
    ps0 = transport.gen_primary(cfg, r.camera.rays(dev), 0)
    check_frame(f"fused_frame instanced from bounce 0 "
                f"({cfg.width * cfg.height} lanes)",
                (cfg, scene, lights, ps0), {})

    # --- K6 in the resident and small forms: the textured mesh scene ---
    desc, mcfg, mcam = port_mesh_scene()
    base, mr = _checker_texture(np, np.random.default_rng(0))
    from spt_tpu_torch import scene as tscene

    desc.materials[0] = tscene.Material([1.0, 1.0, 1.0], roughness=1.0,
                                        metallic=1.0, base_color_texture=base,
                                        metallic_roughness_texture=mr)
    mscene = flatten_scene(desc, dev)
    if (cuda_bounce._accel_mode(mscene) != "resident"
            or mscene.textures is None):
        raise AssertionError("textured mesh scene not resident and textured")
    mps = transport.gen_primary(mcfg, mcam.rays(dev), 0)
    check_frame(f"fused_frame resident textured from bounce 0 "
                f"({mcfg.width * mcfg.height} lanes)",
                (mcfg, mscene, lights, mps), {})
    ks, km = cuda_bounce.fused_bounce(mcfg, mscene, lights, mps, 0, False)
    ps_, pm = cuda_bounce.fused_bounce_reference(mcfg, mscene, lights, mps, 0,
                                                 False)
    check_planes(torch, "fused_bounce resident textured bounce 0",
                 _state_planes(torch, ks, km, ps_, pm), phase=10,
                 exact=("radiance",))
    return out


def phase_inst_main_path(torch, np, dev, out_dir, smi):
    """Phase 11: the instanced grid's Renderer on the card; returns the
    launch counts."""
    from spt_tpu_torch.bench import count_rays, shadow_rays_per_surface_lane
    from spt_tpu_torch.integrators import wavefront

    frames = 8
    r = inst_renderer(dev)
    _check_inst_scene(r.scene)
    n_shadow = shadow_rays_per_surface_lane(r)
    torch.cuda.synchronize()
    reset_counts()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    r.render_frames(frames)
    t1.record()
    torch.cuda.synchronize()
    counts = read_counts()
    branches = dict(wavefront.SORTED_SAMPLES)
    ms = t0.elapsed_time(t1) / frames
    rays, path = check_image(np, r, "inst_grid", out_dir, frames)
    mrays = count_rays(r.last_stats, n_shadow) / frames / (ms * 1e-3) / 1e6
    log(f"phase 11 instanced grid {MW}x{MH} d{MESH_DEPTH}: {frames} frames, "
        f"launches {counts}, sorted-frame branches {branches}, "
        f"rays_per_bounce {rays.tolist()}, mean hdr "
        f"{float(r.hdr_image().mean()):.6g}, png {path}")
    for k in ("fused_frame", "fused_bounce", "sort_chunks"):
        if counts[k] < 1:
            raise AssertionError(f"the instanced main path launched no {k}")
    if sum(branches.values()) != frames:
        raise AssertionError(f"the sorted frame ran {branches}")
    busy, n_kernels = device_busy_ms(torch, lambda: r.render_frames(1))
    log(f"phase 11 instanced grid: {ms:.4f} ms/frame (CUDA events, {frames} "
        f"frames), {mrays:.2f} Mrays/s; device busy {busy:.4f} ms/frame over "
        f"{n_kernels:.1f} kernel launches (profiled), idle share "
        f"{max(0.0, 1 - busy / ms) * 100:.1f} % [{smi}]")
    names = {"fused_bounce": "fused_bounce_kernel<2>",
             "fused_frame": "fused_frame_kernel<2>",
             "sort_chunks": "sort_chunks_kernel"}
    prof = profile_kernels(torch, lambda: r.render_frames(1),
                           list(names.values()), iters=4)
    log("phase 11 instanced grid, device ms per launch (profiled): "
        + ", ".join(f"{k} {prof[v][0]:.4f}" for k, v in names.items())
        + f" [{smi}]")
    # the same path without the coherence sorts: one fused_frame a sample
    u = inst_renderer(dev, ray_sort=False)
    u.render_frames(1)
    torch.cuda.synchronize()
    t0.record()
    u.render_frames(frames)
    t1.record()
    torch.cuda.synchronize()
    ms_u = t0.elapsed_time(t1) / frames
    busy_u, n_u = device_busy_ms(torch, lambda: u.render_frames(1))
    log(f"phase 11 instanced grid unsorted (ray_sort=False): {ms_u:.4f} "
        f"ms/frame, device busy {busy_u:.4f} ms/frame over {n_u:.1f} kernel "
        f"launches [{smi}]")
    return counts


def phase_inst_regen_path(torch, np, dev, out_dir):
    """Phase 12: integrator "regen" on the instanced grid traces through the
    standalone instanced tracer; returns the launch counts."""
    frames = 2
    r = inst_renderer(dev, integrator="regen")
    torch.cuda.synchronize()
    reset_counts()
    r.render_frames(frames)
    torch.cuda.synchronize()
    counts = read_counts()
    rays, path = check_image(np, r, "inst_grid_regen", out_dir, frames)
    log(f"phase 12 instanced grid regen {MW}x{MH} d{MESH_DEPTH}: {frames} "
        f"frames, launches {counts}, rays_per_bounce {rays.tolist()}, png "
        f"{path}")
    if counts["closest_hit_inst"] < 1 or counts["any_hit_inst"] < 1:
        raise AssertionError(f"the instanced regen path launched {counts}")
    return counts


def phase_inst_images(torch, np, dev):
    """Phase 13: the instanced grid's sorted kernel path against its
    unsorted kernel path (8 frames) and against the plain path (2
    frames)."""
    imgs = {}
    for label, frames, kw, ctx in (
            ("sorted", 8, {}, contextlib.nullcontext),
            ("unsorted", 8, {"ray_sort": False}, contextlib.nullcontext),
            ("sorted_2", 2, {}, contextlib.nullcontext),
            ("plain", 2, {}, plain_path)):
        r = inst_renderer(dev, **kw)
        t0 = time.perf_counter()
        with ctx():
            r.render_frames(frames)
            torch.cuda.synchronize()
        imgs[label] = r.hdr_image()
        log(f"phase 13 instanced grid {label} path: {frames} frames in "
            f"{time.perf_counter() - t0:.2f} s (host clock), rays_per_bounce "
            f"{r.last_stats.rays_per_bounce.cpu().numpy().tolist()}")
    for a, b in (("sorted", "unsorted"), ("sorted_2", "plain")):
        rel = rel_rmse(np, imgs[a], imgs[b])
        log(f"phase 13 instanced grid {a} kernel path vs {b}: relative RMSE "
            f"{rel * 100:.5f} % (limit 1 %)")
        if not rel < 0.01:
            raise AssertionError(f"instanced grid image differs from the {b} "
                                 "path")


# --- stream phases (14-18) ----------------------------------------------------

def stream_renderer(dev, stacks=48, slices=64, **cfg_kw):
    from spt_tpu_torch.engine.renderer import Renderer

    desc, cfg, cam = port_stream_scene(stacks, slices, **cfg_kw)
    return Renderer(desc, cfg, camera=cam, device=dev)


def _check_stream_scene(scene):
    from spt_tpu_torch.ops import cuda_bounce

    mode = cuda_bounce._accel_mode(scene)
    if mode != "stream" or scene.inst is not None or scene.textures is None:
        raise AssertionError(f"baked grid in accel mode {mode!r}, instanced "
                             f"{scene.inst is not None}, textured "
                             f"{scene.textures is not None}: expected "
                             "'stream', not instanced, textured")


def _stream_trace_ops(torch, scene, o, d, tmin, tmax, t_end, blocked=None):
    """The operations the stream tracer needs on these rays, counted from
    the plain version's result: every lane with a non-empty interval
    slab-tests every real supercluster box (~24 flops) and every sphere
    (~20); for each super its final bound min(tmax, t_end) still reaches it
    slab-tests that super's real cluster boxes (~24 flops each), and for
    each cluster box that bound reaches it runs the 64 Moller-Trumbore
    tests (~40 flops each).  A blocked any-hit lane counts one test."""
    from spt_tpu_torch.ops import cuda_trace as ct
    from spt_tpu_torch.ops.vec3 import Vec3

    a = scene.accel
    n = o.x.shape[0]
    tmax = torch.broadcast_to(torch.as_tensor(tmax, device=o.x.device,
                                              dtype=torch.float32), (n,))
    live = tmax > tmin
    if blocked is not None:
        live = live & ~blocked
    bound = torch.minimum(tmax, t_end).clamp(max=1e30)
    real_s = a.sup_lo[:, 0] <= a.sup_hi[:, 0]
    real_c = (a.cluster_lo[:, 0] <= a.cluster_hi[:, 0]).reshape(-1, 16)
    slo, shi = a.sup_lo[real_s], a.sup_hi[real_s]
    per_super = real_c[real_s].sum(1).to(torch.float32)
    ops = float(live.sum()) * (int(real_s.sum()) * 24 + scene.num_spheres * 20)
    clo, chi = a.cluster_lo.reshape(-1, 16, 3), a.cluster_hi.reshape(-1, 16, 3)
    for s0 in range(0, n, 16384):
        sl = slice(s0, min(n, s0 + 16384))
        oo = Vec3(*(c[sl] for c in o))
        inv = Vec3(*(ct._inv_dir(c[sl]) for c in d))
        b = bound[sl]
        tn, tf = ct._slab(slo, shi, oo, inv, tmin, b)
        opened = (tn <= tf) & live[sl][None]                      # (G', L)
        ops += float((opened.to(torch.float32) * per_super[:, None]).sum()) * 24
        cn, cf = ct._slab(clo[real_s].reshape(-1, 3), chi[real_s].reshape(-1, 3),
                          oo, inv, tmin, b)
        hit_c = ((cn <= cf).reshape(-1, 16, cn.shape[-1])
                 & real_c[real_s][..., None] & opened[:, None, :])
        ops += float(hit_c.sum()) * a.cluster_size * 40
    if blocked is not None:
        ops += 20.0 * int((blocked & (tmax > tmin)).sum())
    return ops


def _timed(torch, fn):
    """(result, ms) of one call, CUDA events around it."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def phase_stream_kernels(torch, np, dev, smi):
    """Phase 14: the stream-tier kernels (K8, K1/K3 stream, textured)
    against their plain versions on the card, at the inputs recorded from
    one regen frame (stream_closest_hit / stream_any_hit) and one sorted
    frame (fused_bounce and fused_frame stream) of the baked grid, every
    returned plane per lane, where their times and bounds are taken (the
    plain time is that of the checking call).  Returns the kernel-line
    numbers."""
    from spt_tpu_torch.ops import cuda_bounce, cuda_sort, cuda_trace

    out = {}
    r = stream_renderer(dev, integrator="regen")
    scene = r.scene
    _check_stream_scene(scene)
    a = scene.accel
    pack_bytes = a.tri_pack.numel() * 4
    log(f"phase 14 baked grid: {scene.num_triangles} unique world triangles,"
        f" {a.num_clusters} clusters of {a.cluster_size} in "
        f"{a.sup_lo.shape[0]} superclusters, tri_pack "
        f"{tuple(a.tri_pack.shape)} ({pack_bytes / 1e6:.2f} MB), "
        f"{scene.num_spheres} sphere, texture table "
        f"{tuple(scene.textures.shape)}")
    with capture_calls([(cuda_trace, "stream_closest_hit"),
                        (cuda_trace, "stream_any_hit")]) as calls:
        r.render_frames(1)
        torch.cuda.synchronize()
    for kname, kern, ref, kernel_name in (
            ("closest_hit_stream", cuda_trace.stream_closest_hit,
             cuda_trace.closest_hit_reference, "stream_trace_kernel<false>"),
            ("any_hit_stream", cuda_trace.stream_any_hit,
             cuda_trace.any_hit_reference, "stream_trace_kernel<true>")):
        fn_name = ("stream_closest_hit" if kname == "closest_hit_stream"
                   else "stream_any_hit")
        mine = [(args, kw) for name, args, kw in calls if name == fn_name]
        if not mine:
            raise AssertionError(f"the regen frame made no {fn_name} call")
        worst = nbytes = flops = plain_total = 0.0
        for i, (args, kw) in enumerate(mine):
            _, _, o, d, tmin, tmax = args
            rays = o.x.shape[0]
            pk = kern(*args, **kw)
            pp, pms = _timed(torch, lambda: ref(*args, **kw))
            plain_total += pms
            if kname == "closest_hit_stream":
                planes = _hit_planes(torch, pk, pp)
                both = (pk.kind != 0) & (pp.kind != 0)
                planes.update(uv=(torch.where(both[:, None], torch.stack(
                    [pk.uvx, pk.uvy], -1), 0.0), torch.where(
                    both[:, None], torch.stack([pp.uvx, pp.uvy], -1), 0.0)))
                flops += _stream_trace_ops(torch, scene, o, d, tmin, tmax, pp.t)
                nbytes += rays * (7 * 4 + 32)
            else:
                planes = {"blocked": (pk, pp)}
                t_end = torch.as_tensor(tmax, device=o.x.device,
                                        dtype=torch.float32)
                flops += _stream_trace_ops(torch, scene, o, d, tmin, tmax,
                                           t_end, blocked=pp)
                nbytes += rays * (7 * 4 + 1)
            worst = max(worst, check_planes(
                torch, f"{kname} regen call {i + 1} of {len(mine)} ({rays} "
                f"rays)", planes, phase=14))
        ms = kernel_device_ms(torch, lambda: [kern(*a_, **k_) for a_, k_ in mine],
                              kernel_name, iters=10, launches_per_call=len(mine))
        plain_ms = plain_total / len(mine)
        b = bound((nbytes + len(mine) * pack_bytes) / len(mine),
                  flops / len(mine))
        out[kname] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                          bound=b, library_ms=None)
        log(f"phase 14 {kname} at the regen frame's {len(mine)} calls: kernel "
            f"{ms:.4f} ms per launch (device time), plain {plain_ms:.4f} ms, "
            f"bound {b[0]:.4f} ms ({b[1]}; {ops_note(flops / len(mine))}, "
            f"counting the super boxes, "
            f"the cluster boxes of the supers and the triangles of the "
            f"clusters each lane's final bound reaches) [{smi}]")

    # --- K3 and K1 stream (textured) at the sorted frame's inputs ---
    r = stream_renderer(dev)
    with capture_calls([(cuda_bounce, "fused_bounce"),
                        (cuda_bounce, "fused_frame"),
                        (cuda_sort, "sort_chunks")]) as calls:
        r.render_frames(1)
        torch.cuda.synchronize()
    by_name = {name: [(args, kw) for nm, args, kw in calls if nm == name]
               for name in ("fused_bounce", "fused_frame", "sort_chunks")}
    log(f"phase 14 the stream sorted frame's calls: "
        f"{ {k: len(v) for k, v in by_name.items()} }")
    tex_bytes = scene.textures.numel() * 4
    mine = by_name["fused_bounce"]
    nbytes = flops = worst = plain_total = 0.0
    for args, kw in mine:
        bps, bounce = args[3], args[4]
        ks, km = cuda_bounce.fused_bounce(*args, **kw)
        ((ps_, pm), pms), ops = _walk_ops(torch, scene, lambda: _timed(
            torch, lambda: cuda_bounce.fused_bounce_reference(*args, **kw)))
        plain_total += pms
        worst = max(worst, check_planes(
            torch, f"fused_bounce stream bounce {bounce} ({bps.num_paths} "
            f"lanes, {int(bps.alive.sum())} alive)",
            _state_planes(torch, ks, km, ps_, pm), phase=14,
            exact=("radiance",)))
        nbytes += (bps.num_paths * (15 * 4 + 12 * 4 + 8 + 3) + pack_bytes
                   + tex_bytes)
        flops += ops
    ms = kernel_device_ms(torch, lambda: [cuda_bounce.fused_bounce(*a_, **k_)
                                          for a_, k_ in mine],
                          "fused_bounce_kernel<3>", iters=10,
                          launches_per_call=len(mine))
    b = bound(nbytes / len(mine), flops / len(mine))
    out["fused_bounce_stream"] = dict(max_abs_err=worst, ms=ms,
                                      plain_ms=plain_total / len(mine),
                                      bound=b, library_ms=None)
    log(f"phase 14 fused_bounce stream at the sorted frame's {len(mine)} "
        f"calls: kernel {ms:.4f} ms per launch (device time), plain "
        f"{plain_total / len(mine):.4f} ms, bound {b[0]:.4f} ms ({b[1]}; "
        f"{ops_note(flops / len(mine))}) [{smi}]")

    mine = by_name["fused_frame"]
    if len(mine) != 1:
        raise AssertionError(f"the stream sorted frame called fused_frame "
                             f"{len(mine)} times")
    (args, kw), = mine
    fps = args[3]
    fk = cuda_bounce.fused_frame(*args, **kw)
    (fp, plain_ms), ops = _walk_ops(torch, scene, lambda: _timed(
        torch, lambda: cuda_bounce.fused_frame_reference(*args, **kw)))
    rk, rp = fk[4].cpu().numpy(), fp[4].cpu().numpy()
    if not np.array_equal(rk, rp):
        raise AssertionError(f"fused_frame stream: rays_per_bounce kernel "
                             f"{rk.tolist()} plain {rp.tolist()}")
    worst = check_planes(
        torch, f"fused_frame stream from bounce {kw.get('start_bounce')} "
        f"({fps.num_paths} lanes, {int(fps.alive.sum())} alive); "
        f"rays_per_bounce {rk.tolist()} (= plain)",
        {"radiance": (_v(torch, fk[0]), _v(torch, fp[0])),
         "direction": (_v(torch, fk[1]), _v(torch, fp[1])),
         "throughput": (_v(torch, fk[2]), _v(torch, fp[2])),
         "missed": (fk[3], fp[3])}, phase=14, exact=("radiance",))
    ms = kernel_device_ms(torch, lambda: cuda_bounce.fused_frame(*args, **kw),
                          "fused_frame_kernel<3>")
    b = bound(fps.num_paths * 26 * 4 + pack_bytes + tex_bytes, ops)
    out["fused_frame_stream"] = dict(max_abs_err=worst, ms=ms,
                                     plain_ms=plain_ms, bound=b,
                                     library_ms=None)
    log(f"phase 14 fused_frame stream at the sorted frame's call: kernel "
        f"{ms:.4f} ms (device time), plain {plain_ms:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]}; {ops_note(ops)}) [{smi}]")
    log_occupancy(14, smi, {
        "closest_hit_stream": _trace_shared_bytes("stream_closest_hit", a, scene),
        "any_hit_stream": _trace_shared_bytes("stream_any_hit", a, scene),
        "fused_bounce_stream": cuda_bounce.shared_bytes(*args[:3]),
        "fused_frame_stream": cuda_bounce.shared_bytes(*args[:3])})
    out["sort_chunks"] = sort_at_calls(torch, 14, "the stream sorted frame's",
                                       by_name["sort_chunks"], smi)
    return out


def phase_stream_main_path(torch, np, dev, out_dir, smi):
    """Phase 15: the baked grid's Renderer on the card, sorted (the main
    path) and unsorted; returns the sorted run's launch counts."""
    from spt_tpu_torch.bench import count_rays, shadow_rays_per_surface_lane
    from spt_tpu_torch.integrators import wavefront

    frames = 8
    r = stream_renderer(dev)
    _check_stream_scene(r.scene)
    n_shadow = shadow_rays_per_surface_lane(r)
    torch.cuda.synchronize()
    reset_counts()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    r.render_frames(frames)
    t1.record()
    torch.cuda.synchronize()
    counts = read_counts()
    branches = dict(wavefront.SORTED_SAMPLES)
    ms = t0.elapsed_time(t1) / frames
    rays, path = check_image(np, r, "stream_grid", out_dir, frames)
    mrays = count_rays(r.last_stats, n_shadow) / frames / (ms * 1e-3) / 1e6
    log(f"phase 15 baked grid {MW}x{MH} d{MESH_DEPTH}: {frames} frames, "
        f"launches {counts}, sorted-frame branches {branches}, "
        f"rays_per_bounce {rays.tolist()}, mean hdr "
        f"{float(r.hdr_image().mean()):.6g}, png {path}")
    for k in ("fused_frame", "fused_bounce", "sort_chunks"):
        if counts[k] < 1:
            raise AssertionError(f"the stream main path launched no {k}")
    if sum(branches.values()) != frames:
        raise AssertionError(f"the sorted frame ran {branches}")
    busy, n_kernels = device_busy_ms(torch, lambda: r.render_frames(1))
    log(f"phase 15 baked grid: {ms:.4f} ms/frame (CUDA events, {frames} "
        f"frames), {mrays:.2f} Mrays/s; device busy {busy:.4f} ms/frame over "
        f"{n_kernels:.1f} kernel launches (profiled), idle share "
        f"{max(0.0, 1 - busy / ms) * 100:.1f} % [{smi}]")
    names = {"fused_bounce": "fused_bounce_kernel<3>",
             "fused_frame": "fused_frame_kernel<3>",
             "sort_chunks": "sort_chunks_kernel"}
    prof = profile_kernels(torch, lambda: r.render_frames(1),
                           list(names.values()), iters=4)
    log("phase 15 baked grid, device ms per launch (profiled): "
        + ", ".join(f"{k} {prof[v][0]:.4f} ({prof[v][1]} seen)"
                    for k, v in names.items()) + f" [{smi}]")
    if min(c for _, c in prof.values()) < 1:
        raise AssertionError(f"the profile of the stream path misses a "
                             f"stream form: {prof}")
    u = stream_renderer(dev, ray_sort=False)
    u.render_frames(1)
    torch.cuda.synchronize()
    t0.record()
    u.render_frames(frames)
    t1.record()
    torch.cuda.synchronize()
    ms_u = t0.elapsed_time(t1) / frames
    mrays_u = count_rays(u.last_stats, n_shadow) / frames / (ms_u * 1e-3) / 1e6
    busy_u, n_u = device_busy_ms(torch, lambda: u.render_frames(1))
    log(f"phase 15 baked grid unsorted (ray_sort=False): {ms_u:.4f} "
        f"ms/frame, {mrays_u:.2f} Mrays/s, device busy {busy_u:.4f} ms/frame "
        f"over {n_u:.1f} kernel launches, idle share "
        f"{max(0.0, 1 - busy_u / ms_u) * 100:.1f} % [{smi}]")
    return counts


def phase_stream_regen_path(torch, np, dev, out_dir):
    """Phase 16: integrator "regen" on the baked grid traces through the
    standalone stream tracer; returns the launch counts."""
    frames = 2
    r = stream_renderer(dev, integrator="regen")
    torch.cuda.synchronize()
    reset_counts()
    r.render_frames(frames)
    torch.cuda.synchronize()
    counts = read_counts()
    rays, path = check_image(np, r, "stream_grid_regen", out_dir, frames)
    log(f"phase 16 baked grid regen {MW}x{MH} d{MESH_DEPTH}: {frames} frames,"
        f" launches {counts}, rays_per_bounce {rays.tolist()}, png {path}")
    if counts["closest_hit_stream"] < 1 or counts["any_hit_stream"] < 1:
        raise AssertionError(f"the stream regen path launched {counts}")
    if counts["closest_hit"] or counts["any_hit"]:
        raise AssertionError(f"the stream regen path launched the resident "
                             f"tracer: {counts}")
    return counts


def phase_stream_images(torch, np, dev):
    """Phase 17: the baked grid's sorted kernel path against its unsorted
    kernel path (8 frames) and against the plain path (1 frame)."""
    imgs = {}
    for label, frames, kw, ctx in (
            ("sorted", 8, {}, contextlib.nullcontext),
            ("unsorted", 8, {"ray_sort": False}, contextlib.nullcontext),
            ("sorted_1", 1, {}, contextlib.nullcontext),
            ("plain", 1, {}, plain_path)):
        r = stream_renderer(dev, **kw)
        t0 = time.perf_counter()
        with ctx():
            r.render_frames(frames)
            torch.cuda.synchronize()
        imgs[label] = r.hdr_image()
        log(f"phase 17 baked grid {label} path: {frames} frames in "
            f"{time.perf_counter() - t0:.2f} s (host clock), rays_per_bounce "
            f"{r.last_stats.rays_per_bounce.cpu().numpy().tolist()}")
    for x, y in (("sorted", "unsorted"), ("sorted_1", "plain")):
        rel = rel_rmse(np, imgs[x], imgs[y])
        log(f"phase 17 baked grid {x} kernel path vs {y}: relative RMSE "
            f"{rel * 100:.5f} % (limit 1 %)")
        if not rel < 0.01:
            raise AssertionError(f"baked grid image differs from the {y} "
                                 "path")


def phase_any_size(torch, np, dev, smi):
    """Phase 18: the stream tier at any size — the baked grid at 144 x 192
    tessellation (about 940k unique triangles, 14.7k clusters, a tri_pack
    past the 50 MB L2): stream_closest_hit / stream_any_hit per launch at
    one regen frame's calls, each call's first 16 384 lanes against the
    plain version."""
    from spt_tpu_torch.ops import cuda_trace
    from spt_tpu_torch.ops.vec3 import Vec3

    t0 = time.perf_counter()
    r = stream_renderer(dev, 144, 192, integrator="regen")
    build_s = time.perf_counter() - t0
    scene = r.scene
    _check_stream_scene(scene)
    a = scene.accel
    log(f"phase 18 any-size baked grid: {scene.num_triangles} triangles, "
        f"{a.num_clusters} clusters in {a.sup_lo.shape[0]} superclusters, "
        f"tri_pack {a.tri_pack.numel() * 4 / 1e6:.1f} MB; scene and accel "
        f"built in {build_s:.1f} s (host)")
    with capture_calls([(cuda_trace, "stream_closest_hit"),
                        (cuda_trace, "stream_any_hit")]) as calls:
        r.render_frames(1)
        torch.cuda.synchronize()
    for fn_name, kern, ref, kernel_name in (
            ("stream_closest_hit", cuda_trace.stream_closest_hit,
             cuda_trace.closest_hit_reference, "stream_trace_kernel<false>"),
            ("stream_any_hit", cuda_trace.stream_any_hit,
             cuda_trace.any_hit_reference, "stream_trace_kernel<true>")):
        mine = [(args, kw) for name, args, kw in calls if name == fn_name]
        if not mine:
            raise AssertionError(f"the any-size regen frame made no {fn_name}")
        ms = kernel_device_ms(torch, lambda: [kern(*a_, **k_) for a_, k_ in mine],
                              kernel_name, iters=5, launches_per_call=len(mine))
        args, kw = mine[0]
        acc, sc, o, d, tmin, tmax = args
        m = 16384
        o16 = Vec3(*(c[:m].contiguous() for c in o))
        d16 = Vec3(*(c[:m].contiguous() for c in d))
        t16 = (tmax[:m].contiguous() if isinstance(tmax, torch.Tensor)
               and tmax.dim() else tmax)
        pk = kern(acc, sc, o16, d16, tmin, t16)
        pp, pms = _timed(torch, lambda: ref(acc, sc, o16, d16, tmin, t16))
        planes = (_hit_planes(torch, pk, pp) if fn_name == "stream_closest_hit"
                  else {"blocked": (pk, pp)})
        check_planes(torch, f"any-size {fn_name} on the first {m} lanes of "
                     f"the regen frame's first call", planes, phase=18)
        log(f"phase 18 any-size {fn_name}: kernel {ms:.4f} ms per launch "
            f"(device time, {len(mine)} calls of {o.x.shape[0]} rays); the "
            f"plain version on {m} lanes {pms:.1f} ms [{smi}]")
    log_occupancy(18, smi, {
        "closest_hit_stream": _trace_shared_bytes("stream_closest_hit", a, scene),
        "any_hit_stream": _trace_shared_bytes("stream_any_hit", a, scene)})


# --- the environment sampler (phase 19) ---------------------------------------

def phase_env_kernel(torch, np, dev, smi):
    """Phase 19: the equirect sampler (K2) on the hdr config at 1920x1080 d6
    (the .hdr round trip), at the inputs recorded from one frame of its
    main path: kernel against plain on the `need` lanes, device ms, bound
    (bytes), plain ms and the library yardstick, grid_sample on the map
    padded with one wrapped column a side; and the poles and the u seam."""
    import torch.nn.functional as F

    from spt_tpu_torch import env as tenv
    from spt_tpu_torch.ops import cuda_env, cuda_lib
    from spt_tpu_torch.ops.vec3 import Vec3

    r = renderer("hdr", W, H, dev)
    env = r.env
    with capture_calls([(cuda_env, "env_sample")]) as calls:
        r.render_frames(1)
        torch.cuda.synchronize()
    if len(calls) != 1:
        raise AssertionError(f"the hdr frame called env_sample {len(calls)} "
                             "times, expected once")
    (_, args, kw), = calls
    _, direction, need = args
    n = direction.x.shape[0]
    h, w = env.image.shape[0], env.image.shape[1]
    before = cuda_env.LAUNCHES
    k = cuda_env.env_sample(*args, **kw)
    if cuda_env.LAUNCHES != before + 1:
        raise AssertionError("env_sample launched "
                             f"{cuda_env.LAUNCHES - before} times in a call")
    p = cuda_env.env_sample_reference(*args, **kw)
    # after a warm-up: the plain version's first call compiles its
    # elementwise kernels
    plain_ms = time_call(torch, lambda: cuda_env.env_sample_reference(
        *args, **kw), warmup=1, iters=5)
    m = need
    worst = check_planes(torch, f"env_sample on the hdr frame's {n} lanes "
                         f"({int(m.sum())} need the term)",
                         {"rgb": (_v(torch, k)[m], _v(torch, p)[m])},
                         phase=19, exact=("rgb",))
    zero = bool((_v(torch, k)[~m] == 0).all())
    log(f"phase 19 env_sample: lanes outside need all 0: {zero}")
    if not zero:
        raise AssertionError("env_sample wrote a term outside need")
    ms = queued_device_ms(torch, lambda: cuda_env.env_sample(*args, **kw))
    # bytes: directions and need in, rgb out, and each distinct texel the
    # needed lanes tap once
    d_n = Vec3(*(c[m] for c in direction))
    taps = tenv._equirect_taps(h, w, tenv.v3.safe_normalize(d_n))
    x0, x1, y0, y1 = (t.long() for t in taps[:4])
    texels = torch.unique(torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0,
                                     y1 * w + x1])).numel()
    b = bound(n * (13 + 12) + texels * 12, float(m.sum()) * 46)
    # the library yardstick: one grid_sample on precomputed coordinates
    x, y = _env_xy(torch, tenv, h, w, direction)
    padded = torch.cat([env.image[:, -1:], env.image, env.image[:, :1]], 1)
    inp = padded.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([(x + 1.5) / (w + 2) * 2 - 1, (y + 0.5) / h * 2 - 1],
                       -1)[None, None].contiguous()

    def lib():
        return F.grid_sample(inp, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    lib_ms = queued_device_ms(torch, lib)
    g = torch.clamp(lib()[0, :, 0].T, max=env.max_clamp) * env.intensity
    lib_err = float((g[m] - _v(torch, p)[m]).abs().max())
    out = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound=b,
               library_ms=lib_ms)
    info = cuda_lib.kernel_info()["env_sample"]
    log(f"phase 19 env_sample: {info['registers']} registers, "
        f"{info['local_bytes']} B local; the map in its texel layout "
        f"{h * w * 16} B (in 12-byte texels {h * w * 12} B)")
    log(f"phase 19 env_sample on the hdr frame's call ({n} lanes, map "
        f"{h}x{w}): kernel {ms:.4f} ms (device time, CUDA events behind a "
        f"spin kernel), plain {plain_ms:.4f} ms, grid_sample {lib_ms:.4f} ms "
        f"(the same timing; max |d| against plain on the need "
        f"lanes {lib_err:.3g}), bound {b[0]:.4f} ms ({b[1]}; {texels} "
        f"distinct texels) [{smi}]")
    # the poles and the u seam, every lane needed
    pts = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [-1.0, 0.0, 1e-7],
                        [-1.0, 0.0, -1e-7], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
                       device=dev).repeat(64, 1)
    dv = Vec3(*(c.contiguous() for c in pts.unbind(1)))
    check_planes(torch, "env_sample at the poles and the u seam",
                 {"rgb": (_v(torch, cuda_env.env_sample(env, dv)),
                          _v(torch, cuda_env.env_sample_reference(env, dv)))},
                 phase=19, exact=("rgb",))
    return out


def _env_xy(torch, tenv, h, w, direction):
    """The plain sampler's continuous texel coordinates (x, y) of each lane
    (env._equirect_taps before the floor)."""
    d = tenv.v3.safe_normalize(direction)
    theta = torch.atan2(d.z, d.x)
    phi = torch.acos(torch.clamp(d.y, -1.0, 1.0))
    u = (theta + math.pi) / (2.0 * math.pi)
    v = phi / math.pi
    return u * w - 0.5, v * h - 0.5


# --- this slice's entry points (phases 20-23) ---------------------------------

def frame_ms(torch, r, frames: int) -> float:
    """ms/frame of r.render_frames(frames) after one warm-up frame (CUDA
    events around the chain)."""
    r.render_frames(1)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    r.render_frames(frames)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / frames


def _compact_bounce0(torch, smi, name, r):
    """K3 at the compact path's bounce-0 call of one frame of `r`, held
    against its plain version plane by plane; and, where the frame samples
    an HDR map, K2 at each of the frame's calls.  Returns the kernel-line
    numbers of the bounce-0 call."""
    from spt_tpu_torch.ops import cuda_bounce, cuda_env

    with capture_calls([(cuda_bounce, "fused_bounce"),
                        (cuda_env, "env_sample")]) as calls:
        r.render_frames(1)
        torch.cuda.synchronize()
    bounce0 = [(a, k) for nm, a, k in calls if nm == "fused_bounce"]
    envs = [(a, k) for nm, a, k in calls if nm == "env_sample"]
    if len(bounce0) != 1 or bounce0[0][0][4] != 0:
        raise AssertionError(f"the compact frame made {len(bounce0)} "
                             "fused_bounce calls, expected one at bounce 0")
    (args, kw), = bounce0
    bcfg, scene, lights, ps, _, _ = args
    n = ps.num_paths
    small = cuda_bounce._accel_mode(scene) is None
    ks, km = cuda_bounce.fused_bounce(*args, **kw)
    (ps_, pm), ops = _walk_ops(
        torch, scene, lambda: cuda_bounce.fused_bounce_reference(*args, **kw))
    planes = _state_planes(torch, ks, km, ps_, pm)
    worst = check_planes(torch, f"fused_bounce at the compact {name} frame's "
                         f"bounce-0 call ({n} lanes)", planes, phase=20,
                         exact=tuple(planes) if small else ())
    form = "fused_bounce_kernel<0>" if small else "fused_bounce_kernel<1>"
    call = lambda: cuda_bounce.fused_bounce(*args, **kw)
    ms = kernel_device_ms(torch, call, form)
    plain_ms = time_call(torch, lambda: cuda_bounce.fused_bounce_reference(
        *args, **kw), warmup=1, iters=3)
    # bytes a lane: 12 float planes and the RNG word and two flags as int32
    # in (60 B), 12 float planes, the int64 RNG word and three byte flags out
    # (59 B); then the packed tables and a mesh form's tri_pack once
    tables = cuda_bounce._pack_tables(scene, lights, bcfg.nee and
                                      scene.emitters is not None,
                                      cuda_bounce._accel_mode(scene))
    pack = 0 if small else scene.accel.tri_pack.numel() * 4
    b = bound(n * (60 + 59) + tables.numel() * 4 + pack, ops)
    log(f"phase 20 {form} at the compact {name} frame's bounce-0 call "
        f"({n} lanes, d{bcfg.max_depth}): kernel {ms:.4f} ms (device time), "
        f"plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; "
        f"{ops_note(ops)}) [{smi}]")
    for i, (eargs, ekw) in enumerate(envs):
        env, direction, need = eargs
        k = cuda_env.env_sample(*eargs, **ekw)
        p = cuda_env.env_sample_reference(*eargs, **ekw)
        check_planes(torch, f"env_sample at the compact {name} frame's call "
                     f"{i + 1} of {len(envs)} ({direction.x.shape[0]} lanes, "
                     f"{int(need.sum())} need the term)",
                     {"rgb": (_v(torch, k)[need], _v(torch, p)[need])},
                     phase=20, exact=("rgb",))
        if not bool((_v(torch, k)[~need] == 0).all()):
            raise AssertionError("env_sample wrote a term outside need")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound=b,
                library_ms=None), len(envs)


def phase_compact(torch, np, dev, out_dir, smi):
    """Phase 20: integrator "compact" (bounce 0 through K3 at full width,
    then compacted chunks through trace_bounce + shade with the environment
    each bounce) on default d6, cornell d8 and hdr d6 at 1920x1080 and on
    the mesh scene at 512x384 d4: K3 at the bounce-0 call against its plain
    version (bit for bit on the small scenes), K2 at the hdr frame's calls,
    the image against the masked path's (< 1 % relative RMSE over 8 frames,
    rays_per_bounce equal), launches counted over the 8 frames, ms/frame
    and device busy.  Returns (the default config's K3 numbers, its
    fused_bounce launches on the compact main path)."""
    from spt_tpu_torch.engine import state as state_mod

    frames = 8
    result, launches = None, 0
    for name in ("default", "cornell", "hdr", "mesh"):
        if name == "mesh":
            r = mesh_renderer(dev, integrator="compact")
            m = mesh_renderer(dev)
            size = f"{MW}x{MH}"
        else:
            r = renderer(name, W, H, dev, integrator="compact")
            m = renderer(name, W, H, dev)
            size = f"{W}x{H}"
        # frame 0 of each path warms it; both then go on from frame 1
        k3, env_calls = _compact_bounce0(torch, smi, name, r)
        m.render_frames(1)
        r.state, m.state = state_mod.reset(r.state), state_mod.reset(m.state)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r.render_frames(frames)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / frames
        counts = read_counts()
        t0 = time.perf_counter()
        m.render_frames(frames)
        torch.cuda.synchronize()
        ms_m = (time.perf_counter() - t0) * 1e3 / frames
        rays, path = check_image(np, r, f"{name}_compact", out_dir, frames)
        mrays = m.last_stats.rays_per_bounce.cpu().numpy()
        rel = rel_rmse(np, r.hdr_image(), m.hdr_image())
        log(f"phase 20 {name} compact {size} d{r.cfg.max_depth}: {frames} "
            f"frames, launches {counts}, rays_per_bounce {rays.tolist()} "
            f"(masked {mrays.tolist()}), relative RMSE against the masked "
            f"path {rel * 100:.5f} % (limit 1 %), png {path}")
        if counts["fused_bounce"] != frames or counts["fused_frame"]:
            raise AssertionError(f"{name} compact launched {counts}: expected "
                                 f"fused_bounce {frames}, fused_frame 0")
        if name == "hdr" and counts["env_sample"] <= frames:
            raise AssertionError(f"hdr compact launched env_sample "
                                 f"{counts['env_sample']} times in {frames} "
                                 "frames, expected one a bounce")
        if name == "mesh" and (counts["closest_hit"] < 1
                               or counts["any_hit"] < 1):
            raise AssertionError(f"the mesh compact chunks launched {counts}")
        if not rel < 0.01 or rays.tolist() != mrays.tolist():
            raise AssertionError(f"{name} compact differs from the masked "
                                 f"path: relative RMSE {rel}, rays "
                                 f"{rays.tolist()} against {mrays.tolist()}")
        if name == "default":
            result, launches = k3, counts["fused_bounce"]
        busy, per = device_busy_ms(torch, lambda: r.render_frames(1), iters=1)
        busy_m, per_m = device_busy_ms(torch, lambda: m.render_frames(1),
                                       iters=2)
        log(f"phase 20 {name} {size}: compact {ms:.4f} ms/frame, busy "
            f"{busy:.4f} ms over {per:.1f} launches a frame ({env_calls} "
            f"env_sample calls a frame); masked {ms_m:.4f} ms/frame, busy "
            f"{busy_m:.4f} ms over {per_m:.1f} launches (host clock over the "
            f"{frames} frames, each path synced at its end; profiler) [{smi}]")
    return result, launches


def phase_megakernel(torch, np, dev, out_dir, smi):
    """Phase 21: integrator "megakernel" on default 1920x1080 d6 against the
    masked path (< 1 % relative RMSE over 4 frames), its ms/frame and
    launches a frame; the gradient of an image MSE with respect to
    base_color on the card at 64x48 d3 against the same gradient on the
    CPU; toggle_integrator's reset."""
    from spt_tpu_torch.camera import default_camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.env import make_procedural_environment
    from spt_tpu_torch.integrators import megakernel
    from spt_tpu_torch.lights import default_lights
    from spt_tpu_torch.scene import build_default_scene, flatten_scene

    frames = 4
    r = renderer("default", W, H, dev, integrator="megakernel")
    m = renderer("default", W, H, dev)
    reset_counts()
    r.render_frames(frames)
    torch.cuda.synchronize()
    counts = read_counts()
    m.render_frames(frames)
    rel = rel_rmse(np, r.hdr_image(), m.hdr_image())
    _, path = check_image(np, r, "default_megakernel", out_dir, frames)
    ms = frame_ms(torch, r, 2)
    busy, per = device_busy_ms(torch, lambda: r.render_frames(1), iters=1)
    log(f"phase 21 default megakernel {W}x{H} d6: {frames} frames, launches "
        f"of the port's kernels {counts}, relative RMSE against the masked "
        f"path {rel * 100:.5f} % (limit 1 %), {ms:.4f} ms/frame (CUDA events "
        f"over 2 frames), busy {busy:.4f} ms over {per:.1f} launches a frame, "
        f"png {path} [{smi}]")
    if not rel < 0.01:
        raise AssertionError(f"the megakernel image differs from the masked "
                             f"path's: {rel}")

    grads = {}
    cfg = RenderConfig(width=64, height=48, spp=1, max_depth=3)
    for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
        scene = flatten_scene(build_default_scene(), d)
        env, lights = make_procedural_environment(d), default_lights(d)
        cam = default_camera(64, 48).rays(d)
        with torch.no_grad():
            dim = scene._replace(materials=scene.materials._replace(
                base_color=scene.materials.base_color * 0.7))
            target = megakernel.render_sample(cfg, dim, env, lights, cam, 0)
        scene.materials.base_color.requires_grad_(True)
        img = megakernel.render_sample(cfg, scene, env, lights, cam, 0)
        ((img - target) ** 2).mean().backward()
        grads[key] = scene.materials.base_color.grad.cpu()
    gk, gc = grads["card"], grads["cpu"]
    scale = float(gc.abs().max())
    diff = float((gk - gc).abs().max())
    ok = bool(torch.isfinite(gk).all()) and bool(
        ((gk - gc).abs() <= 1e-2 * gc.abs() + 1e-4 * scale).all())
    log(f"phase 21 d(image MSE)/d(base_color), default 64x48 d3: card against "
        f"CPU max |d| {diff:.3g} (largest entry {scale:.3g}; limit 1e-2 "
        f"relative + 1e-4 of the largest), {int((gc != 0).sum())} nonzero "
        f"entries")
    if not ok or not (gc.abs() > 0).sum() >= 6:
        raise AssertionError(f"the card gradient differs from the CPU's:\n"
                             f"{gk}\n{gc}")

    t = renderer("default", 320, 240, dev)
    t.render_frames(2)
    name = t.toggle_integrator()
    reset_after = t.accumulated_samples
    t.render_frames(1)
    back = t.toggle_integrator()
    log(f"phase 21 toggle_integrator: masked -> {name} (samples after the "
        f"toggle {reset_after}) -> {back} (samples {t.accumulated_samples})")
    if (name, back, reset_after, t.accumulated_samples) != (
            "megakernel", "masked", 0.0, 0.0):
        raise AssertionError("toggle_integrator did not reset accumulation")


def phase_debug_views(torch, np, dev, smi):
    """Phase 22: the five debug views on the default scene and the mesh
    scene at 512x384 against the CPU plain run on the same primary rays
    (the card's, moved to the CPU: the two devices' PyTorch round the ray
    directions apart by an ulp, which a grazing sphere hit amplifies to
    6e-4 in the normal): geomtype, hitmiss and matid equal, normal and
    depth within 1e-5.  The CPU run shares one closest-hit trace among the
    five views; on the mesh scene it takes every 4th pixel row."""
    from spt_tpu_torch.camera import default_camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.integrators import debug, transport
    from spt_tpu_torch.ops import intersect as isect
    from spt_tpu_torch.scene import build_default_scene, flatten_scene

    cpu = torch.device("cpu")
    mdesc, mcfg, mcam = port_mesh_scene()
    for name, desc, cfg, cam, stride in (
            ("default", build_default_scene(),
             RenderConfig(width=MW, height=MH), default_camera(MW, MH), 1),
            ("mesh", mdesc, mcfg, mcam, 4)):
        sk, sc = flatten_scene(desc, dev), flatten_scene(desc, cpu)
        reset_counts()
        with capture_calls([(transport, "gen_primary")], results=True) as rec:
            imgs = {mode: debug.render_debug(cfg, sk, cam.rays(dev),
                                             mode).cpu()
                    for mode in debug.MODES}
        torch.cuda.synchronize()
        traced = read_counts()["closest_hit"]
        rows = torch.arange(cfg.height)[::stride]
        lanes = (rows[:, None] * cfg.width
                 + torch.arange(cfg.width)[None]).reshape(-1).to(dev)

        def to_cpu(x):
            if isinstance(x, tuple):
                return type(x)(*(to_cpu(c) for c in x))
            return x[lanes].cpu()

        ps_cpu = to_cpu(rec[0][3])
        t0 = time.perf_counter()
        gen, hit = transport.gen_primary, isect.intersect_v
        cached = []

        def once(*a, **k):
            if not cached:
                cached.append(hit(*a, **k))
            return cached[0]

        transport.gen_primary = lambda *a, **k: ps_cpu
        isect.intersect_v = once
        try:
            sub = cfg.replace(height=len(rows))
            plain = {mode: debug.render_debug(sub, sc, cam.rays(cpu), mode)
                     for mode in debug.MODES}
        finally:
            transport.gen_primary, isect.intersect_v = gen, hit
        report, bad = [], []
        for mode in debug.MODES:
            d = float((imgs[mode][::stride] - plain[mode]).abs().max())
            tol = 1e-5 if mode in ("normal", "depth") else 0.0
            report.append(f"{mode} {d:.3g}")
            if not d <= tol:
                bad.append(f"{mode} {d}")
        log(f"phase 22 debug views, {name} {cfg.width}x{cfg.height}: max "
            f"|card - CPU| over {len(rows)} rows: {', '.join(report)} "
            f"(limits 0, 0, 1e-5, 1e-5, 0); closest_hit launches {traced}; "
            f"the CPU run {time.perf_counter() - t0:.1f} s [{smi}]")
        if bad:
            raise AssertionError(f"debug views on {name}: card and CPU "
                                 f"differ: {bad}")
        if name == "mesh" and traced != len(debug.MODES):
            raise AssertionError(f"the mesh debug views launched closest_hit "
                                 f"{traced} times")


def _textured_glb(np, path, res=64):
    """A small textured .glb: a ground quad with a baseColor PNG held in the
    BIN chunk, and a UV-textured box on it (uvs repeat twice)."""
    import struct

    from spt_tpu_torch.engine.image import write_png

    png = path + ".png"
    y, x = np.mgrid[0:res, 0:res] / res
    write_png(png, np.stack([x, y, 0.5 + 0.5 * ((x * 8).astype(int) % 2)], -1))
    with open(png, "rb") as f:
        image = f.read()
    pos = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2],
                    [-0.5, 0, 0], [0.5, 0, 0], [0.5, 1, 0], [-0.5, 1, 0]],
                   np.float32)
    uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2],
                   [0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 2, 1, 0, 3, 2, 4, 5, 6, 4, 6, 7], np.uint32)
    blobs = [pos.tobytes(), uv.tobytes(), idx.tobytes(), image]
    views, off, binc = [], 0, b""
    for blob in blobs:
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(blob)})
        blob += b"\x00" * (-len(blob) % 4)
        binc += blob
        off += len(blob)
    doc = {"asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}],
           "nodes": [{"mesh": 0}],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0,
                                                      "TEXCOORD_0": 1},
                                       "indices": 2, "material": 0}]}],
           "materials": [{"pbrMetallicRoughness": {
               "baseColorTexture": {"index": 0}, "metallicFactor": 0.0,
               "roughnessFactor": 0.6}}],
           "textures": [{"source": 0}],
           "images": [{"bufferView": 3, "mimeType": "image/png"}],
           "accessors": [
               {"bufferView": 0, "componentType": 5126, "count": 8,
                "type": "VEC3"},
               {"bufferView": 1, "componentType": 5126, "count": 8,
                "type": "VEC2"},
               {"bufferView": 2, "componentType": 5125, "count": 12,
                "type": "SCALAR"}],
           "bufferViews": views, "buffers": [{"byteLength": len(binc)}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(binc))
                + struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(binc), 0x004E4942) + binc)
    return path


def phase_entry_points(np, out_dir, smi):
    """Phase 23: ``python -m spt_tpu_torch.cli`` on the card at the CLI's
    defaults (800x600, spp 4, d6) for 4 frames, with --integrator compact,
    --integrator megakernel, --debug-mode normal, --stats and --i on a
    synthetic textured .glb (all started together); then ``python -m
    spt_tpu_torch.bench`` on default, cornell, hdr and anim, one after
    another.  Each must exit 0; each CLI run must write a non-empty PNG and
    each bench run print its JSON line, which is echoed here.  Returns the
    bench lines."""
    from spt_tpu_torch.engine.image import read_png

    glb = _textured_glb(np, os.path.join(out_dir, "textured.glb"))
    runs = {"defaults": [], "compact": ["--integrator", "compact"],
            "megakernel": ["--integrator", "megakernel"],
            "debug_normal": ["--debug-mode", "normal"], "stats": ["--stats"],
            "glb": ["--i", glb]}
    procs = {}
    t0 = time.perf_counter()
    for label, flags in runs.items():
        png = os.path.join(out_dir, f"cli_{label}.png")
        if os.path.exists(png):
            os.remove(png)
        cmd = [sys.executable, "-m", "spt_tpu_torch.cli", "--frames", "4",
               "-o", png] + flags
        procs[label] = (png, subprocess.Popen(
            cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    failed = []
    for label, (png, proc) in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        last = out.strip().splitlines()[-3:] if out.strip() else []
        ok = (proc.returncode == 0 and os.path.exists(png)
              and os.path.getsize(png) > 0)
        if ok:
            img = read_png(png)
            ok = img.shape[:2] == (600, 800) and img.max() > 0
        log(f"phase 23 cli {label}: exit {proc.returncode}, png "
            f"{os.path.getsize(png) if os.path.exists(png) else 0} B; "
            + " | ".join(last))
        if not ok:
            failed.append(f"cli {label}: exit {proc.returncode}\n{err[-2000:]}")
    log(f"phase 23 the six CLI runs together: {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("\n".join(failed))
    lines = {}
    for scene in ("default", "cornell", "hdr", "anim"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "spt_tpu_torch.bench",
                               "--scene", scene], cwd=HERE,
                              capture_output=True, text=True, timeout=600)
        found = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        log(f"phase 23 bench {scene} ({time.perf_counter() - t0:.1f} s, exit "
            f"{proc.returncode}): {found[-1] if found else '(no line)'} "
            f"[{smi}]")
        if proc.returncode != 0 or not found:
            raise AssertionError(f"bench {scene} failed:\n{proc.stderr[-2000:]}")
        res = json.loads(found[-1])
        keys = {"metric", "value", "unit", "vs_baseline", "ms_per_frame",
                "spp", "max_depth", "device"}
        if not keys <= set(res) or not res["value"] > 0:
            raise AssertionError(f"bench {scene} printed {res}")
        lines[scene] = res
    return lines


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import numpy as np
        from spt_tpu_torch.ops import cuda_bounce, cuda_lib
    except ImportError as e:
        print(f"chip_smoke: the spt_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    smi = smi_line()
    nvcc = subprocess.run([cuda_lib.nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")
    log("nvcc: " + " | ".join(nvcc.stdout.strip().splitlines()[-2:]))
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    cuda_lib.build()
    log(f"phase 0 build: {time.perf_counter() - t0:.2f} s in all, per source "
        f"{ {k: round(v, 2) for k, v in cuda_lib.BUILD_SECONDS.items()} }")
    log(f"phase 0 kernels: {cuda_lib.kernel_info()}")
    for line in cuda_lib.PTXAS_LOG.splitlines():
        if "Compiling entry" in line or "spill" in line or "Used" in line:
            log("phase 0 ptxas: " + line.strip())

    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)

    small = phase_kernel_vs_plain(torch, cuda_bounce, dev, smi)
    small_launches, env_launches = phase_main_path(torch, np, cuda_bounce,
                                                   dev, out_dir)
    phase_image_vs_plain(torch, np, dev)
    phase_times(torch, dev, smi)

    mesh = phase_mesh_kernels(torch, np, dev, smi)
    counts, branches = phase_mesh_main_path(torch, np, dev, out_dir)
    regen = phase_regen_path(torch, np, dev, out_dir)
    phase_mesh_images(torch, np, dev)
    phase_mesh_times(torch, dev, smi)

    inst = phase_inst_kernels(torch, np, dev, smi)
    inst_counts = phase_inst_main_path(torch, np, dev, out_dir, smi)
    inst_regen = phase_inst_regen_path(torch, np, dev, out_dir)
    phase_inst_images(torch, np, dev)

    stream = phase_stream_kernels(torch, np, dev, smi)
    stream_counts = phase_stream_main_path(torch, np, dev, out_dir, smi)
    stream_regen = phase_stream_regen_path(torch, np, dev, out_dir)
    phase_stream_images(torch, np, dev)
    phase_any_size(torch, np, dev, smi)
    env_k = phase_env_kernel(torch, np, dev, smi)

    k3_small, k3_small_launches = phase_compact(torch, np, dev, out_dir, smi)
    phase_megakernel(torch, np, dev, out_dir, smi)
    phase_debug_views(torch, np, dev, smi)
    phase_entry_points(np, out_dir, smi)

    def entry(name, source, replaces, launches, k):
        for key in ("max_abs_err", "ms", "plain_ms"):
            if not math.isfinite(k[key]):
                raise AssertionError(f"non-finite {key} for {name}: {k}")
        if launches < 1:
            raise AssertionError(f"{name} was launched no time on its path")
        return {"name": name, "route": "cuda",
                "source": f"spt_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
                "bound_by": k["bound"][1], "library_ms": k["library_ms"]}

    small["library_ms"] = None
    kernels = [
        entry("fused_frame", "fused_frame.cu",
              "spt_tpu/ops/pallas_bounce.py:1090", small_launches, small),
        entry("fused_frame_resident", "fused_frame.cu",
              "spt_tpu/ops/pallas_bounce.py:1090", counts["fused_frame"],
              mesh["fused_frame_resident"]),
        entry("fused_bounce", "fused_bounce.cu",
              "spt_tpu/ops/pallas_bounce.py:752", counts["fused_bounce"],
              mesh["fused_bounce"]),
        entry("closest_hit", "cluster_trace.cu",
              "spt_tpu/ops/pallas_trace.py:497", regen["closest_hit"],
              mesh["closest_hit"]),
        entry("any_hit", "cluster_trace.cu",
              "spt_tpu/ops/pallas_trace.py:617", regen["any_hit"],
              mesh["any_hit"]),
        entry("sort_chunks", "sort_chunks.cu",
              "spt_tpu/ops/pallas_sort.py:70", counts["sort_chunks"],
              mesh["sort_chunks"]),
        entry("fused_frame_instanced", "fused_frame.cu",
              "spt_tpu/ops/pallas_bounce.py:1090",
              inst_counts["fused_frame"], inst["fused_frame_instanced"]),
        entry("fused_bounce_instanced", "fused_bounce.cu",
              "spt_tpu/ops/pallas_bounce.py:752", inst_counts["fused_bounce"],
              inst["fused_bounce_instanced"]),
        entry("closest_hit_inst", "inst_trace.cu",
              "spt_tpu/ops/pallas_inst.py:823",
              inst_regen["closest_hit_inst"], inst["closest_hit_inst"]),
        entry("any_hit_inst", "inst_trace.cu",
              "spt_tpu/ops/pallas_inst.py:840", inst_regen["any_hit_inst"],
              inst["any_hit_inst"]),
        entry("texture_sampler", "spt_common.cuh",
              "spt_tpu/ops/pallas_bounce.py:527", inst_counts["fused_frame"],
              inst["texture_sampler"]),
        entry("fused_frame_stream", "fused_frame.cu",
              "spt_tpu/ops/pallas_bounce.py:1090",
              stream_counts["fused_frame"], stream["fused_frame_stream"]),
        entry("fused_bounce_stream", "fused_bounce.cu",
              "spt_tpu/ops/pallas_bounce.py:752",
              stream_counts["fused_bounce"], stream["fused_bounce_stream"]),
        entry("closest_hit_stream", "stream_trace.cu",
              "spt_tpu/ops/pallas_stream.py:104",
              stream_regen["closest_hit_stream"],
              stream["closest_hit_stream"]),
        entry("any_hit_stream", "stream_trace.cu",
              "spt_tpu/ops/pallas_stream.py:250",
              stream_regen["any_hit_stream"], stream["any_hit_stream"]),
        entry("env_sample", "env_sample.cu", "spt_tpu/ops/pallas_env.py:158",
              env_launches, env_k),
        entry("sort_chunks_instanced", "sort_chunks.cu",
              "spt_tpu/ops/pallas_sort.py:70", inst_counts["sort_chunks"],
              inst["sort_chunks"]),
        entry("sort_chunks_stream", "sort_chunks.cu",
              "spt_tpu/ops/pallas_sort.py:70", stream_counts["sort_chunks"],
              stream["sort_chunks"]),
        entry("fused_bounce_small", "fused_bounce.cu",
              "spt_tpu/ops/pallas_bounce.py:752", k3_small_launches, k3_small),
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
