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
   from the plain version's per-lane bounce counts; on default, K1's
   whole-frame form (``cuda_bounce.whole_frame``) in each placement of
   its tables against its plain version, the split frame's chain in
   plain PyTorch (primary rays, fused_frame_reference, the sky term and
   the sum into the accumulation), the accumulation bit for bit and the
   rays per bounce exact, with its device time, the chain's time and its
   bound;
2. the small-scene main path: ``Renderer.render_frames(8)`` on default
   1920x1080 depth 6, Cornell (NEE) and HDR glass with a 1024x2048
   synthetic map, launch counts reset before and read after (default and
   Cornell take their frames whole, one whole_frame launch a frame; HDR
   runs the split frame, fused_frame and env_sample; on the card
   a Renderer runs its first frame eagerly, captures the frame and replays
   it for the rest, phase 25; a replay adds to the counts what its capture
   counted, a conditional body's by the runs the device tallied);
3. the small-scene kernel image against the plain path's image, 320x240;
4. small-scene times: ms/frame and Mrays/s, kernel path (captured) and
   plain path (eager); the kernel path's device busy time and launches per
   frame (profiler);
5. the mesh kernels vs their plain versions on the card, on the procedural
   mesh scene (``mesh_scene``) at 512x384, every returned plane per lane:
   each at the inputs its main path gives it, recorded from one frame of
   that path (fused_bounce, the resident fused_frame and sort_chunks from
   the sorted frame, closest_hit / any_hit from regen), where its time and
   bound are taken; besides, closest_hit / any_hit on camera rays and on
   196 608 random rays, the resident fused_frame from bounce 0 on all
   lanes and on the edge lanes of ``FRAME_EDGES`` (all dead, 2 % alive at
   random, a ragged count, and live counts that give each warp 3 and 20
   lanes, run one at a time, from bounce 3), the resident fused_bounce on
   the same edge lanes at bounce 3, sort_chunks at chunks 8192 and 32768
   with 15 random planes, and the sort's launch shape (cluster size,
   registers, shared bytes, active clusters) at each chunk; sort_chunks is
   held to its plain version (a stable torch.sort) bit for bit in keys,
   lane ids and every plane; every fused_frame and fused_bounce call is
   held bit for bit on every plane (fused_frame's rays per bounce exact),
   and the queue kernels' calls log the live lanes queued and the blocks
   launched; fused_bounce's time and bound are taken per call;
6. the mesh main path: ``Renderer.render_frames(8)`` at 512x384 depth 4 in
   accel mode "resident" through the sorted frame, launch counts reset
   before and read after;
7. the standalone cluster tracer's main path: ``Renderer.render_frames(2)``
   with ``integrator="regen"`` on the mesh scene, which traces through
   ``intersect_v`` / ``occluded_v`` (closest_hit / any_hit);
8. mesh images: the sorted kernel path against the unsorted kernel path
   and against the plain path, 8 frames;
9. mesh times at 512x384 depth 4: ms/frame and Mrays/s, per-kernel device
   time (torch.profiler, on eager frames: ``eager_frames``) and launches
   per frame, torch.sort + gather beside sort_chunks;
10. the instanced kernels vs their plain versions on the card, on the
    textured instanced grid (``inst_grid_scene``, 104 448 world triangles)
    at 512x384, every returned plane per lane, at the inputs recorded from
    one regen frame (closest_hit_inst / any_hit_inst) and one sorted frame
    (fused_bounce and fused_frame instanced, textured, every plane bit for
    bit; sort_chunks at the full-width calls), where their times and
    bounds are taken; the textured fused_frame's time without its
    texture table (the sampler's share); the instanced fused_frame from
    bounce 0 on all lanes, timed, and on ``FRAME_EDGES``; the textured
    resident forms on the mesh scene;
11. the instanced main path: ``Renderer.render_frames(8)`` on the grid at
    512x384 depth 4 in accel mode "instanced", textured, through the sorted
    frame, launch counts reset before and read after; ms/frame (a second
    chain, of replays), Mrays/s and device busy;
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
    stream, textured, every plane bit for bit; sort_chunks at
    the full-width calls), where their times and bounds are taken; the
    stream fused_frame from bounce 0 on all lanes, timed, held on a band
    of STREAM_BAND of them, and on ``FRAME_EDGES``;
15. the stream main path: ``Renderer.render_frames(8)`` on the baked grid
    at 512x384 depth 4 through the sorted frame, launch counts reset before
    and read after; ms/frame (a second chain, of replays), Mrays/s, device
    busy and idle share, sorted and unsorted;
16. the stream tracer's standalone path: ``Renderer.render_frames(2)`` with
    ``integrator="regen"`` on the baked grid;
17. baked-grid images: the sorted kernel path against the unsorted one (8
    frames) and, at a quarter of the width and height, against the plain
    path (1 frame);
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
    against its plain version (every plane bit for bit; its small form on
    the small scenes, its resident form on the mesh), with its device
    time, bound and plain time; the small form's registers, spill and
    blocks per SM at each small scene's tables, and on default its edge
    lanes (``SMALL_BOUNCE_EDGES``: all dead, a third dead, ragged, 1 and 33
    lanes, is_last), bit for bit; K2 at each of the hdr frame's calls (one a bounce), bit for bit;
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
    anim, each exit 0 and its JSON line, echoed;
24. pixel-band sharding: every band of worlds of 2 and 4, one after another
    on the card through the per-shard body, on default and hdr 1920x1080 d6
    and the mesh scene 512x384 d4 (sorted frame), put together and held to
    the unsharded frame bit for bit with the rays summed exactly; per band
    its launches, device busy and K1's time a band launch, and on the mesh
    scene K3 at each call of a band-frame, bit for bit; then a real NCCL
    world of ``device_count()`` ranks (at most 4, one card each) running
    ``Renderer(multi_device=True).render_frames(8)`` on default 1080p d6,
    its image bit for bit and its stats equal to a single-device Renderer's,
    with the group's set-up, the frame times and the all_reduces timed, and
    the eager sharded step (``shard_frames`` and the two all_reduces)
    against the captured one in turns;
25. the captured step (``engine/renderer._captured_step_dyn``: a frame
    captured as one CUDA graph and replayed a frame; the sorted mesh
    frame's condense decision two IF nodes, the compact chunk loops and the
    regen loop WHILE nodes, decided on the device) against the eager
    ``frame_chain`` bit for bit: the masked integrator on default, cornell,
    hdr 1920x1080, the mesh scene, the instanced and the baked grid at
    512x384 sorted and unsorted; compact on default, cornell, hdr 1080p
    and the mesh scene; regen on default 1080p and the three 512x384
    scenes; the megakernel on default 1080p; anim (a moved camera and a
    reset a frame); two row bands of default, of the mesh scene and of
    compact default; two replays of each under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read); every
    launch count equal, the branches and loop bodies' runs among them, both
    branches seen; one graph launch a frame, the device tallies and the
    pool bytes; eager and captured in turns: wall ms/frame, device busy
    and idle share;
26. the inverse-rendering trainer (``examples/inverse_albedo_torch.py``,
    its gradient step ``megakernel.GradStep``: the forward pass and its
    backward captured as one graph, one replay a step, Adam outside it):
    (a) the JAX example's config, the default scene at 64x32 spp 1 d3, 150
    steps: the gradient at the 0.5 start captured against eager (bit for
    bit where two eager runs agree bit for bit, else phase 21's tolerance)
    and against the CPU's, the final error on the visible materials at
    most 0.01 on the JAX example's 7 of 9 visible rows; (b) the mesh scene
    at 512x384 d4 (K4 inside the captured step) and (c) the hdr config at
    512x384 d3 (K2 inside it), 10 steps each, the image MSE falling at
    every step; the kernels' launches a replayed step, the pool's bytes,
    eager and captured training steps in turns (wall ms a step) and the
    launches of a step (profiler);
27. the unfused route (``wavefront._fused_ok`` declines the scene, the
    frames run ``trace_bounce`` + ``shade_core`` in a WHILE node): the
    final render of *Ray Tracing in One Weekend* (``rtiow_scene``, 487
    spheres and materials, no accel) at 1920x1080 d6 masked and compact,
    the mesh scene and the instanced grid with a ring of 40 spheres
    (``add_sphere_ring``; K4 and K7 standalone) at 512x384 d4, and cornell
    with its light split into 8x8 quads (``cornell_split_light``, 128 NEE
    emitters) at 1920x1080 d8: each scene's decline reason, the captured
    step against ``frame_chain`` bit for bit with every launch count equal
    and a replay under sync-debug "error", no fused kernel launched, the
    scene's tracer kernels launched (and their shared bytes and blocks per
    SM at 41 spheres), the image against the plain path (< 1 % relative
    RMSE; not on the grid), eager and captured wall ms/frame in turns, the
    graph's nodes a replayed frame and its pool's bytes;
28. scenes whose tables pass a block's shared memory, their kernels
    reading the tables from global memory (``*_global_kernel``,
    ``cuda_bounce.tables_in_global``, ``cuda_trace.tables_in_global``): (a)
    the default scene under a row of 1 200 point lights (``light_row``) at
    1920x1080 d6, K1 small at the masked frame's call (its band held from
    bounce 5, one bounce) and K3 small at the compact bounce-0 call, the
    captured masked frames against ``frame_chain`` bit for bit (wall
    ms/frame in turns), compact's captured frame at 128x128 d3, two chunk
    loops (a replay, its launches counted, its ms beside the eager frame's,
    its graph's nodes by body, and a second replay) against
    ``frame_chain`` bit for bit, and at 128x128 ``MANY_LIGHT_FRAMES``
    (compact d4, regen, the megakernel, the unfused route masked and
    compact), two replays each bit for bit; (b)
    4 096
    instances (``wide_grid_scene``) at 512x384 d4, K3 and K1 instanced at
    the sorted frame's calls, the captured sorted frame against
    ``frame_chain``, K7 at one regen frame's first two calls of each kind;
    (c) the mesh scene and the baked grid under 5 000 point lights at
    128x96 d2, the captured sorted frames against ``frame_chain``, K3 and
    K1 resident and stream at the sorted frame's calls; (e) the mesh scene
    and the baked grid with 12 000 spheres, regen at 128x96 d2, K4 and K8;
    each call against its plain
    version on a band of its lanes spread over the call (``BAND_LANES``,
    ``lane_band``; the plain any-hit in one chunk, ``one_chunk``), every
    plane bit for bit, with the band's device ms, bound and plain ms and
    the whole call's device ms; each kernel launched on its main path and
    no shared-placement K1 or K3 on an overflowing scene; (d) on scenes
    that fit both placements (default 1080p d6; the mesh scene, the
    instanced and the baked grid at 512x384 d4), each form of K1, K3 (at
    the frames' calls), K4, K7 and K8 (on the frames' primary rays) with its
    tables shared against the global placement forced, bit for bit, their
    device ms in turns.

A mesh kernel's bound counts the operations of its walks from the plain
version's own results: each traced ray's box tests and the 64 triangle
tests of every cluster its final bound reaches (``_walk_ops``: the closest
hit and every shadow and NEE ray of the fused kernels).  A mesh
fused_frame's and every fused_bounce's bytes are those the call needs
(``frame_bytes``): the whole path state of a lane that runs a bounce, the
planes a dead lane copies through, the tables once, and the table rows its
plain walks open.  Phases 5, 10, 14
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
T_START = time.perf_counter()

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


def library_parts() -> dict:
    """Seconds of each child of the kernel library's set-up span
    ("library": hash, on a cold build compile.<source> and link, load)."""
    from spt_tpu_torch.utils import timing

    spans = timing.snapshot().spans
    lib = [s.id for s in spans if s.name == "library"]
    return {s.name: round((s.end_ns - s.start_ns) * 1e-9, 2) for s in spans
            if lib and s.parent == lib[0]}


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


def wide_grid_scene(scene_mod, materials_mod, desc_mod, side=64, stacks=4,
                    slices=6, seed=0):
    """``inst_grid_scene`` widened to a side x side grid: side^2 instances
    (4 096 at the default) of one textured UV sphere of stacks x slices x
    2 triangles (48 at the default), as a field of instanced trees or a
    crowd is: each rotated about y by 0.4 * (gx * side + gz), cells with
    (gx + gz) % 4 of 1 gold and of 3 glass, the materials and the texture
    (at 64 x 64) of ``inst_grid_scene``; an analytic glass sphere above the
    grid's centre; no ground plane.  196 608 world triangles over a one-
    cluster BLAS, so both packages instance it, and an instance table of
    side^2 x 22 words (360 KiB), past a block's shared memory.  Takes the
    scene, materials and scene.desc modules of either package.  Returns
    (SceneDesc, camera keyword arguments without aspect_ratio): over the
    grid's near edge, looking at its centre, fov 45."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base_tex, mr_tex = _checker_texture(np, rng, res=64)
    d = scene_mod.SceneDesc()
    d.add_material(scene_mod.Material([1.0, 1.0, 1.0], roughness=1.0,
                                      metallic=1.0,
                                      base_color_texture=base_tex,
                                      metallic_roughness_texture=mr_tex))
    d.add_material(materials_mod.gold())
    d.add_material(materials_mod.glass())
    a = d.add_mesh(scene_mod.create_sphere_mesh(stacks=stacks, slices=slices,
                                                radius=0.5, material_id=0))
    step = 1.3
    for gx in range(side):
        for gz in range(side):
            m = np.eye(4, dtype=np.float64)
            ang = 0.4 * (gx * side + gz)
            c, sn = np.cos(ang), np.sin(ang)
            m[:3, :3] = np.array([[c, 0.0, sn], [0.0, 1.0, 0.0],
                                  [-sn, 0.0, c]])
            m[:3, 3] = (gx * step, 0.0, gz * step)
            over = {1: 1, 3: 2}.get((gx + gz) % 4)
            if over is None:
                d.add_instance(a, m.astype(np.float32))
            else:
                d.add_instance(a, m.astype(np.float32), material_id=over)
    mid = 0.5 * (side - 1) * step
    d.add_sphere([mid, 2.0, mid], 1.5, 2)
    extent = side * step
    cam = dict(position=np.array([mid, 0.3 * extent, mid + 0.75 * extent],
                                 np.float32),
               target=np.array([mid, 0.0, mid], np.float32), fov_degrees=45.0)
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


def rtiow_scene(scene_mod, seed=0):
    """The final render of P. Shirley's *Ray Tracing in One Weekend*
    (raytracing.github.io, "A Final Render"): a ground sphere of radius
    1000, the 22x22 grid of radius-0.2 spheres drawn 80 / 15 / 5 %
    diffuse / metal / glass (diffuse albedo random * random a channel,
    metal albedo in [0.5, 1) and fuzz in [0, 0.5) as roughness, glass ior
    1.5) where a sphere clears (4, 0.2, 0) by 0.9, and the three large
    spheres (glass ior 1.5, diffuse (0.4, 0.2, 0.1), metal (0.7, 0.6, 0.5)
    fuzz 0); one material a sphere, drawn from numpy's `seed`.  Cuts: no
    defocus blur, the procedural sky in place of the book's gradient, no
    light but the sky.  Takes the scene module of either package.  Returns
    (SceneDesc, camera keyword arguments without aspect_ratio): from
    (13, 2, 3) to the origin, vertical fov 20."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mat = scene_mod.Material
    d = scene_mod.SceneDesc()

    def diffuse(c):
        return d.add_material(mat(c, roughness=1.0, ior=1.0))

    def metal(c, fuzz):
        return d.add_material(mat(c, metallic=1.0, roughness=fuzz))

    def glass():
        return d.add_material(mat([1.0, 1.0, 1.0], roughness=0.0, ior=1.5,
                                  mat_type=scene_mod.MATERIAL_TYPE_DIELECTRIC))

    d.add_sphere([0.0, -1000.0, 0.0], 1000.0, diffuse([0.5, 0.5, 0.5]))
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               b + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                m = diffuse(rng.random(3) * rng.random(3))
            elif choose < 0.95:
                m = metal(rng.uniform(0.5, 1.0, 3), rng.uniform(0.0, 0.5))
            else:
                m = glass()
            d.add_sphere(center, 0.2, m)
    d.add_sphere([0.0, 1.0, 0.0], 1.0, glass())
    d.add_sphere([-4.0, 1.0, 0.0], 1.0, diffuse([0.4, 0.2, 0.1]))
    d.add_sphere([4.0, 1.0, 0.0], 1.0, metal([0.7, 0.6, 0.5], 0.0))
    return d, dict(position=(13.0, 2.0, 3.0), target=(0.0, 0.0, 0.0),
                   fov_degrees=20.0)


def sphere_field(scene_mod, seed=3):
    """200 spheres and no triangles, no accel: a ground sphere and 199
    small ones of three materials (grey diffuse, copper metal, glass) at
    places drawn from numpy's `seed`; past the 192 primitives the fused
    kernels take without an accel, so it renders through the unfused
    route.  Takes the scene module of either package; the camera is
    ``SPHERE_POSE``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = scene_mod.SceneDesc()
    sphere_materials(scene_mod, d)
    d.add_sphere([0.0, -100.0, 0.0], 100.0, 0)
    for _ in range(199):
        d.add_sphere(rng.uniform([-3.0, 0.1, -3.0], [3.0, 1.5, 1.0]),
                     float(rng.uniform(0.08, 0.25)), int(rng.integers(3)))
    return d


def sphere_materials(scene_mod, d):
    """Add sphere_field's three materials to the SceneDesc `d`: grey
    diffuse (0), copper metal (1), glass (2)."""
    d.add_material(scene_mod.Material([0.7, 0.7, 0.7], roughness=0.8))
    d.add_material(scene_mod.Material([0.9, 0.6, 0.3], metallic=1.0,
                                      roughness=0.2))
    d.add_material(scene_mod.Material(
        [1.0, 1.0, 1.0], roughness=0.0, ior=1.5,
        mat_type=scene_mod.MATERIAL_TYPE_DIELECTRIC))


SPHERE_POSE = dict(position=(0.0, 1.4, 5.0), target=(0.0, 0.6, 0.0),
                   fov_degrees=50.0)


def light_row(manager, n, start, step, intensity):
    """`manager` (a LightManager of either package) with n point lights at
    start + i * step for i < n, each of `intensity`: a row of lamps, as a
    street or a stage has, for the scenes whose light table passes a
    block's shared memory (phase 28)."""
    for i in range(n):
        manager.add_point_light(
            tuple(float(s + i * t) for s, t in zip(start, step)),
            intensity=intensity)
    return manager


def add_sphere_ring(desc, center, radius, n=40, r=0.06, materials=(0, 1, 2)):
    """`n` analytic spheres of radius `r` on a wavy horizontal ring of
    `radius` around `center`, their materials cycling through
    `materials`."""
    import numpy as np

    for i in range(n):
        a = 2.0 * np.pi * i / n
        desc.add_sphere([center[0] + radius * np.cos(a),
                         center[1] + 0.3 * radius * np.sin(3.0 * a),
                         center[2] + radius * np.sin(a)], r,
                        materials[i % len(materials)])
    return desc


def cornell_split_light(scene_mod, materials_mod, split=8):
    """The cornell config's box (spt_tpu_torch/scene/builder.py
    build_cornell_box_scene, the same walls, spheres and materials) with its
    ceiling light split into split x split quads: 2 * split^2 emissive
    triangles (128 at 8), every one an NEE emitter, 140 primitives in all.
    Takes the scene and materials modules of either package."""
    import numpy as np

    d = scene_mod.SceneDesc()
    mat = scene_mod.Material
    white = d.add_material(mat([0.73, 0.73, 0.73], roughness=0.9, ior=1.0))
    red = d.add_material(mat([0.65, 0.05, 0.05], roughness=0.9, ior=1.0))
    green = d.add_material(mat([0.12, 0.45, 0.15], roughness=0.9, ior=1.0))
    lamp = d.add_material(materials_mod.light((1.0, 0.9, 0.75), 15.0))
    mirror = d.add_material(materials_mod.silver())
    glass = d.add_material(materials_mod.glass())

    def quad(p0, p1, p2, p3, m):
        mid = d.add_mesh(scene_mod.MeshData(
            positions=np.array([p0, p1, p2, p3], np.float32),
            indices=np.array([[0, 1, 2], [0, 2, 3]], np.uint32),
            material_id=m))
        d.add_instance(mid, np.eye(4, dtype=np.float32), material_id=m)

    s = 2.75
    quad([-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s], white)
    quad([-s, 2 * s, -s], [-s, 2 * s, s], [s, 2 * s, s], [s, 2 * s, -s], white)
    quad([-s, 0, -s], [-s, 2 * s, -s], [s, 2 * s, -s], [s, 0, -s], white)
    quad([-s, 0, -s], [-s, 0, s], [-s, 2 * s, s], [-s, 2 * s, -s], red)
    quad([s, 0, -s], [s, 2 * s, -s], [s, 2 * s, s], [s, 0, s], green)
    l, y = 0.9, 2 * s - 0.01
    edges = np.linspace(-l, l, split + 1)
    for i in range(split):
        for j in range(split):
            x0, x1, z0, z1 = edges[i], edges[i + 1], edges[j], edges[j + 1]
            quad([x0, y, z0], [x1, y, z0], [x1, y, z1], [x0, y, z1], lamp)
    d.add_sphere([-1.1, 0.9, -0.9], 0.9, mirror)
    d.add_sphere([1.1, 0.9, 0.6], 0.9, glass)
    return d


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
    """Route the wavefront's kernels and the standalone tracers to their
    plain PyTorch versions, run eagerly: a Renderer made or used inside
    takes ``frame_chain``, not a captured graph."""
    from spt_tpu_torch.engine import renderer as renderer_mod
    from spt_tpu_torch.ops import cuda_bounce, cuda_env, cuda_sort, cuda_trace

    swaps = [(cuda_bounce, "fused_frame", cuda_bounce.fused_frame_reference),
             (cuda_bounce, "fused_bounce", cuda_bounce.fused_bounce_reference),
             (cuda_sort, "sort_chunks", cuda_sort.sort_chunks_reference),
             (cuda_env, "env_sample", cuda_env.env_sample_reference),
             (cuda_trace, "closest_hit", cuda_trace.closest_hit_reference),
             (cuda_trace, "any_hit", cuda_trace.any_hit_reference),
             (cuda_trace, "inst_closest_hit",
              cuda_trace.inst_closest_hit_reference),
             (cuda_trace, "inst_any_hit", cuda_trace.inst_any_hit_reference),
             (cuda_trace, "stream_closest_hit",
              cuda_trace.closest_hit_reference),
             (cuda_trace, "stream_any_hit", cuda_trace.any_hit_reference),
             (renderer_mod, "captures", lambda cfg, device: False)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    try:
        for m, name, ref in swaps:
            setattr(m, name, ref)
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


@contextlib.contextmanager
def eager_frames():
    """Run a Renderer's frames through ``frame_chain``, its kernels
    eagerly: the profiler's trace of a captured frame loses or misnames the
    kernels inside its conditional nodes' bodies, so the per-kernel device
    times of a sorted frame are taken from eager frames of the same kernels
    on the same inputs."""
    from spt_tpu_torch.engine import renderer as renderer_mod

    saved = renderer_mod.captures
    renderer_mod.captures = lambda cfg, device: False
    try:
        yield
    finally:
        renderer_mod.captures = saved


def reset_counts():
    from spt_tpu_torch.integrators import wavefront

    wavefront.launch_counts()   # folds what earlier replays' bodies ran
    for m, name in wavefront._LAUNCH_COUNTERS:
        setattr(m, name, 0)
    wavefront.SORTED_SAMPLES.clear()
    wavefront.LOOP_RUNS.clear()


def read_counts() -> dict:
    """The wrappers' launch counts (a captured frame's replays add what
    its capture counted, wavefront.SegmentedGraph: its conditional bodies'
    launches by the runs the device tallied, read here)."""
    from spt_tpu_torch.integrators import wavefront
    from spt_tpu_torch.ops import cuda_bounce, cuda_env, cuda_sort, cuda_trace

    wavefront.launch_counts()

    return {"fused_frame": cuda_bounce.LAUNCHES,
            "whole_frame": cuda_bounce.WHOLE_LAUNCHES,
            "fused_bounce": cuda_bounce.BOUNCE_LAUNCHES,
            "sort_chunks": cuda_sort.LAUNCHES,
            "closest_hit": cuda_trace.CLOSEST_LAUNCHES,
            "any_hit": cuda_trace.ANY_LAUNCHES,
            "closest_hit_inst": cuda_trace.INST_CLOSEST_LAUNCHES,
            "any_hit_inst": cuda_trace.INST_ANY_LAUNCHES,
            "closest_hit_stream": cuda_trace.STREAM_CLOSEST_LAUNCHES,
            "any_hit_stream": cuda_trace.STREAM_ANY_LAUNCHES,
            "env_sample": cuda_env.LAUNCHES,
            # the same kernels with their tables in global memory (phase 28)
            "fused_frame_global": cuda_bounce.GLOBAL_LAUNCHES,
            "fused_bounce_global": cuda_bounce.GLOBAL_BOUNCE_LAUNCHES,
            "whole_frame_global": cuda_bounce.WHOLE_GLOBAL_LAUNCHES,
            "closest_hit_global": cuda_trace.CLOSEST_GLOBAL_LAUNCHES,
            "any_hit_global": cuda_trace.ANY_GLOBAL_LAUNCHES,
            "closest_hit_inst_global": cuda_trace.INST_CLOSEST_GLOBAL_LAUNCHES,
            "any_hit_inst_global": cuda_trace.INST_ANY_GLOBAL_LAUNCHES,
            "closest_hit_stream_global":
                cuda_trace.STREAM_CLOSEST_GLOBAL_LAUNCHES,
            "any_hit_stream_global": cuda_trace.STREAM_ANY_GLOBAL_LAUNCHES}


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


def whole_vs_plain(torch, cuda_bounce, cfg, scene, lights, cam, ops, dev,
                   smi) -> dict:
    """Phase 1 on default: K1's whole-frame form at the main path's call
    (one frame from frame index 0, added into an accumulation of zeros),
    with its tables in each placement, against its plain version, the
    split frame's chain in plain PyTorch (``plain_path``: primary_lanes,
    fused_frame_reference and the sky term in ``render_wavefront``, then
    accumulate_'s sum), the accumulation bit for bit and the rays per
    bounce equal.  Returns the kernel-line numbers of "whole_frame" and
    "whole_frame_global": the kernel's device ms, the chain's ms and the
    bound (24 B a lane, the accumulation read and written, and the counts;
    the split form's counted operations, ``ops``)."""
    from spt_tpu_torch.env import make_procedural_environment
    from spt_tpu_torch.integrators import wavefront

    env = make_procedural_environment(dev)
    rays = cam.rays(dev)
    n = cfg.width * cfg.height
    fi = torch.zeros((), dtype=torch.int32, device=dev)
    cam_buf = torch.cat([rays.position, rays.forward, rays.right, rays.up,
                         rays.half_width.reshape(1),
                         rays.half_height.reshape(1)])
    tables = cuda_bounce.frame_tables(cfg, scene, lights)

    def plain():
        with plain_path():
            img, stats = wavefront.render_wavefront(cfg, scene, env, lights,
                                                    rays, fi)
        acc = torch.zeros(n, 3, dtype=torch.float32, device=dev)
        acc.add_(img.reshape(-1, 3) * float(cfg.spp))
        return acc, stats.rays_per_bounce

    p_acc, p_rays = plain()
    plain_ms = time_call(torch, plain, warmup=1, iters=3)
    b = bound(n * 24 + (cfg.max_depth + 3) * 8, ops)
    out = {}
    for in_global in (False, True):
        name = "whole_frame_global" if in_global else "whole_frame"
        acc = torch.zeros(n, 3, dtype=torch.float32, device=dev)
        k_rays = cuda_bounce.whole_frame(cfg, scene, lights, cam_buf, acc, fi,
                                         tables, _in_global=in_global)
        torch.cuda.synchronize()
        err = check_planes(torch, f"{name}, default {W}x{H} d{cfg.max_depth} "
                           "one frame into zeros", {"accum": (acc, p_acc)},
                           phase=1, exact=("accum",))
        rk, rp = k_rays.tolist(), p_rays.tolist()
        if rk != rp:
            raise AssertionError(f"{name}'s rays per bounce {rk} differ from "
                                 f"the plain chain's {rp}")
        scratch = torch.zeros_like(acc)
        ms = kernel_device_ms(torch, lambda: cuda_bounce.whole_frame(
            cfg, scene, lights, cam_buf, scratch, fi, tables,
            _in_global=in_global), f"{name}_kernel")
        log(f"phase 1 {name} at default {W}x{H} d{cfg.max_depth}: rays per "
            f"bounce {rk} (equal to the plain chain's); kernel {ms:.4f} ms "
            f"(device time), plain chain {plain_ms:.4f} ms per call, bound "
            f"{b[0]:.4f} ms ({b[1]}; {ops_note(ops)}) [{smi}]")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=b,
                         library_ms=None)
    return out


def phase_kernel_vs_plain(torch, cuda_bounce, dev, smi):
    """Phase 1.  Returns the default-scene numbers for the kernel line,
    the whole-frame form's under "whole"."""
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
        with capture_calls([(transport, "shade_core")]) as bounces:
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
        infos = cuda_lib.kernel_info({"fused_frame": smem, "whole_frame": smem})
        info, whole = infos["fused_frame"], infos["whole_frame"]
        log(f"phase 1 fused_frame small at {name} {W}x{H} d{cfg.max_depth}: "
            f"kernel {ms:.4f} ms (device time), wrapper {wrapper_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms per call, bound {b[0]:.4f} ms ({b[1]}; "
            f"{ops_note(ops)}); {info['registers']} registers, "
            f"{info['local_bytes']} B local, {smem} B shared a block, "
            f"{info['blocks_per_sm']} blocks/SM (the whole-frame form "
            f"{whole['registers']}, {whole['local_bytes']} B, "
            f"{whole['blocks_per_sm']}); SIMT efficiency of the "
            f"plain version's paths in pixel order: warps of 32 "
            f"{simt_efficiency(torch, lane_bounces, 32):.4f}, blocks of 128 "
            f"{simt_efficiency(torch, lane_bounces, 128):.4f} [{smi}]")
        if name == "default":
            result = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                          bound=b, whole=whole_vs_plain(
                              torch, cuda_bounce, cfg, scene, lights, cam,
                              ops, dev, smi))
    return result


def phase_main_path(torch, np, cuda_bounce, dev, out_dir):
    """Phase 2: the small-scene Renderer on the card; returns the launch
    counts of K1 small's split form (fused_frame: hdr), of its whole-frame
    form (whole_frame: default and cornell, under the procedural sky, take
    their frames whole) and of the environment sampler (on hdr, whose map
    made the .hdr round trip)."""
    from spt_tpu_torch.ops import cuda_env

    frames = 8
    renderers = {name: renderer(name, W, H, dev)
                 for name in ("default", "cornell", "hdr")}
    torch.cuda.synchronize()
    reset_counts()
    for name, r in renderers.items():
        before = read_counts()
        r.render_frames(frames)
        torch.cuda.synchronize()
        after = read_counts()
        grew, whole, env_grew = (after[k] - before[k] for k in (
            "fused_frame", "whole_frame", "env_sample"))
        rays, path = check_image(np, r, name, out_dir, frames)
        log(f"phase 2 {name} {W}x{H} d{r.cfg.max_depth}: {frames} frames, "
            f"fused_frame +{grew}, whole_frame +{whole}, env_sample "
            f"+{env_grew}, rays_per_bounce {rays.tolist()}, mean hdr "
            f"{float(r.hdr_image().mean()):.6g}, png {path}")
        want = (0, frames) if name != "hdr" else (frames, 0)
        if (grew, whole) != want:
            raise AssertionError(f"{name}: fused_frame grew by {grew} and "
                                 f"whole_frame by {whole}, expected {want}")
        if env_grew != (frames if name == "hdr" else 0):
            raise AssertionError(f"{name}: env_sample grew by {env_grew}")
    counts = read_counts()
    return counts["fused_frame"], counts["whole_frame"], counts["env_sample"]


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


def _cluster_trace_ops(torch, scene, o, d, tmin, tmax, t_end, blocked=None,
                       opened=None):
    """The operations the resident tracer needs on these rays, counted from
    the plain version's result: every lane with a non-empty interval
    slab-tests every real cluster box (~24 flops) and every sphere (~20),
    and runs the 64 Moller-Trumbore tests (~40 flops each) of every cluster
    box its final bound min(tmax, t_end) still reaches.  A blocked any-hit
    lane counts one test.  With `opened` (see ``_walk_ops``), marks the
    clusters those tests open."""
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
        hit = (tn <= tf) & live[sl][None]
        ops += float(hit.sum()) * a.cluster_size * 40
        _mark(torch, opened, "clusters", a.num_clusters,
              torch.nonzero(real).flatten()[hit.any(1)])
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


def _walk_ops(torch, scene, plain, touched=None):
    """(plain(), operations): runs the plain version of a fused kernel and
    counts, from the plain tracers' own results, the operations of every
    walk the kernel's tracer makes on the scene: each live lane's closest
    hit to its final t and each shadow or NEE ray that shade_core traces
    (intersect_v / occluded_v).  A mesh scene's `touched`, a dict, gets
    boolean masks of the table rows those walks and the texture sampler
    open: "clusters" (over the tri_pack clusters), "supers" (stream) and
    "texels" (over the texture table's rows)."""
    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.ops import cuda_bounce
    from spt_tpu_torch.ops import intersect as isect

    trace_ops = {None: _brute_trace_ops, "resident": _cluster_trace_ops,
                 "instanced": _inst_trace_ops,
                 "stream": _stream_trace_ops}[cuda_bounce._accel_mode(scene)]
    extra = {} if touched is None else {"opened": touched}
    targets = [(isect, "intersect_v"), (isect, "occluded_v")]
    if touched is not None:
        targets.append((transport, "sample_texture_v"))

    with capture_calls(targets, results=True) as calls:
        out = plain()
    # the counts add up lane by lane, so the traces of one kind and tmin are
    # counted together, WALK_BATCH lanes at a time (a frame under thousands
    # of lights makes thousands of shadow traces)
    batches, ops = {}, 0.0
    for name, args, kw, res in calls:
        if name == "sample_texture_v":
            _mark_texels(torch, touched, *args)
            continue
        _, o, d = args
        tmin = kw["tmin"]
        tmax = torch.broadcast_to(torch.as_tensor(
            kw["tmax"], device=o.x.device, dtype=torch.float32), o.x.shape)
        blocked = None if name == "intersect_v" else res
        t_end = res.t if name == "intersect_v" else tmax
        batch = batches.setdefault((name, tmin), [])
        batch.append((o, d, tmax, t_end, blocked))
        if sum(b[0].x.shape[0] for b in batch) >= WALK_BATCH:
            ops += _batch_ops(torch, trace_ops, scene, tmin, batch, extra)
            batch.clear()
    for (_, tmin), batch in batches.items():
        if batch:
            ops += _batch_ops(torch, trace_ops, scene, tmin, batch, extra)
    return out, ops


# Lanes of traces that _walk_ops counts at once.
WALK_BATCH = 16384


def _batch_ops(torch, trace_ops, scene, tmin, batch, extra):
    """trace_ops on the traces of `batch` ((o, d, tmax, t_end, blocked) of
    one kind and tmin) put together lane by lane."""
    from spt_tpu_torch.ops.vec3 import Vec3

    def cat(k):
        return torch.cat([b[k] for b in batch])

    o, d = (Vec3(*(torch.cat([b[k][c] for b in batch]) for c in range(3)))
            for k in (0, 1))
    blocked = None if batch[0][4] is None else cat(4)
    return trace_ops(torch, scene, o, d, tmin, cat(2), cat(3),
                     blocked=blocked, **extra)


def _mark(torch, touched, key, size, ids):
    """Set `ids` in touched[key], a (size,) boolean mask made on first use;
    nothing when `touched` is None."""
    if touched is None:
        return
    if key not in touched:
        touched[key] = torch.zeros(size, dtype=torch.bool, device=ids.device)
    touched[key][ids] = True


def _mark_texels(torch, touched, textures, tex_id, uvx, uvy):
    """Mark in touched["texels"] the texture table rows the four taps of
    sample_texture_v read on the lanes that sample (tex_id >= 0)."""
    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.materials import tex_res_of

    res = tex_res_of(textures)
    has = tex_id >= 0
    (x0, x1, y0, y1), _ = transport._bilinear_setup(uvx[has], uvy[has], res)
    base = tex_id[has].to(torch.int64) * (res * res)
    for xi in (x0, x1):
        for yi in (y0, y1):
            _mark(torch, touched, "texels", textures.shape[0] * res * res,
                  base + (yi * res + xi).to(torch.int64))


@contextlib.contextmanager
def capture_calls(targets, results=False):
    """Record (name, args, kwargs) of every call of the (module, function
    name) targets made while the context is open, with the call's result
    appended when `results`; the calls still run.  A Renderer used inside
    runs its frames eagerly (frame_chain), so each recorded call is a
    launch on the inputs its path gives it, not one recorded into a
    graph."""
    from spt_tpu_torch.engine import renderer as renderer_mod

    calls = []
    targets = list(targets) + [(renderer_mod, "captures")]
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
            setattr(m, name, (lambda cfg, device: False)
                    if m is renderer_mod else recording(name, fn))
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
    """Dynamic shared memory of a standalone tracer's block on this scene
    (its tables in the shared placement)."""
    from spt_tpu_torch.ops import cuda_trace as ct

    inputs = {"closest_hit": ct._resident_inputs, "any_hit": ct._resident_inputs,
              "inst_closest_hit": ct._inst_inputs, "inst_any_hit": ct._inst_inputs,
              "stream_closest_hit": ct._stream_inputs,
              "stream_any_hit": ct._stream_inputs}[fn_name]
    tables, _, dims = inputs(acc, scene)[:3]
    return ct.shared_bytes(tables, dims[0])


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


# Lanes a queue kernel (a mesh fused_frame, the resident fused_bounce) has
# to get right beside its main path's calls, each from bounce 3 of a
# full-width primary state: every lane dead; 2 % of the lanes alive at
# random positions (unsorted); the same lanes less 77, a count that is no
# multiple of 32 or 128; and as many lanes alive at random positions as
# give each warp of the launched grid 3, then 20, lanes (csrc/spt_queue.cuh:
# each warp runs them FRAME_TAKE_MAX (one) at a time, all its threads twins
# of the path, taking more from the queue as its paths end; edge_take).
FRAME_EDGES = ("all_dead", "scattered", "ragged", "take3", "take20")

# Warps a block of a queue kernel (csrc/spt_queue.cuh kBlock / 32), and the
# most lanes a warp takes at once below 32 (kTakeMax there).
FRAME_BLOCK_WARPS = 4
FRAME_TAKE_MAX = 1

# Bytes of fused_frame's path state: a lane that runs a bounce reads 12
# float planes, the int64 RNG word and two byte flags and writes 9 float
# planes and the missed byte; a lane that does not reads its direction,
# throughput and radiance planes and its alive byte and writes them and
# missed.
FRAME_LANE_BYTES = 58 + 37
FRAME_DEAD_LANE_BYTES = 37 + 37


def frame_grid(torch, cfg, scene, lights, ps) -> int:
    """Blocks a mesh fused_frame launches on the lanes of `ps`, as the
    kernel reports them on a call where every lane is dead."""
    from spt_tpu_torch.ops import cuda_bounce

    dead = ps._replace(alive=torch.zeros_like(ps.alive))
    return frame_counters(torch, cuda_bounce.fused_frame(
        cfg, scene, lights, dead, cfg.max_depth - 1)[4])[1]


def frame_edge(torch, np, case, ps, grid=None):
    """(PathState, start_bounce) of one of FRAME_EDGES from the primary
    state `ps`; the take cases need the `grid` the kernel launches on these
    lanes (frame_grid, bounce_grid)."""
    if case == "all_dead":
        return ps._replace(alive=torch.zeros_like(ps.alive)), 3
    n = ps.num_paths
    g = np.random.default_rng(19)
    if case.startswith("take"):
        warps = grid * FRAME_BLOCK_WARPS
        live = warps * (int(case[4:]) - 1) + warps // 2
        if live > n:
            raise ValueError(f"{case}: {live} live lanes > {n}")
        keep = np.zeros(n, dtype=bool)
        keep[g.permutation(n)[:live]] = True
    else:
        keep = g.random(n) < 0.02
    ps = ps._replace(alive=torch.from_numpy(keep).to(ps.alive.device))
    if case == "scattered" or case.startswith("take"):
        return ps, 3
    if case != "ragged":
        raise ValueError(f"unknown fused_frame case {case!r}")
    return first_lanes(ps, n - 77), 3


def first_lanes(ps, m):
    """The path state of the first `m` lanes of `ps`, each plane contiguous."""
    return type(ps)(*(type(f)(*(c[:m].contiguous() for c in f))
                      if isinstance(f, tuple) else f[:m].contiguous()
                      for f in ps))


def frame_bytes(torch, cfg, scene, lights, ps, start, touched,
                lane_bytes=(FRAME_LANE_BYTES, FRAME_DEAD_LANE_BYTES)) -> dict:
    """The bytes a fused_frame call from bounce `start` (or, with
    `lane_bytes` BOUNCE_LANE_BYTES twice, a fused_bounce call at bounce
    `start`) must move, by part: the path state (lane_bytes: a lane that
    runs a bounce, one that does not), the shared tables once, and in a
    mesh form the table rows the plain walks and sampler opened (`touched`,
    from _walk_ops): each opened cluster's tri_pack rows, each opened
    super's cluster boxes and one octant's visit order (stream), each
    texture row read."""
    from spt_tpu_torch.ops import cuda_bounce, cuda_trace

    mode = cuda_bounce._accel_mode(scene)
    runs = int(ps.alive.sum()) if start < cfg.max_depth else 0
    nee_on = cfg.nee and scene.emitters is not None
    out = {"lanes": runs * lane_bytes[0]
           + (ps.num_paths - runs) * lane_bytes[1],
           "tables": 4 * cuda_bounce._pack_tables(scene, lights, nee_on,
                                                  mode).numel()}
    if mode is None:
        return out
    src = scene.inst if mode == "instanced" else scene.accel

    def opened(key):
        return int(touched[key].sum()) if key in touched else 0

    out["clusters"] = opened("clusters") * src.tri_pack[0].numel() * 4
    if mode == "stream":
        cbox, corder = cuda_trace.stream_globals(scene.accel)
        out["supers"] = opened("supers") * 16 * (cbox[0].numel() * 4
                                                 + corder.element_size())
    if scene.textures is not None:
        out["texels"] = opened("texels") * scene.textures[0, 0].numel() * 4
    return out


def frame_bits_equal(torch, k, p) -> dict:
    """{plane: equal bit for bit} of two fused_frame results; missed must
    be bool and the rays per bounce int64 on both sides."""
    names = ("radiance", "direction", "throughput")
    out = {name: all(_same_bits(torch, x, y) for x, y in zip(a, b))
           for name, a, b in zip(names, k[:3], p[:3])}
    out["missed"] = (k[3].dtype == p[3].dtype == torch.bool
                     and torch.equal(k[3], p[3]))
    out["rays"] = (k[4].dtype == p[4].dtype == torch.int64
                   and torch.equal(k[4], p[4]))
    return out


def frame_counters(torch, out):
    """(lanes queued, blocks launched) of the queue kernel launch that wrote
    `out`, fused_frame's rays per bounce or the resident fused_bounce's new
    RNG words: the counters the kernel keeps after them in the same int64
    buffer (csrc/fused_frame.cu FrameIO.counts, csrc/fused_bounce.cu
    BounceIO.counters; 0 in fused_frame's small form)."""
    full = out.as_strided((out.untyped_storage().nbytes() // 8,), (1,), 0)
    return int(full[-2]), int(full[-1])


def frame_take(torch, out) -> int:
    """Lanes each warp took from the queue at once in the queue kernel
    launch that wrote `out` (frame_counters): the kernels' rule on their
    counters, live / (warps in the grid) rounded up, 32 when that reaches
    32, else at most FRAME_TAKE_MAX."""
    queued, blocks = frame_counters(torch, out)
    if not blocks:
        return 0
    take = min(32, -(-queued // (blocks * FRAME_BLOCK_WARPS)))
    return take if take == 32 else min(take, FRAME_TAKE_MAX)


def edge_take(case):
    """The lanes each warp takes at once on the edge case `case` of
    FRAME_EDGES (frame_take), or None where the case does not set it."""
    if not case.startswith("take"):
        return None
    return min(int(case[4:]), FRAME_TAKE_MAX)


def check_frame(torch, phase, what, args, kw, with_bound=False,
                expect_take=None, live_only=False, band=None):
    """A fused_frame call against its plain version on the card: every
    plane bit for bit, missed as bool and the rays per bounce exact, and
    in a mesh form the kernel's queue holding every live lane.  Logs the
    live lanes, the blocks the kernel launched and the lanes each warp took
    at once, which must be `expect_take` where that is given.  With
    `live_only` the plain version runs on the call's live lanes and
    FRAME_DEAD_SAMPLE of its dead ones (``live_lanes``; a lane's path is
    its own and a dead lane adds no ray, so its rays per bounce are the
    whole call's), held against the kernel's whole call on those lanes;
    with `band` on that many of the call's lanes (``band_lanes``), the
    same, the rays per bounce (a count over the whole call) not held.
    Returns (max |d|, the call's bound when `with_bound` else None: the
    operations of its walks and the bytes of frame_bytes, the plain
    version's ms)."""
    from spt_tpu_torch.ops import cuda_bounce

    ps = args[3]
    start = kw.get("start_bounce", args[4] if len(args) > 4 else 0)
    queue = cuda_bounce._accel_mode(args[1]) is not None
    fk = cuda_bounce.fused_frame(*args, **kw)
    queued, blocks = frame_counters(torch, fk[4])
    pargs, on = args, ""
    if live_only or band:
        idx = (live_lanes(torch, ps, FRAME_DEAD_SAMPLE) if live_only
               else band_lanes(torch, ps, band))
        pargs = (*args[:3], _take_lanes(ps, idx), *args[4:])
        fk = tuple(_take_lanes(f, idx) for f in fk[:4]) + (fk[4],)
        on = (f", held on its live lanes and {idx.numel()} in all"
              if live_only else f", held on a band of {idx.numel()}")
    plain = lambda: _timed(  # noqa: E731
        torch, lambda: cuda_bounce.fused_frame_reference(*pargs, **kw))
    b = None
    if with_bound:
        touched = {} if queue else None
        (fp, plain_ms), n_ops = _walk_ops(torch, args[1], plain, touched)
        parts = frame_bytes(torch, *args[:4], start, touched or {})
        b = bound(sum(parts.values()), n_ops)
        log(f"phase {phase} {what} from bounce {start}: bound {b[0]:.4f} ms "
            f"({b[1]}; bytes {sum(parts.values())}: " + ", ".join(
                f"{k} {v}" for k, v in parts.items()) + f"; {ops_note(n_ops)})")
    else:
        fp, plain_ms = plain()
    rk, rp = fk[4].tolist(), fp[4].tolist()
    alive = int(ps.alive.sum()) if start < args[0].max_depth else 0
    take = frame_take(torch, fk[4])
    worst = check_planes(
        torch, f"{what} from bounce {start} ({ps.num_paths} lanes, "
        f"{int(ps.alive.sum())} alive; the kernel queued {queued} lanes on "
        f"{blocks} blocks, {take} a warp at once{on}); rays_per_bounce "
        f"kernel {rk} plain {'(the band alone) ' if band else ''}{rp}",
        {"radiance": (_v(torch, fk[0]), _v(torch, fp[0])),
         "direction": (_v(torch, fk[1]), _v(torch, fp[1])),
         "throughput": (_v(torch, fk[2]), _v(torch, fp[2])),
         "missed": (fk[3], fp[3])}, phase=phase,
        exact=("radiance", "direction", "throughput", "missed"))
    if ((rk != rp and not band) or fk[4].dtype != torch.int64
            or fk[3].dtype != torch.bool or (queue and queued != alive)):
        raise AssertionError(
            f"{what}: rays_per_bounce {rk} ({fk[4].dtype}) against plain "
            f"{rp}, missed {fk[3].dtype}, {queued} lanes queued of {alive} "
            "alive")
    if expect_take is not None and take != expect_take:
        raise AssertionError(f"{what}: the warps took {take} lanes at once, "
                             f"not {expect_take}")
    return worst, b, plain_ms


def check_frame_edges(torch, np, phase, what, cfg, scene, lights, ps):
    """check_frame on each of FRAME_EDGES from the primary state `ps`, the
    plain version on the live lanes (``live_only``)."""
    grid = frame_grid(torch, cfg, scene, lights, ps)
    for case in FRAME_EDGES:
        eps, start = frame_edge(torch, np, case, ps, grid)
        check_frame(torch, phase, f"{what} {case}", (cfg, scene, lights, eps),
                    {"start_bounce": start}, expect_take=edge_take(case),
                    live_only=True)


# Dead lanes of an edge case that its plain check takes beside the live
# ones (``check_frame`` with ``live_only``).
FRAME_DEAD_SAMPLE = 4096


def live_lanes(torch, ps, k):
    """The lane ids of every live lane of `ps` and of k of its dead ones
    spread over them (``spread``), in lane order."""
    alive = torch.nonzero(ps.alive).flatten()
    dead = torch.nonzero(~ps.alive).flatten()
    return torch.sort(torch.cat([alive, spread(torch, dead, k)])).values


def _take_lanes(x, idx):
    """`x` (a PathState, a Vec3 or a lane tensor) at the lanes `idx`."""
    import torch

    if isinstance(x, torch.Tensor):
        return x[idx].contiguous()
    return type(x)(*(_take_lanes(f, idx) for f in x))


# Bytes of fused_bounce's path state a lane: 12 float planes, the int64 RNG
# word and two byte flags in (58 B), the same and the missed byte out
# (59 B).  A dead lane is carried through, so it moves as many.
BOUNCE_LANE_BYTES = 58 + 59


def bounce_grid(torch, cfg, scene, lights, ps) -> int:
    """Blocks the resident fused_bounce launches on the lanes of `ps`, as
    the kernel reports them on a call where every lane is dead."""
    from spt_tpu_torch.ops import cuda_bounce

    dead = ps._replace(alive=torch.zeros_like(ps.alive))
    return frame_counters(torch, cuda_bounce.fused_bounce(
        cfg, scene, lights, dead, 1, False)[0].rng)[1]


def check_bounce(torch, phase, what, args, kw=None, with_bound=False,
                 expect_take=None, smi=None, iters=10):
    """A fused_bounce call against its plain version on the card: every
    plane bit for bit (rng int64, the flags and missed bool), and in the
    resident form the kernel's queue holding every live lane, with the live
    lanes, the blocks it launched and the lanes each warp took at once
    logged (the take must be `expect_take` where that is given).  With
    `with_bound`, also the call's bound (the operations of its walks and the
    bytes of frame_bytes at BOUNCE_LANE_BYTES a lane) and its device time,
    logged with `smi` (`iters` timed launches).  Returns dict(max_abs_err,
    plain_ms, bound, ms, nbytes, ops), the last four None without
    `with_bound`."""
    from spt_tpu_torch.ops import cuda_bounce

    kw = kw or {}
    cfg, scene, lights, ps, bounce = args[:5]
    mode = cuda_bounce._accel_mode(scene)
    ks, km = cuda_bounce.fused_bounce(*args, **kw)
    plain = lambda: _timed(  # noqa: E731
        torch, lambda: cuda_bounce.fused_bounce_reference(*args, **kw))
    out = dict(bound=None, ms=None, nbytes=None, ops=None)
    if with_bound:
        touched = None if mode is None else {}
        ((ps_, pm), plain_ms), out["ops"] = _walk_ops(torch, scene, plain,
                                                      touched)
        parts = frame_bytes(torch, cfg, scene, lights, ps, bounce,
                            touched or {}, (BOUNCE_LANE_BYTES,) * 2)
        out["nbytes"] = sum(parts.values())
        out["bound"] = bound(out["nbytes"], out["ops"])
    else:
        (ps_, pm), plain_ms = plain()
    alive = int(ps.alive.sum())
    note = ""
    if mode == "resident":
        queued, blocks = frame_counters(torch, ks.rng)
        take = frame_take(torch, ks.rng)
        note = (f"; the kernel queued {queued} lanes on {blocks} blocks, "
                f"{take} a warp at once")
    planes = _state_planes(torch, ks, km, ps_, pm)
    worst = check_planes(
        torch, f"{what} bounce {bounce} ({ps.num_paths} lanes, {alive} "
        f"alive{note})", planes, phase=phase, exact=tuple(planes))
    if ks.rng.dtype != torch.int64 or any(
            t.dtype != torch.bool for t in (ks.alive, ks.emission_ok, km)):
        raise AssertionError(f"{what}: rng {ks.rng.dtype}, flags "
                             f"{ks.alive.dtype} {ks.emission_ok.dtype} "
                             f"{km.dtype}")
    if mode == "resident" and queued != alive:
        raise AssertionError(f"{what}: {queued} lanes queued of {alive} alive")
    if expect_take is not None and take != expect_take:
        raise AssertionError(f"{what}: the warps took {take} lanes at once, "
                             f"not {expect_take}")
    if with_bound:
        name = (cuda_bounce.BOUNCE_KERNELS_GLOBAL
                if cuda_bounce.tables_in_global(cfg, scene, lights)
                else cuda_bounce.BOUNCE_KERNELS)[mode]
        out["ms"] = kernel_device_ms(torch, lambda: cuda_bounce.fused_bounce(
            *args, **kw), name, iters)
        b = out["bound"]
        log(f"phase {phase} {name} at {what} bounce {bounce} "
            f"({ps.num_paths} lanes, {alive} alive): kernel {out['ms']:.4f} "
            f"ms (device time), plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms "
            f"({b[1]}; bytes {out['nbytes']}: " + ", ".join(
                f"{k} {v}" for k, v in parts.items())
            + f"; {ops_note(out['ops'])}) [{smi}]")
    return dict(out, max_abs_err=worst, plain_ms=plain_ms)


def bounce_at_calls(torch, phase, what, calls, smi) -> dict:
    """check_bounce with its bound and time at each recorded fused_bounce
    call; returns the kernel-line numbers, each the mean over the calls."""
    rows = [check_bounce(torch, phase, what, args, kw, with_bound=True,
                         smi=smi) for args, kw in calls]
    k = len(rows)
    b = bound(sum(r["nbytes"] for r in rows) / k,
              sum(r["ops"] for r in rows) / k)
    out = dict(max_abs_err=max(r["max_abs_err"] for r in rows),
               ms=sum(r["ms"] for r in rows) / k,
               plain_ms=sum(r["plain_ms"] for r in rows) / k, bound=b,
               library_ms=None)
    log(f"phase {phase} {what} over its {k} calls: kernel {out['ms']:.4f} ms "
        f"per launch (device time), plain {out['plain_ms']:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]}), means over the calls [{smi}]")
    return out


def check_bounce_edges(torch, np, phase, what, cfg, scene, lights, ps):
    """check_bounce on each of FRAME_EDGES from the primary state `ps`, at
    the edge's start bounce (is_last there)."""
    grid = bounce_grid(torch, cfg, scene, lights, ps)
    for case in FRAME_EDGES:
        eps, start = frame_edge(torch, np, case, ps, grid)
        check_bounce(torch, phase, f"{what} {case}",
                     (cfg, scene, lights, eps, start,
                      start == cfg.max_depth - 1),
                     expect_take=edge_take(case))


# Lanes the small fused_bounce (a grid-stride loop over a persistent grid,
# csrc/fused_bounce.cu small_bounce_kernel) has to get right beside the
# compact path's bounce-0 call, each from the primary state: every lane
# dead; a third of the lanes dead at random; the lanes less 77, a count that
# is no multiple of a warp or a block; one lane; 33 lanes (a warp and one);
# and bounce 3 as the last bounce (Russian roulette on).  The main path's
# call, at 1920x1080, takes several rounds of the grid.
SMALL_BOUNCE_EDGES = ("all_dead", "scattered", "ragged", "one", "n33",
                      "is_last")

# The small fused_bounce before its persistent grid (one thread a lane,
# 16 200 blocks of 128 at 1920x1080), as frame_sweep.py --part bounce
# --other read it on an H100 at the small scenes' tables.
SMALL_BOUNCE_PARENT = ("one thread a lane: 90 registers, 32 B local, "
                       "5 blocks/SM of 128 threads")


def small_bounce_edge(torch, np, case, ps):
    """(PathState, bounce, is_last) of one of SMALL_BOUNCE_EDGES from the
    primary state `ps`."""
    n = ps.num_paths
    if case == "all_dead":
        return ps._replace(alive=torch.zeros_like(ps.alive)), 0, False
    if case == "scattered":
        keep = np.random.default_rng(23).random(n) >= 1 / 3
        return ps._replace(alive=ps.alive & torch.from_numpy(keep).to(
            ps.alive.device)), 0, False
    if case == "is_last":
        return ps, 3, True
    m = {"ragged": n - 77, "one": 1, "n33": 33}.get(case)
    if m is None:
        raise ValueError(f"unknown small fused_bounce case {case!r}")
    return first_lanes(ps, m), 0, False


def grid_rounds(torch, n) -> float:
    """The fewest rounds a persistent grid takes over `n` lanes: n over the
    most threads the SMs hold at once, 2048 an SM whatever the kernel's
    launch shape."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n / (sms * 2048)


def check_small_bounce_edges(torch, np, phase, what, cfg, scene, lights, ps):
    """check_bounce on each of SMALL_BOUNCE_EDGES from the primary state
    `ps` (the small form: every plane bit for bit)."""
    for case in SMALL_BOUNCE_EDGES:
        eps, bounce, is_last = small_bounce_edge(torch, np, case, ps)
        check_bounce(torch, phase, f"{what} {case}",
                     (cfg, scene, lights, eps, bounce, is_last))


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

    out["fused_bounce"] = bounce_at_calls(
        torch, 5, "the sorted frame's fused_bounce", by_name["fused_bounce"],
        smi)

    mine = by_name["fused_frame"]
    if len(mine) != 1:
        raise AssertionError(f"the sorted frame called fused_frame "
                             f"{len(mine)} times")
    (args, kw), = mine
    worst_f, b, _ = check_frame(torch, 5, "fused_frame resident", args, kw,
                                with_bound=True)
    ms, plain_ms = _over_calls(torch, cuda_bounce.fused_frame, mine,
                               "fused_frame_kernel<1>",
                               cuda_bounce.fused_frame_reference, plain_iters=3)
    out["fused_frame_resident"] = dict(max_abs_err=worst_f, ms=ms,
                                       plain_ms=plain_ms, bound=b,
                                       library_ms=None)
    log(f"phase 5 fused_frame resident at the sorted frame's call: kernel "
        f"{ms:.4f} ms (device time), plain {plain_ms:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]}) [{smi}]")

    # the resident fused_frame over every bounce of all lanes: the route of
    # ray_sort=False and of lane counts the sort cannot take
    check_frame(torch, 5, "fused_frame resident", (cfg, scene, lights, ps0),
                {})
    ms0 = kernel_device_ms(torch, lambda: cuda_bounce.fused_frame(
        cfg, scene, lights, ps0), "fused_frame_kernel<1>")
    log(f"phase 5 fused_frame resident from bounce 0 at {MW}x{MH} "
        f"d{cfg.max_depth}: kernel {ms0:.4f} ms (device time) [{smi}]")
    check_frame_edges(torch, np, 5, "fused_frame resident", cfg, scene,
                      lights, ps0)
    check_bounce_edges(torch, np, 5, "fused_bounce resident", cfg, scene,
                       lights, ps0)

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
    from spt_tpu_torch.ops import cuda_bounce

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
    names = {"fused_bounce": cuda_bounce.BOUNCE_KERNELS["resident"],
             "fused_frame": "fused_frame_kernel<1>",
             "sort_chunks": "sort_chunks_kernel"}
    iters = 8
    reset_counts()
    with eager_frames():
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


def _inst_trace_ops(torch, scene, o, d, tmin, tmax, t_end, blocked=None,
                    opened=None):
    """The operations the instanced tracer needs on these rays, counted from
    the plain version's result: every lane with a non-empty interval
    slab-tests every instance box (~24 flops) and every sphere (~20); for
    each instance it crosses within min(tmax, its final t) it slab-tests the
    mesh's real cluster boxes in object space (~24 flops each) and runs the
    64 Moller-Trumbore tests (~40 flops each) of every cluster box that
    final bound still reaches.  A blocked any-hit lane counts one test.
    With `opened` (see ``_walk_ops``), marks the BLAS clusters those tests
    open."""
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
        n_open = 0
        for c0 in range(0, real.numel(), 16):
            cl = real[c0:c0 + 16]
            cn, cf = ct._slab(ia.blas_lo[mesh, cl], ia.blas_hi[mesh, cl], oo,
                              iinv, tmin, bound[lanes])
            hit = cn <= cf
            n_open += int(hit.sum())
            _mark(torch, opened, "clusters", ia.num_meshes * ia.cmax,
                  mesh * ia.cmax + cl[hit.any(1)])
        ops += lanes.numel() * real.numel() * 24.0 + n_open * k * 40.0
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
    out["sort_chunks"] = sort_at_calls(torch, 10, "the instanced sorted "
                                       "frame's", by_name["sort_chunks"], smi)

    out["fused_bounce_instanced"] = bounce_at_calls(
        torch, 10, "the instanced sorted frame's fused_bounce",
        by_name["fused_bounce"], smi)

    mine = by_name["fused_frame"]
    if len(mine) != 1:
        raise AssertionError(f"the instanced sorted frame called fused_frame "
                             f"{len(mine)} times")
    (args, kw), = mine
    worst, b, _ = check_frame(torch, 10, "fused_frame instanced", args, kw,
                              with_bound=True)
    ms, plain_ms = _over_calls(torch, cuda_bounce.fused_frame, mine,
                               "fused_frame_kernel<2>",
                               cuda_bounce.fused_frame_reference,
                               plain_iters=1)
    out["fused_frame_instanced"] = dict(max_abs_err=worst, ms=ms,
                                        plain_ms=plain_ms, bound=b,
                                        library_ms=None)
    log(f"phase 10 fused_frame instanced at the sorted frame's call: kernel "
        f"{ms:.4f} ms (device time), plain {plain_ms:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]}) [{smi}]")
    log_occupancy(10, smi, {
        "closest_hit_inst": _trace_shared_bytes("inst_closest_hit", ia, scene),
        "any_hit_inst": _trace_shared_bytes("inst_any_hit", ia, scene),
        "fused_bounce_instanced": cuda_bounce.shared_bytes(*args[:3]),
        "fused_frame_instanced": cuda_bounce.shared_bytes(*args[:3])})
    # the sampler's share of that launch: the same call without the table
    bare = (args[0], args[1]._replace(textures=None)) + tuple(args[2:])
    check_frame(torch, 10, "fused_frame instanced on the same call without "
                "the texture table", bare, kw)
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
    check_frame(torch, 10, "fused_frame instanced", (cfg, scene, lights, ps0),
                {})
    ms0 = kernel_device_ms(torch, lambda: cuda_bounce.fused_frame(
        cfg, scene, lights, ps0), "fused_frame_kernel<2>")
    log(f"phase 10 fused_frame instanced from bounce 0 at {MW}x{MH} "
        f"d{cfg.max_depth}: kernel {ms0:.4f} ms (device time) [{smi}]")
    check_frame_edges(torch, np, 10, "fused_frame instanced", cfg, scene,
                      lights, ps0)

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
    check_frame(torch, 10, "fused_frame resident textured",
                (mcfg, mscene, lights, mps), {})
    check_bounce(torch, 10, "fused_bounce resident textured",
                 (mcfg, mscene, lights, mps, 0, False))
    return out


def phase_inst_main_path(torch, np, dev, out_dir, smi):
    """Phase 11: the instanced grid's Renderer on the card; returns the
    launch counts."""
    from spt_tpu_torch.bench import count_rays, shadow_rays_per_surface_lane
    from spt_tpu_torch.ops import cuda_bounce
    from spt_tpu_torch.integrators import wavefront

    frames = 8
    r = inst_renderer(dev)
    _check_inst_scene(r.scene)
    n_shadow = shadow_rays_per_surface_lane(r)
    torch.cuda.synchronize()
    reset_counts()
    r.render_frames(frames)
    torch.cuda.synchronize()
    counts = read_counts()
    branches = dict(wavefront.SORTED_SAMPLES)
    # the run above captured the frame; time a chain of its replays
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    r.render_frames(frames)
    t1.record()
    torch.cuda.synchronize()
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
    names = {"fused_bounce": cuda_bounce.BOUNCE_KERNELS["instanced"],
             "fused_frame": "fused_frame_kernel<2>",
             "sort_chunks": "sort_chunks_kernel"}
    with eager_frames():
        prof = profile_kernels(torch, lambda: r.render_frames(1),
                               list(names.values()), iters=4)
    log("phase 11 instanced grid, device ms per launch (profiled, eager "
        "frames): "
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


def _stream_trace_ops(torch, scene, o, d, tmin, tmax, t_end, blocked=None,
                      opened=None):
    """The operations the stream tracer needs on these rays, counted from
    the plain version's result: every lane with a non-empty interval
    slab-tests every real supercluster box (~24 flops) and every sphere
    (~20); for each super its final bound min(tmax, t_end) still reaches it
    slab-tests that super's real cluster boxes (~24 flops each), and for
    each cluster box that bound reaches it runs the 64 Moller-Trumbore
    tests (~40 flops each).  A blocked any-hit lane counts one test.  With
    `opened` (see ``_walk_ops``), marks the supers and the clusters those
    tests open."""
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
    sup_ids = torch.nonzero(real_s).flatten()
    fan = torch.arange(16, device=sup_ids.device)
    for s0 in range(0, n, 16384):
        sl = slice(s0, min(n, s0 + 16384))
        oo = Vec3(*(c[sl] for c in o))
        inv = Vec3(*(ct._inv_dir(c[sl]) for c in d))
        b = bound[sl]
        tn, tf = ct._slab(slo, shi, oo, inv, tmin, b)
        opened_s = (tn <= tf) & live[sl][None]                    # (G', L)
        ops += float((opened_s.to(torch.float32) * per_super[:, None]).sum()) * 24
        cn, cf = ct._slab(clo[real_s].reshape(-1, 3), chi[real_s].reshape(-1, 3),
                          oo, inv, tmin, b)
        hit_c = ((cn <= cf).reshape(-1, 16, cn.shape[-1])
                 & real_c[real_s][..., None] & opened_s[:, None, :])
        ops += float(hit_c.sum()) * a.cluster_size * 40
        _mark(torch, opened, "supers", real_s.shape[0], sup_ids[opened_s.any(1)])
        _mark(torch, opened, "clusters", a.num_clusters,
              (sup_ids[:, None] * 16 + fan)[hit_c.any(-1)])
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


# Lanes of phase 14's stream fused_frame from bounce 0 that its plain
# check takes (``check_frame``'s `band`).
STREAM_BAND = 8192


def phase_stream_kernels(torch, np, dev, smi):
    """Phase 14: the stream-tier kernels (K8, K1/K3 stream, textured)
    against their plain versions on the card, at the inputs recorded from
    one regen frame (stream_closest_hit / stream_any_hit) and one sorted
    frame (fused_bounce and fused_frame stream) of the baked grid, every
    returned plane per lane, where their times and bounds are taken (the
    plain time is that of the checking call).  Returns the kernel-line
    numbers."""
    from spt_tpu_torch.integrators import transport
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
    out["fused_bounce_stream"] = bounce_at_calls(
        torch, 14, "the stream sorted frame's fused_bounce",
        by_name["fused_bounce"], smi)

    mine = by_name["fused_frame"]
    if len(mine) != 1:
        raise AssertionError(f"the stream sorted frame called fused_frame "
                             f"{len(mine)} times")
    (args, kw), = mine
    worst, b, plain_ms = check_frame(torch, 14, "fused_frame stream", args,
                                     kw, with_bound=True)
    ms = kernel_device_ms(torch, lambda: cuda_bounce.fused_frame(*args, **kw),
                          "fused_frame_kernel<3>")
    out["fused_frame_stream"] = dict(max_abs_err=worst, ms=ms,
                                     plain_ms=plain_ms, bound=b,
                                     library_ms=None)
    log(f"phase 14 fused_frame stream at the sorted frame's call: kernel "
        f"{ms:.4f} ms (device time), plain {plain_ms:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]}) [{smi}]")
    log_occupancy(14, smi, {
        "closest_hit_stream": _trace_shared_bytes("stream_closest_hit", a, scene),
        "any_hit_stream": _trace_shared_bytes("stream_any_hit", a, scene),
        "fused_bounce_stream": cuda_bounce.shared_bytes(*args[:3]),
        "fused_frame_stream": cuda_bounce.shared_bytes(*args[:3])})
    # the stream fused_frame over every bounce of all lanes (ray_sort off),
    # held on a band of them (the plain walk over 104 448 triangles takes
    # ~8 s a bounce on all of them; the sorted frame's call above holds the
    # rays per bounce), timed
    cfg, lights = r.cfg, args[2]
    ps0 = transport.gen_primary(cfg, r.camera.rays(dev), 0)
    check_frame(torch, 14, "fused_frame stream", (cfg, scene, lights, ps0),
                {}, band=STREAM_BAND)
    ms0 = kernel_device_ms(torch, lambda: cuda_bounce.fused_frame(
        cfg, scene, lights, ps0), "fused_frame_kernel<3>")
    log(f"phase 14 fused_frame stream from bounce 0 at {MW}x{MH} "
        f"d{cfg.max_depth}: kernel {ms0:.4f} ms (device time) [{smi}]")
    check_frame_edges(torch, np, 14, "fused_frame stream", cfg, scene, lights,
                      ps0)
    out["sort_chunks"] = sort_at_calls(torch, 14, "the stream sorted frame's",
                                       by_name["sort_chunks"], smi)
    return out


def phase_stream_main_path(torch, np, dev, out_dir, smi):
    """Phase 15: the baked grid's Renderer on the card, sorted (the main
    path) and unsorted; returns the sorted run's launch counts."""
    from spt_tpu_torch.bench import count_rays, shadow_rays_per_surface_lane
    from spt_tpu_torch.ops import cuda_bounce
    from spt_tpu_torch.integrators import wavefront

    frames = 8
    r = stream_renderer(dev)
    _check_stream_scene(r.scene)
    n_shadow = shadow_rays_per_surface_lane(r)
    torch.cuda.synchronize()
    reset_counts()
    r.render_frames(frames)
    torch.cuda.synchronize()
    counts = read_counts()
    branches = dict(wavefront.SORTED_SAMPLES)
    # the run above captured the frame; time a chain of its replays
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    r.render_frames(frames)
    t1.record()
    torch.cuda.synchronize()
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
    names = {"fused_bounce": cuda_bounce.BOUNCE_KERNELS["stream"],
             "fused_frame": "fused_frame_kernel<3>",
             "sort_chunks": "sort_chunks_kernel"}
    with eager_frames():
        prof = profile_kernels(torch, lambda: r.render_frames(1),
                               list(names.values()), iters=4)
    log("phase 15 baked grid, device ms per launch (profiled, eager "
        "frames): "
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
    kernel path (8 frames) and, at a quarter of the width and height (the
    plain walk over 104 448 triangles takes ~8 s a bounce at 512x384),
    against the plain path (1 frame)."""
    imgs = {}
    for label, frames, kw, ctx in (
            ("sorted", 8, {}, contextlib.nullcontext),
            ("unsorted", 8, {"ray_sort": False}, contextlib.nullcontext),
            ("sorted_1", 1, {}, contextlib.nullcontext),
            ("plain", 1, {}, plain_path)):
        r = stream_renderer(dev, **kw)
        if frames == 1:
            r.resize(MW // 4, MH // 4)
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


def _compact_bounce0(torch, np, smi, name, r):
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
    k3 = check_bounce(torch, 20, f"the compact {name} frame's fused_bounce",
                      args, kw, with_bound=True, smi=smi)
    if cuda_bounce._accel_mode(args[1]) is None:
        from spt_tpu_torch.ops import cuda_lib

        cfg, scene, lights, ps = args[:4]
        smem = cuda_bounce.shared_bytes(cfg, scene, lights)
        info = cuda_lib.kernel_info({"fused_bounce": smem})["fused_bounce"]
        log(f"phase 20 {cuda_bounce.BOUNCE_KERNELS[None]} at the compact "
            f"{name} frame's tables: {info['registers']} registers, "
            f"{info['local_bytes']} B local, {info['blocks_per_sm']} blocks/SM "
            f"at {smem} B shared a block; {ps.num_paths} lanes, at least "
            f"{grid_rounds(torch, ps.num_paths):.2f} rounds of the grid "
            f"(before: {SMALL_BOUNCE_PARENT}) [{smi}]")
        if name == "default":
            check_small_bounce_edges(torch, np, 20, f"the compact {name} "
                                     "frame's fused_bounce", cfg, scene,
                                     lights, ps)
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
    return dict(max_abs_err=k3["max_abs_err"], ms=k3["ms"],
                plain_ms=k3["plain_ms"], bound=k3["bound"],
                library_ms=None), len(envs)


def phase_compact(torch, np, dev, out_dir, smi):
    """Phase 20: integrator "compact" (bounce 0 through K3 at full width,
    then compacted chunks through trace_bounce + shade with the environment
    each bounce) on default d6, cornell d8 and hdr d6 at 1920x1080 and on
    the mesh scene at 512x384 d4: K3 at the bounce-0 call against its plain
    version (every plane bit for bit), K2 at the hdr frame's calls,
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
        k3, env_calls = _compact_bounce0(torch, np, smi, name, r)
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
    diff, ok = grads_agree(torch, gk, gc)
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


# --- pixel-band sharding (phase 24) --------------------------------------------

def sharded_rank(rank, world, frames):
    """One rank of phase 24's NCCL world: Renderer(multi_device=True) on
    default 1920x1080 d6 on card `rank`, render_frames(frames) with the
    launch counts reset before and read after (the gated run), then a
    frame and a second chain timed with CUDA events (frame_ms), and the
    step's two all_reduces timed alone on tensors of their shapes."""
    import torch
    import torch.distributed as dist

    from spt_tpu_torch.engine.renderer import Renderer

    dev = torch.device("cuda", rank)
    t0 = time.perf_counter()
    dist.all_reduce(torch.zeros(1, device=dev))
    torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    desc, cfg, env, lights, cam = workload("default", W, H, dev)
    t0 = time.perf_counter()
    r = Renderer(desc, cfg, env=env, lights=lights, camera=cam,
                 multi_device=True)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    reset_counts()
    r.render_frames(frames)
    torch.cuda.synchronize(dev)
    counts = read_counts()
    img = r.image()
    out = dict(world=r.mesh.size(), device=str(r.device),
               rays=r.last_stats.rays_per_bounce.cpu().numpy(),
               bounces=int(r.last_stats.bounces_run), counts=counts,
               first_s=first_s, setup_s=setup_s,
               band_edges=r.band_edges, band_work_share=r.band_work_share,
               band_device_ms=r.band_device_ms,
               image=img if rank == 0 else None)
    out["ms"] = frame_ms(torch, r, frames)
    # the eager sharded step (the band's frame_chain, then the two
    # all_reduces) against the captured one, in turns
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.parallel import sharding

    cam_rays = r.camera.rays(dev)
    st = [state_mod.RenderState(*(t.clone() for t in r.state))]

    def eager():
        st[0], stats = sharding.shard_frames(r.cfg, r.scene, r.env,
                                             r.lights, cam_rays, st[0],
                                             frames, rank, world)
        dist.all_reduce(stats.rays_per_bounce, op=dist.ReduceOp.SUM)
        dist.all_reduce(stats.bounces_run.reshape(1), op=dist.ReduceOp.MAX)

    out["pairs"] = timed_pairs(torch, {"eager": eager, "captured": lambda:
                                       r.render_frames(frames)},
                               CAPTURE_PAIRS, frames)
    rays = torch.zeros(cfg.max_depth, dtype=torch.int64, device=dev)
    bounces = torch.zeros(1, dtype=torch.int64, device=dev)
    out["collectives_ms"] = time_call(torch, lambda: (
        dist.all_reduce(rays, op=dist.ReduceOp.SUM),
        dist.all_reduce(bounces, op=dist.ReduceOp.MAX)), warmup=3, iters=20)
    return out


def band_layouts(torch, name, cfg, args, dev):
    """[(world, (layout, cfg of the layout))]: for worlds of 2 and 4 the
    equal bands, then those the sharded Renderer's probe cuts where they
    differ, the probe run whole in this process: "counted", by the rays
    (``sharding.strip_work`` on every strip at frame index 0,
    ``balanced_edges``), and "timed", that cut refined by each band's
    device time (``refine_edges`` with ``band_device_ns`` band after
    band).  It logs each cut's edges, its bands' shares of the rays and
    their timed ms, and the probe's seconds."""
    import types

    from spt_tpu_torch.bench import shadow_rays_per_surface_lane
    from spt_tpu_torch.parallel import sharding

    scene, env, lights, rays = args
    n_shadow = shadow_rays_per_surface_lane(types.SimpleNamespace(
        cfg=cfg, scene=scene, lights=lights))
    frame_index = torch.zeros((), dtype=torch.int32, device=dev)
    out = []
    for world in (2, 4):
        equal = tuple(r * cfg.height // world for r in range(world + 1))
        out.append((world, ("equal", cfg)))
        g = sharding.strip_rows(cfg, world)
        strips = cfg.height // g
        keeps = sharding.band_keeps_route(cfg, scene, lights, world)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = sharding.strip_work(cfg, scene, env, lights, rays,
                                     frame_index, range(strips), g,
                                     n_shadow).tolist()
        counted = sharding.balanced_edges(counts, world, g, keeps)
        probe_s = time.perf_counter() - t0
        rounds = []

        def measure(edges):
            times = [sharding.band_device_ns(cfg, scene, env, lights, rays,
                                             frame_index, a, b - a)
                     for a, b in zip(edges, edges[1:])]
            rounds.append((edges, times))
            return times

        t0 = time.perf_counter()
        timed, _ = sharding.refine_edges(counts, counted, world, g, keeps,
                                         measure)
        refine_s = time.perf_counter() - t0
        log(f"phase 24 {name} {cfg.width}x{cfg.height}, world {world}: "
            f"probe of {strips} strips of {g} rows in {probe_s:.3f} s (one "
            f"process; a rank of the sharded Renderer probes 1/{world} of "
            f"them), the refinement's {len(rounds)} timed cuts in "
            f"{refine_s:.3f} s (one process, band after band); the equal "
            f"bands' shares of the rays "
            f"{[round(x, 4) for x in sharding.band_shares(counts, equal, g)]}")
        for edges, times in [(equal, None)] + rounds:
            share = sharding.band_shares(counts, edges, g)
            ms = times or [sharding.band_device_ns(
                cfg, scene, env, lights, rays, frame_index, a, b - a)
                for a, b in zip(edges, edges[1:])]
            kind = ("equal" if times is None else "counted"
                    if edges == counted else "refined")
            log(f"phase 24 {name} world {world} cut {kind}: band_edges "
                f"{edges}, band_work_share {[round(x, 4) for x in share]}, "
                f"band ms {[round(t / 1e6, 4) for t in ms]} (slowest over "
                f"mean {max(ms) * world / sum(ms) - 1:.2%})"
                + (" <- kept" if edges == timed and times else ""))
        for layout, edges in (("counted", counted), ("timed", timed)):
            if edges != equal and (layout == "counted" or edges != counted):
                out.append((world, (layout, cfg.replace(band_edges=edges))))
    return out


def band_replay_ms(torch, cfg, args, dev, row0, rows, replays: int = 32):
    """ms a replay of the band's captured step (``_captured_step_dyn``):
    CUDA events around `replays` replays after the capture."""
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.engine.renderer import _captured_step_dyn

    scene, env, lights, rays = args
    step = _captured_step_dyn(cfg, scene, env, lights, dev, row0, rows)
    st = state_mod.init_state(rows * cfg.width, dev)
    st, _ = step(rays, st, 2)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    step(rays, st, replays)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / replays


def phase_sharding(torch, np, dev, smi):
    """Phase 24 (a), pixel-band sharding.  (a) Every band of worlds of 2 and 4,
    one after another in this process on the card, through the per-shard
    body (``parallel.sharding.shard_frames``, 2 frames) on default and hdr
    1920x1080 d6 and the mesh scene 512x384 d4 (sorted frame), in the equal
    bands and in the cuts of the sharded Renderer's probe (``band_layouts``:
    the cut by the rays and the cut refined by the bands' timed frames,
    their edges, shares of the rays, band ms and the probe's seconds
    logged): the bands put together held to the unsharded frame's
    accumulation bit for bit, the rays per bounce summed exactly; per band
    the port's kernel launches a band-frame (counts reset before, read
    after), the device busy time and kernel launches a band-frame and K1's
    device ms per band launch (profiler); on default, each band's captured
    step timed (CUDA events over 32 replays) and the bands' spread, slowest
    over mean.  (b) A real process group: ``device_count()`` ranks (at most
    4), NCCL, one card each, ``Renderer(multi_device=True)``
    .render_frames(8) on default 1080p d6 against a single-device Renderer
    here: image bit for bit, last_stats equal, each rank's band edges, ray
    shares and timed band ms logged; both chains timed with CUDA events,
    the group's set-up and the step's all_reduces timed."""
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.env import make_procedural_environment
    from spt_tpu_torch.integrators import wavefront
    from spt_tpu_torch.lights import default_lights
    from spt_tpu_torch.ops import cuda_bounce
    from spt_tpu_torch.parallel import sharding
    from spt_tpu_torch.scene import flatten_scene

    frames = 2
    configs = []
    for name in ("default", "hdr"):
        desc, cfg, env, lights, cam = workload(name, W, H, dev)
        env = env if env is not None else make_procedural_environment(dev)
        configs.append((name, cfg, (flatten_scene(desc, dev), env, lights,
                                    cam.rays(dev)), cuda_bounce.SMALL_KERNEL))
    mdesc, mcfg, mcam = port_mesh_scene()
    configs.append(("mesh", mcfg, (flatten_scene(mdesc, dev),
                                   make_procedural_environment(dev),
                                   default_lights(dev), mcam.rays(dev)),
                    "fused_frame_kernel<1>"))
    failed = []
    for name, cfg, args, k1_name in configs:
        size = f"{cfg.width}x{cfg.height} d{cfg.max_depth}"
        full, fstats = sharding.shard_frames(
            cfg, *args, state_mod.init_state(cfg.num_pixels, dev), frames, 0,
            1)
        for world, (layout, bcfg) in band_layouts(torch, name, cfg, args,
                                                  dev):
            bands, rays, replay_ms = [], 0, []
            for rank in range(world):
                row0, rows = sharding.band(bcfg, rank, world)
                st0 = state_mod.init_state(rows * cfg.width, dev)
                torch.cuda.synchronize()
                reset_counts()
                st, stats = sharding.shard_frames(bcfg, *args, st0, frames,
                                                  rank, world)
                torch.cuda.synchronize()
                counts = {k: v for k, v in read_counts().items() if v}
                branches = dict(wavefront.SORTED_SAMPLES)
                bands.append(st.accum)
                rays = rays + stats.rays_per_bounce
                band_frame = lambda: sharding.shard_frames(
                    bcfg, *args, st0, 1, rank, world)
                busy, per = device_busy_ms(torch, band_frame, iters=2)
                k1_ms = kernel_device_ms(torch, band_frame, k1_name, iters=4)
                if name == "mesh":
                    # K3 at each of a band-frame's calls, bit for bit
                    with capture_calls([(cuda_bounce, "fused_bounce")]) as k3s:
                        band_frame()
                        torch.cuda.synchronize()
                    for _, a_, k_ in k3s:
                        check_bounce(torch, 24, f"fused_bounce in mesh band "
                                     f"{rank} of {world}", a_, k_)
                if name == "default":
                    replay_ms.append(band_replay_ms(torch, bcfg, args, dev,
                                                    row0, rows))
                log(f"phase 24 {name} {size}, {layout} band {rank} of {world} "
                    f"(rows {row0}-{row0 + rows - 1}, {st0.num_pixels} "
                    f"lanes): launches {counts} in {frames} band-frames"
                    + (f", sorted-frame branches {branches}" if branches
                       else "")
                    + f"; {k1_name} {k1_ms:.4f} ms per launch; busy "
                    f"{busy:.4f} ms over {per:.1f} kernel launches a "
                    f"band-frame (profiler)"
                    + (f"; captured band step {replay_ms[-1]:.4f} ms a "
                       f"replay" if replay_ms else "") + f" [{smi}]")
                want = ({"fused_frame": frames, "fused_bounce": 3 * frames}
                        if name == "mesh" else {"fused_frame": frames})
                if name == "hdr":
                    want["env_sample"] = frames
                if any(counts.get(k) != v for k, v in want.items()) or (
                        name == "mesh" and counts.get("sort_chunks", 0)
                        < 3 * frames):
                    failed.append(f"{name} band {rank} of {world} launched "
                                  f"{counts}, expected at least {want}")
            got = torch.cat(bands)
            off = float(lanes_off(torch, got, full.accum).float().mean())
            share, ulps = ulps_apart(torch, got, full.accum)
            same_rays = torch.equal(rays, fstats.rays_per_bounce)
            if replay_ms:
                log(f"phase 24 {name} {size}, {layout} bands of {world}: "
                    f"captured band steps {[round(x, 4) for x in replay_ms]} "
                    f"ms a replay, slowest over mean "
                    f"{max(replay_ms) * world / sum(replay_ms) - 1:.2%}")
            log(f"phase 24 {name} {size}, {world} {layout} bands put together "
                f"against the unsharded frame ({frames} frames): lanes not "
                f"bit-equal "
                f"{share:.6%}, largest distance {ulps} ulp, lanes off by more "
                f"than 1e-3 {off:.6%}; rays per bounce summed "
                f"{rays.tolist()} unsharded {fstats.rays_per_bounce.tolist()} "
                f"(equal: {same_rays})")
            if share or not same_rays:
                failed.append(f"{name} over {world} {layout} bands: "
                              f"{share:.6%} of "
                              f"lanes differ ({ulps} ulp), rays equal "
                              f"{same_rays}")
    if failed:
        raise AssertionError("\n".join(failed))


def phase_sharded_world(torch, np, dev, smi):
    """Phase 24 (b): see phase_sharding."""
    from spt_tpu_torch.engine.renderer import Renderer
    from spt_tpu_torch.parallel import launch

    failed = []
    n = min(torch.cuda.device_count(), 4)
    frames = 8
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = launch.spawn(sharded_rank, n, (frames,), backend="nccl",
                       timeout=300)
    spawn_s = time.perf_counter() - t0
    desc, cfg, env, lights, cam = workload("default", W, H, dev)
    r = Renderer(desc, cfg, env=env, lights=lights, camera=cam, device=dev,
                 multi_device=False)
    r.render_frames(frames)
    img = r.image()
    rays = r.last_stats.rays_per_bounce.cpu().numpy()
    bounces = int(r.last_stats.bounces_run)
    ms = frame_ms(torch, r, frames)
    rank0 = res[0].value
    share, ulps = ulps_apart(torch, torch.from_numpy(rank0["image"]).reshape(
        -1, 3), torch.from_numpy(img).reshape(-1, 3))
    same_stats = (all((v.value["rays"] == rays).all()
                      and v.value["bounces"] == bounces for v in res))
    for i, v in enumerate(res):
        o = v.value
        log(f"phase 24 NCCL rank {i} of {o['world']} on {o['device']}: "
            f"init_process_group {v.init_seconds:.3f} s, first all_reduce "
            f"{o['first_s']:.3f} s, Renderer(multi_device=True) "
            f"{o['setup_s']:.3f} s, band_edges {o['band_edges']}, "
            f"band_work_share {o['band_work_share']}, band_device_ms "
            f"{o['band_device_ms']}; render_frames({frames}) launches "
            f"{ {k: c for k, c in o['counts'].items() if c} }, "
            f"{o['ms']:.4f} ms/frame (CUDA events over a chain after a warm-up "
            f"frame); {CAPTURE_PAIRS} pairs of {frames}-frame calls in turns, "
            f"ms/frame median (range): eager {_med(o['pairs']['eager'])}, "
            f"captured {_med(o['pairs']['captured'])}; the "
            f"step's two all_reduces {o['collectives_ms']:.4f} ms a "
            f"render_frames call (CUDA events, 20 pairs) [{smi}]")
        if o["counts"]["whole_frame"] != frames:
            failed.append(f"rank {i} took {o['counts']['whole_frame']} "
                          f"frames whole in {frames} frames")
    log(f"phase 24 NCCL world of {n} rank(s) ({spawn_s:.1f} s to spawn, run "
        f"and join); single-device Renderer here: {ms:.4f} ms/frame (CUDA "
        f"events over a chain after a warm-up frame); image against it: lanes not "
        f"bit-equal {share:.6%}, largest distance {ulps} ulp; last_stats "
        f"equal on every rank: {same_stats} (rays {rays.tolist()}, bounces "
        f"{bounces}) [{smi}]")
    if share or not same_stats:
        failed.append(f"the NCCL world's image differs from the single-device "
                      f"Renderer's on {share:.6%} of lanes, or its stats "
                      f"({same_stats})")
    if failed:
        raise AssertionError("\n".join(failed))


# --- the captured step (phase 25) --------------------------------------------

# Frames a call in phase 25's check (the first call captures, the second
# replays), its timed calls and its pairs of timed calls.
CAPTURE_CHECK = (1, 8)
CAPTURE_FRAMES = 8
CAPTURE_PAIRS = 5


def graph_pool_bytes(torch, graph) -> int:
    """Bytes of the segments of the private memory pool of `graph`, a
    captured step's SegmentedGraph (the caching allocator's snapshot)."""
    pool = tuple(graph.pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def same_run(torch, got, want) -> list:
    """The planes of two (RenderState, WavefrontStats) that are not bit for
    bit equal."""
    (gs, gstats), (ws, wstats) = got, want
    pairs = dict(zip(("accum", "sample_count", "frame_index"), zip(gs, ws)))
    pairs["rays_per_bounce"] = (gstats.rays_per_bounce,
                                wstats.rays_per_bounce)
    pairs["bounces_run"] = (gstats.bounces_run, wstats.bounces_run)
    return [k for k, (a, b) in pairs.items()
            if a.shape != b.shape or not _same_bits(torch, a, b)]


def captured_counts(r, eager: dict, frames: int) -> dict:
    """The launch counts (``counts_of``) a captured run of `frames` frames
    of `r` should add, given what the eager ``frame_chain`` run of the same
    frames added: the same, except where the step takes its frames whole
    (``StaticStep.whole``): then one launch a frame of the whole-frame
    kernel in its tables' placement and nothing else, where the chain
    launched fused_frame and the PyTorch code around it."""
    from spt_tpu_torch.ops import cuda_bounce

    if r.captured_step().step.whole:
        return {(cuda_bounce.__name__, "WHOLE_GLOBAL_LAUNCHES"
                 if cuda_bounce.tables_in_global(r.cfg, r.scene, r.lights)
                 else "WHOLE_LAUNCHES"): frames}
    return eager


def counts_of(torch, fn) -> dict:
    """The launch counts `fn` adds, the sorted frame's branches and the
    loop bodies' runs among them (wavefront.launch_counts after a sync,
    which reads the device tallies of a captured graph's replays)."""
    from spt_tpu_torch.integrators import wavefront

    torch.cuda.synchronize()
    before = wavefront.launch_counts()
    fn()
    torch.cuda.synchronize()
    after = wavefront.launch_counts()
    return {(getattr(m, "__name__", m), a): v - before.get((m, a), 0)
            for (m, a), v in after.items() if v != before.get((m, a), 0)}


def cond_kinds(items) -> list:
    """A captured graph's conditionals in slot order: "if", "if not" (a
    _cond's two IF nodes) and "while"."""
    from spt_tpu_torch.ops import cuda_graph

    kinds = {}

    def walk(items):
        for it in items:
            if isinstance(it, cuda_graph.Segment):
                continue
            kinds[it.slot] = ("while" if isinstance(it, cuda_graph.Loop)
                              else "if not" if it.negate else "if")
            walk(it.body)

    walk(items)
    return [kinds[s] for s in sorted(kinds)]


def device_tallies(graph) -> str:
    """The device tally of each conditional body of a captured step's
    graph: the runs since its capture, by kind."""
    if graph._tally is None:
        return "none"
    runs = graph._tally.taken.tolist()
    kinds = cond_kinds(graph.items)
    return ", ".join(f"{k} {n}" for k, n in zip(kinds, runs))


def timed_pairs(torch, fns: dict, pairs: int, frames: int) -> dict:
    """{label: [ms/frame, ...]}: each of the two calls of `fns` timed with
    CUDA events around it (one sync after), in turns, the order flipping
    each pair (a b, b a, ...)."""
    labels = list(fns)
    out = {k: [] for k in labels}
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for i in range(pairs):
        for label in (labels if i % 2 == 0 else labels[::-1]):
            torch.cuda.synchronize()
            t0.record()
            fns[label]()
            t1.record()
            torch.cuda.synchronize()
            out[label].append(t0.elapsed_time(t1) / frames)
    return out


def _med(xs) -> str:
    xs = sorted(xs)
    return f"{xs[len(xs) // 2]:.4f} ({xs[0]:.4f}-{xs[-1]:.4f})"


def replay_sync_free(torch, step, rays, rstate, k: int):
    """`k` replays of a captured step under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    operation that waits for the device; returns what the step returns."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return step(rays, rstate, k)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _captured_config(torch, name, r, smi, failed, branches_seen,
                     pairs=CAPTURE_PAIRS, frames=CAPTURE_FRAMES,
                     check=CAPTURE_CHECK):
    """Phase 25 on one Renderer `r`: the captured step against frame_chain
    bit for bit, and every launch count of the two runs equal (the sorted
    frame's branches and the loop bodies' runs among them, tallied on the
    device in the captured run); one graph launch a replayed frame; the
    pool; two more replays under sync-debug "error", bit for bit with
    frame_chain too; then eager against captured in turns (wall ms/frame)
    and one profile each (busy, idle share, kernel launches)."""
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.engine.renderer import frame_chain
    from spt_tpu_torch.ops import cuda_graph

    args = (r.cfg, r.scene, r.env, r.lights, r.camera.rays(r.device))
    wants, launches, bad = [], [], []

    def chain():
        st = r.state
        for k in check:
            st, stats = frame_chain(*args, st, k)
            wants.append((st, stats))

    def captured():
        for k, want in zip(check, wants):
            r.render_frames(k)
            launches.append(r.captured_step().graph.launches)
            bad.extend(f"{p} after k={k}" for p in same_run(
                torch, (r.state, r.last_stats), want))

    eager = counts_of(torch, chain)
    got = counts_of(torch, captured)
    step = r.captured_step()
    graph = step.graph
    branches_seen.update(k[1] for k in got if k[0] is None)
    per_frame = (launches[-1] - launches[0]) / check[-1]
    n_if = sum(isinstance(it, cuda_graph.Branch) for it in graph.items)
    want = frame_chain(*args, state_mod.RenderState(
        *(t.clone() for t in r.state)), 2)
    try:
        st_stats = replay_sync_free(torch, step, r.camera.rays(r.device),
                                    r.state, 2)
        bad += [f"{p} after 2 replays under sync-debug" for p in same_run(
            torch, st_stats, want)]
    except RuntimeError as e:
        failed.append(f"{name}: a replay waited for the device: {e}")
    pool = graph_pool_bytes(torch, graph)
    if bad:
        failed.append(f"{name}: captured against frame_chain differs in {bad}")
    if got != captured_counts(r, eager, sum(check)):
        failed.append(f"{name}: launch counts eager {eager}, captured {got}")
    sorted_frames = sum(v for k, v in eager.items() if k[0] is None)
    if (launches[0] != 0 or per_frame != 1
            or n_if != (2 * r.cfg.spp if sorted_frames else 0)):
        failed.append(f"{name}: graph launches {launches} over the calls "
                      f"{check}, {n_if} IF nodes")
    state = [state_mod.RenderState(*(t.clone() for t in r.state))]

    def eager_chain():
        state[0], _ = frame_chain(*args, state[0], frames)

    ms = timed_pairs(torch, {"eager": eager_chain,
                             "captured": lambda: r.render_frames(frames)},
                     pairs, frames)
    busy = {"eager": device_busy_ms(torch, lambda: frame_chain(
                *args, state[0], 1), iters=4 if pairs > 3 else 1),
            "captured": device_busy_ms(torch, lambda: r.render_frames(1),
                                       iters=4 if pairs > 3 else 1)}
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    # the profiler's trace of a replay misses kernels of a conditional body,
    # so a graph with one has no captured busy, nor idle share
    captured_idle = (
        f"{(1 - busy['captured'][0] / med['captured']) * 100:.1f} %"
        if not cond_kinds(graph.items) else
        "not measured (the trace misses kernels of conditional bodies)")
    tallies = {f"{k[0] or 'branch'} {k[1]}": v for k, v in got.items()
               if k[0] in (None, "loop")}
    log(f"phase 25 {name} {r.cfg.width}x{r.cfg.height} d{r.cfg.max_depth}: "
        f"captured step against frame_chain after k={check} and 2 "
        f"replays under sync-debug \"error\": "
        f"{'bit for bit' if not bad else bad}; launch counts over "
        f"{sum(check)} frames "
        f"{'as expected' if got == captured_counts(r, eager, sum(check)) else 'unexpected'}"
        f": {got} (eager {eager}); branch and loop tallies {tallies}; device tallies since "
        f"the capture ({launches[-1] + 2} replays): {device_tallies(graph)}; "
        f"graph launches {per_frame:.0f} a frame ({n_if} IF nodes, "
        f"{cond_kinds(graph.items).count('while')} WHILE nodes); pool "
        f"{pool} B; wall ms/frame over {pairs} pairs of "
        f"{frames}-frame calls, median (range): eager "
        f"{_med(ms['eager'])}, captured {_med(ms['captured'])}; device busy "
        f"ms/frame (profiler) eager {busy['eager'][0]:.4f} over "
        f"{busy['eager'][1]:.1f} launches, idle share "
        f"{(1 - busy['eager'][0] / med['eager']) * 100:.1f} %; captured "
        f"{busy['captured'][0]:.4f} over {busy['captured'][1]:.1f}, idle "
        f"share {captured_idle}; 1 - eager busy / captured wall "
        f"{(1 - busy['eager'][0] / med['captured']) * 100:.1f} % (not an "
        f"idle share: negative where the eager profile's busy exceeds the "
        f"captured wall) [{smi}]")
    return dict(name=name, ms=med, busy={k: v[0] for k, v in busy.items()},
                pool=pool)


def _captured_anim(torch, r, smi, failed):
    """Phase 25 on the bench's anim config: each frame moves the camera 2
    degrees (bench.py's orbit) and resets accumulation; the captured
    Renderer (render_frame(check_camera=True): a reset copied into the
    step's buffers, one replay) against frame_chain from the reset state,
    bit for bit each frame; then both timed in turns."""
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.engine.renderer import frame_chain

    def orbit():
        r.camera.process_mouse(2.0 / r.camera.mouse_sensitivity, 0.0)

    bad = []
    st = r.state
    r.camera.reset_movement_tracking()
    for i in range(CAPTURE_FRAMES):
        orbit()
        want = frame_chain(r.cfg, r.scene, r.env, r.lights,
                           r.camera.rays(r.device), state_mod.reset(st), 1)
        r.render_frame(check_camera=True)
        bad += [f"{p} at frame {i}" for p in same_run(
            torch, (r.state, r.last_stats), want)]
        st = want[0]
    state = [st]

    def eager():
        for _ in range(CAPTURE_FRAMES):
            orbit()
            state[0], _ = frame_chain(
                r.cfg, r.scene, r.env, r.lights, r.camera.rays(r.device),
                state_mod.reset(state[0]), 1)
            r.camera.has_moved_since_last_check()

    def captured():
        for _ in range(CAPTURE_FRAMES):
            orbit()
            r.render_frame(check_camera=True)

    ms = timed_pairs(torch, {"eager": eager, "captured": captured},
                     CAPTURE_PAIRS, CAPTURE_FRAMES)
    if bad:
        failed.append(f"anim: captured against frame_chain differs in {bad}")
    log(f"phase 25 anim {r.cfg.width}x{r.cfg.height} spp {r.cfg.spp} "
        f"d{r.cfg.max_depth} (2 degrees of orbit and a reset a frame): "
        f"captured against frame_chain each of {CAPTURE_FRAMES} frames: "
        f"{'bit for bit' if not bad else bad}; wall ms/frame over "
        f"{CAPTURE_PAIRS} pairs of {CAPTURE_FRAMES} frames, median (range): "
        f"eager {_med(ms['eager'])}, captured {_med(ms['captured'])} [{smi}]")


def phase_captured_step(torch, np, dev, smi):
    """Phase 25: the captured step, ``Renderer.render_frames`` as one CUDA
    graph replayed a frame (``engine/renderer._captured_step_dyn``; the
    sorted mesh frame's condense decision as two IF nodes, the compact
    path's chunk loops and path regeneration as WHILE nodes,
    ``wavefront.SegmentedGraph``), against the eager ``frame_chain`` from
    the same states on every config the bench and this script run: the
    masked integrator on default, cornell and hdr at 1920x1080, the mesh
    scene, the instanced grid and the baked grid at 512x384 d4 sorted and
    unsorted; compact on default, cornell and hdr 1080p and the mesh
    scene; regen on default 1080p and the three 512x384 scenes; the
    megakernel on default 1080p (every plane of the state, the rays per
    bounce and bounces_run bit for bit after a call of 1 frame, the
    capture, one of 8, replays, and two replays under sync-debug "error";
    every launch count equal, the sorted frame's branches and the loop
    bodies' runs among them, both branches seen; one graph launch a
    frame; the device tallies; the pool's bytes), the anim config (a moved
    camera and a reset a frame, each frame bit for bit) and two row bands
    of default, of the mesh scene and of compact default (the sharded
    step's band step against ``sharding.shard_frames``); wall ms/frame of
    eager and captured calls in turns, device busy and idle share a frame
    of each."""
    from spt_tpu_torch.camera import default_camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.engine.renderer import Renderer, _captured_step_dyn
    from spt_tpu_torch.parallel import sharding
    from spt_tpu_torch.scene import build_default_scene

    failed, seen, rows = [], set(), []
    masked = [("default", lambda: renderer("default", W, H, dev)),
              ("cornell", lambda: renderer("cornell", W, H, dev)),
              ("hdr", lambda: renderer("hdr", W, H, dev)),
              ("mesh", lambda: mesh_renderer(dev)),
              ("mesh unsorted", lambda: mesh_renderer(dev, ray_sort=False)),
              ("instanced grid", lambda: inst_renderer(dev)),
              ("instanced grid unsorted",
               lambda: inst_renderer(dev, ray_sort=False)),
              ("baked grid", lambda: stream_renderer(dev)),
              ("baked grid unsorted",
               lambda: stream_renderer(dev, ray_sort=False))]
    # the eager frames of these take 0.1-0.8 s: one shorter pair
    others = [(f"{name} compact", lambda name=name: renderer(
                  name, W, H, dev, integrator="compact"))
              for name in ("default", "cornell", "hdr")]
    others += [("mesh compact",
                lambda: mesh_renderer(dev, integrator="compact")),
               ("default regen",
                lambda: renderer("default", W, H, dev, integrator="regen")),
               ("mesh regen", lambda: mesh_renderer(dev, integrator="regen")),
               ("instanced grid regen",
                lambda: inst_renderer(dev, integrator="regen")),
               ("baked grid regen",
                lambda: stream_renderer(dev, integrator="regen")),
               ("default megakernel", lambda: renderer(
                   "default", W, H, dev, integrator="megakernel"))]
    for group, pairs, frames, check in (
            (masked, CAPTURE_PAIRS, CAPTURE_FRAMES, CAPTURE_CHECK),
            (others, 1, 4, (1, 3))):
        for name, make in group:
            t0 = time.perf_counter()
            r = make()
            rows.append(_captured_config(torch, name, r, smi, failed, seen,
                                         pairs, frames, check))
            del r
            torch.cuda.empty_cache()
            log(f"phase 25 {name}: {time.perf_counter() - t0:.1f} s")
    if not {"condensed", "full_width"} <= set(seen):
        failed.append(f"the sorted frames took the branches {seen}, not both")
    cfg = RenderConfig(width=W, height=H, spp=4, max_depth=6)
    _captured_anim(torch, Renderer(build_default_scene(), cfg,
                                   camera=default_camera(W, H), device=dev),
                   smi, failed)
    for name, r in (("default", renderer("default", W, H, dev)),
                    ("mesh", mesh_renderer(dev)),
                    ("default compact", renderer("default", W, H, dev,
                                                 integrator="compact"))):
        rays = r.camera.rays(dev)
        for rank in range(2):
            row0, n_rows = sharding.band(r.cfg, rank, 2)
            step = _captured_step_dyn(r.cfg, r.scene, r.env, r.lights, dev,
                                      row0, n_rows)
            st = state_mod.init_state(r.cfg.num_pixels // 2, dev)
            bad, calls = [], [(k, step) for k in CAPTURE_CHECK]
            # and two replays under sync-debug "error"
            calls.append((2, lambda *a: replay_sync_free(torch, step, *a)))
            for k, call in calls:
                want = sharding.shard_frames(r.cfg, r.scene, r.env, r.lights,
                                             rays, st, k, rank, 2)
                st, stats = call(rays, st, k)
                bad += [f"{p} after k={k}" for p in same_run(
                    torch, (st, stats), want)]
            log(f"phase 25 {name} band {rank} of 2 (rows {row0}-"
                f"{row0 + n_rows - 1}): the captured band step against "
                f"shard_frames after k={CAPTURE_CHECK + (2,)} (the last "
                f"under sync-debug \"error\"): "
                f"{'bit for bit' if not bad else bad}; graph launches "
                f"{step.graph.launches}; device tallies "
                f"{device_tallies(step.graph)}; pool "
                f"{graph_pool_bytes(torch, step.graph)} B")
            if bad:
                failed.append(f"{name} band {rank} of 2: {bad}")
    if failed:
        raise AssertionError("\n".join(failed))
    return rows


# --- the trainer (phase 26) ---------------------------------------------------

# The JAX example's own result, the figure case (a) is held to: its run on
# the CPU (examples/inverse_albedo.py, main() with JAX on the CPU) prints
# "visible materials: 7/9, max albedo error after 150 steps: 0.000", and
# its visible rows (jax.grad of its loss at the 0.5 start, a row's largest
# |entry| above 1e-6) are these.
JAX_EXAMPLE_VISIBLE = (0, 1, 2, 3, 5, 6, 7)
JAX_EXAMPLE_ERR = 0.000
TRAIN_ERR_LIMIT = 0.01
# Steps of each case's captured run, and pairs of timed calls of
# TRAIN_PAIR_STEPS steps: (a) at its example's 150 steps; (b), (c) 10.
TRAIN_STEPS = {"a": 150, "b": 10, "c": 10}
TRAIN_PAIRS = {"a": (5, 5), "b": (3, 2), "c": (3, 2)}


def trainer_module():
    """``examples/inverse_albedo_torch.py`` beside this file, imported by its
    path (a package named ``examples`` elsewhere on the path would shadow
    the directory)."""
    import importlib.util

    name = "inverse_albedo_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, "examples", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def grads_agree(torch, got, want):
    """(max |got - want|, whether every entry is within phase 21's
    tolerance: 1e-2 of its own size plus 1e-4 of the largest, and finite)."""
    scale = float(want.abs().max())
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= 1e-2 * want.abs() + 1e-4 * scale).all())
    return float(diff.max()), ok


def _trainer_case(torch, np, case, name, inputs, smi, failed,
                  cpu_inputs=None):
    """Phase 26 on one scene: the gradient at the 0.5 start eagerly twice
    (whether the card's backward is deterministic), captured
    (``megakernel.GradStep``: one replay a call) against eager, bit for bit
    where the eager ones agree bit for bit, else within phase 21's
    tolerance, and against the CPU where `cpu_inputs` are given; the
    wrappers' launches in one replayed step; the captured training run
    (``examples/inverse_albedo_torch.train``), one replay a step; eager
    against captured steps (gradient, Adam, clip) in turns; the launches
    of one eager step (profiler) and the graph's pool."""
    from spt_tpu_torch.integrators.megakernel import GradStep

    albedo_loss, train = trainer_module().albedo_loss, trainer_module().train

    loss_fn, true_bc = albedo_loss(*inputs)
    init = torch.full_like(true_bc, 0.5)
    step = GradStep(loss_fn, init)
    eager = [tuple(t.clone() for t in step.body()) for _ in range(2)]
    deterministic = all(_same_bits(torch, a, b)
                        for a, b in zip(eager[0], eager[1]))
    before = read_counts()
    loss, grad = (t.clone() for t in step())   # the capture, then a replay
    torch.cuda.synchronize()
    captured_counts = read_counts()
    loss2, grad2 = step()
    torch.cuda.synchronize()
    after = read_counts()
    per_step = {k: after[k] - captured_counts[k] for k in after
                if after[k] != captured_counts[k]}
    first = {k: captured_counts[k] - before[k] for k in after
             if captured_counts[k] != before[k]}
    same = [_same_bits(torch, a, b) for a, b in
            ((loss, eager[0][0]), (grad, eager[0][1]),
             (loss2, eager[0][0]), (grad2, eager[0][1]))]
    diff, close = grads_agree(torch, grad, eager[0][1])
    ldiff = abs(float(loss) - float(eager[0][0]))
    if deterministic and not all(same):
        failed.append(f"({case}) the eager gradients agree bit for bit, the "
                      f"captured one does not: {same}, max |d| {diff:.3g}")
    if not close or not ldiff <= 1e-3 * abs(float(eager[0][0])):
        failed.append(f"({case}) captured against eager: max |d| {diff:.3g}"
                      f", loss {float(loss)!r} against "
                      f"{float(eager[0][0])!r}")
    if step.graph.launches != 2:
        failed.append(f"({case}) {step.graph.launches} graph launches in 2 "
                      f"calls")
    cpu_note = ""
    if cpu_inputs is not None:
        cpu_loss, cpu_true = albedo_loss(*cpu_inputs)
        if not torch.equal(cpu_true, true_bc.cpu()):
            failed.append(f"({case}) the CPU's base colors differ")
        _, g_cpu = GradStep(cpu_loss, torch.full_like(cpu_true, 0.5))()
        cdiff, cok = grads_agree(torch, grad.cpu(), g_cpu)
        cpu_note = (f"; against the CPU max |d| {cdiff:.3g} (largest entry "
                    f"{float(g_cpu.abs().max()):.3g}; limit 1e-2 relative + "
                    f"1e-4 of the largest)")
        if not cok:
            failed.append(f"({case}) captured gradient against the CPU's: "
                          f"max |d| {cdiff:.3g}")
    log(f"phase 26 ({case}) {name}: d(image MSE)/d(base_color) at 0.5 gray, "
        f"two eager runs on the card "
        f"{'bit for bit' if deterministic else 'NOT bit for bit'}; captured "
        f"(GradStep, the capture and 2 replays) against eager: loss and "
        f"gradient {'bit for bit' if all(same) else f'not bit for bit, max |d| {diff:.3g} (limit 1e-2 relative + 1e-4 of the largest)'}"
        f"{cpu_note}; launches of the port's kernels in one replayed "
        f"step {per_step or 'none'} (the warm-up and the first replay "
        f"{first or 'none'}); pool {graph_pool_bytes(torch, step.graph)} B "
        f"[{smi}]")

    opt = torch.optim.Adam([step.param], lr=0.05)

    def adam(loss_grad):
        step.param.grad = loss_grad[1]
        opt.step()
        with torch.no_grad():
            step.param.clamp_(0.0, 1.0)

    pairs, n = TRAIN_PAIRS[case]

    def steps_of(fn):
        def run():
            for _ in range(n):
                adam(fn())
        return run

    ms = timed_pairs(torch, {"eager": steps_of(step.body),
                             "captured": steps_of(step)}, pairs, n)
    busy = {"eager": device_busy_ms(torch, steps_of(step.body), iters=1),
            "captured": device_busy_ms(torch, steps_of(step), iters=1)}
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    pool = graph_pool_bytes(torch, step.graph)
    del step, opt
    torch.cuda.empty_cache()

    lines = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained = train(loss_fn, true_bc, steps=TRAIN_STEPS[case],
                    log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = trained.losses.cpu()
    falling = bool((losses[1:] < losses[:-1]).all())
    visible = tuple(int(i) for i in np.nonzero(trained.seen)[0])
    if trained.step.graph.launches != TRAIN_STEPS[case]:
        failed.append(f"({case}) {trained.step.graph.launches} graph "
                      f"launches in {TRAIN_STEPS[case]} steps")
    if not np.isfinite(trained.err) or not bool(torch.isfinite(losses).all()):
        failed.append(f"({case}) a loss or the error is not finite")
    log(f"phase 26 ({case}) {name}: the captured run of "
        f"{TRAIN_STEPS[case]} steps (gradient, Adam 0.05, clip to [0, 1]): "
        f"{wall:.2f} s wall, {trained.step.graph.launches} graph launches, "
        f"image MSE a step {[float(f'{x:.4g}') for x in losses]} "
        f"({'falling at every step' if falling else 'NOT falling at every step'}); "
        f"{' | '.join(lines)}; wall ms a training step over {pairs} pairs "
        f"of {n}-step calls, median (range): eager {_med(ms['eager'])}, "
        f"captured {_med(ms['captured'])}; device busy ms a step "
        f"(profiler) eager {busy['eager'][0] / n:.4f} over "
        f"{busy['eager'][1] / n:.1f} launches, captured "
        f"{busy['captured'][0] / n:.4f} over {busy['captured'][1] / n:.1f}; "
        f"pool {pool} B [{smi}]")
    return dict(trained=trained, visible=visible, falling=falling,
                per_step=per_step, ms=med, wall=wall, pool=pool,
                deterministic=deterministic)


@contextlib.contextmanager
def eager_grad_steps():
    """Run ``megakernel.GradStep``'s calls as its eager body: the reference
    a captured training run is held against."""
    from spt_tpu_torch.integrators.megakernel import GradStep

    saved = GradStep.__call__
    GradStep.__call__ = GradStep.body
    try:
        yield
    finally:
        GradStep.__call__ = saved


def training_run(inputs, steps: int):
    """(the loss each step saw, the final base colors) of the trainer's run
    of `steps` steps from 0.5 gray on `inputs`, on the host."""
    mod = trainer_module()
    t = mod.train(*mod.albedo_loss(*inputs), steps=steps,
                  log=lambda *_: None)
    return t.losses.cpu(), t.step.param.detach().cpu()


def phase_trainer(torch, np, dev, smi):
    """Phase 26: the inverse-rendering trainer on the card
    (``examples/inverse_albedo_torch.py``, the gradient step a captured
    ``megakernel.GradStep``): (a) the JAX example's own config, the default
    scene at 64x32 spp 1 d3, 150 steps, its gradient also held against the
    CPU's, its final error on the visible materials at most
    TRAIN_ERR_LIMIT on the JAX example's 7 of 9 visible rows; (b) the mesh
    scene at 512x384 d4 (K4 inside the captured step) and (c) the hdr
    config at 512x384 d3 (K2 inside it), 10 steps each, every loss and the
    final base colors of the captured run bit for bit with an eager run
    (``eager_grad_steps``); on (b) the image MSE falling at every step, on
    (c) the losses within 1e-2 relative of the CPU's run at every step (its
    MSE rises after step 7 there too: Adam's momentum carries the ground's
    albedo past its value) and the last below the first.  Returns the
    launches of K4 and K2 a captured step of (b) and (c)."""
    from spt_tpu_torch.bench import build_workload

    example_inputs = trainer_module().example_inputs
    cpu = torch.device("cpu")

    failed = []
    a = _trainer_case(torch, np, "a", "default 64x32 spp 1 d3",
                      example_inputs(dev), smi, failed,
                      cpu_inputs=example_inputs(cpu))
    if a["visible"] != JAX_EXAMPLE_VISIBLE:
        failed.append(f"(a) visible rows {a['visible']}, the JAX example's "
                      f"{JAX_EXAMPLE_VISIBLE}")
    if not a["trained"].err <= TRAIN_ERR_LIMIT:
        failed.append(f"(a) max albedo error {a['trained'].err} after 150 "
                      f"steps (limit {TRAIN_ERR_LIMIT})")
    log(f"phase 26 (a) after 150 captured steps: visible materials "
        f"{len(a['visible'])}/{len(a['trained'].seen)} {a['visible']} (the "
        f"JAX example's on the CPU: {JAX_EXAMPLE_VISIBLE}), max albedo error "
        f"{a['trained'].err:.6f} (limit {TRAIN_ERR_LIMIT}; the JAX example "
        f"on the CPU {JAX_EXAMPLE_ERR:.3f}) [{smi}]")
    del a
    torch.cuda.empty_cache()

    def inputs(r, **cfg_kw):
        return (r.cfg.replace(**cfg_kw), r.scene, r.env, r.lights,
                r.camera.rays(r.device))

    out = {}
    for case, name, make, cfg_kw, kernels in (
            ("b", f"mesh scene {MW}x{MH} d{MESH_DEPTH}",
             lambda d: mesh_renderer(d), {}, ("closest_hit", "any_hit")),
            ("c", f"hdr {MW}x{MH} d3",
             lambda d: build_workload("hdr", MW, MH, d), {"max_depth": 3},
             ("env_sample",))):
        card = inputs(make(dev), **cfg_kw)
        o = _trainer_case(torch, np, case, name, card, smi, failed)
        steps = TRAIN_STEPS[case]
        losses = o["trained"].losses.cpu()
        with eager_grad_steps():
            e_losses, e_param = training_run(card, steps)
        same = (_same_bits(torch, losses, e_losses) and _same_bits(
            torch, o["trained"].step.param.detach().cpu(), e_param))
        note = ""
        if case == "c":
            c_losses, _ = training_run(inputs(make(cpu), **cfg_kw), steps)
            rel = float(((losses - c_losses).abs() / c_losses).max())
            note = (f"; the CPU's run {[float(f'{x:.4g}') for x in c_losses]}"
                    f", the card's within {rel:.3g} relative (limit 1e-2)")
            if not rel <= 1e-2 or not losses[-1] < losses[0]:
                failed.append(f"({case}) the losses {losses.tolist()}, the "
                              f"CPU's {c_losses.tolist()}")
        elif not o["falling"]:
            failed.append(f"({case}) the image MSE did not fall at every "
                          f"step: {losses.tolist()}")
        if not same:
            failed.append(f"({case}) the captured run differs from the eager "
                          f"one: {losses.tolist()} against "
                          f"{e_losses.tolist()}")
        for k in kernels:
            if o["per_step"].get(k, 0) < 1:
                failed.append(f"({case}) {k} was not launched in the "
                              f"captured step: {o['per_step']}")
        log(f"phase 26 ({case}) {name}: the captured run of {steps} steps "
            f"against an eager run: every loss and the final base colors "
            f"{'bit for bit' if same else 'NOT bit for bit'}{note} [{smi}]")
        out.update({k: o["per_step"].get(k, 0) for k in kernels})
        del o, card
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("\n".join(failed))
    return out


# --- the unfused route (phase 27) ---------------------------------------------

# The fused kernels, which no frame of a declined scene launches.
FUSED_KERNELS = ("fused_frame", "fused_bounce", "sort_chunks",
                 "fused_frame_global", "fused_bounce_global")


def unfused_scenes():
    """[(name, make(device) -> Renderer, tracer kernels its frames launch,
    whether phase 27 holds its image against the plain path's, and against
    a band rendered on the CPU)]: the scenes the fused kernels decline, each
    through the unfused route.  Where no kernel is on the route the plain
    path runs the same code on the same device, so the CPU band is the
    independent check there."""
    from spt_tpu_torch import materials
    from spt_tpu_torch import scene as tscene
    from spt_tpu_torch.camera import Camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.engine.renderer import Renderer
    from spt_tpu_torch.lights import LightManager
    from spt_tpu_torch.scene import desc as tdesc

    def rtiow(integrator, dev):
        desc, cam = rtiow_scene(tscene)
        cfg = RenderConfig(width=W, height=H, spp=1, max_depth=6,
                           integrator=integrator)
        return Renderer(desc, cfg, lights=LightManager().device(dev),
                        camera=Camera(aspect_ratio=W / H, **cam), device=dev)

    def ringed(build, radius, r, dev):
        desc, cam = build(tscene, materials, tdesc)
        add_sphere_ring(desc, (cam["target"][0], cam["target"][1] + 0.3,
                               cam["target"][2]), radius, r=r)
        cfg = RenderConfig(width=MW, height=MH, spp=1, max_depth=MESH_DEPTH)
        return Renderer(desc, cfg, camera=Camera(aspect_ratio=MW / MH, **cam),
                        device=dev)

    def cornell(dev):
        _, cfg, env, lights, cam = workload("cornell", W, H, dev)
        return Renderer(cornell_split_light(tscene, materials), cfg, env=env,
                        lights=lights, camera=cam, device=dev)

    return [("rtiow", lambda d: rtiow("masked", d), (), True, True),
            ("rtiow compact", lambda d: rtiow("compact", d), (), True, True),
            ("mesh + 40 spheres", lambda d: ringed(mesh_scene, 1.3, 0.06, d),
             ("closest_hit", "any_hit"), True, False),
            ("instanced grid + 40 spheres",
             lambda d: ringed(inst_grid_scene, 3.3, 0.12, d),
             ("closest_hit_inst", "any_hit_inst"), False, False),
            ("cornell 8x8 lights", cornell, (), True, True)]


def graph_nodes_a_frame(graph) -> float:
    """Nodes (kernels, copies, memsets) a replay of a captured step's graph
    runs, a mean over its replays: each segment's nodes times its runs
    (once a replay, or the runs the device tallied for a conditional
    body)."""
    from spt_tpu_torch.ops import cuda_graph

    api = cuda_graph.Api()
    runs = [] if graph._tally is None else graph._tally.taken.tolist()

    def walk(items, times):
        return sum(times * api.nodes(it.graph.raw_cuda_graph())[0]
                   if isinstance(it, cuda_graph.Segment)
                   else walk(it.body, runs[it.slot]) for it in items)

    return walk(graph.items, graph.launches) / graph.launches


def body_nodes(items) -> list:
    """The nodes of a captured step's graph by part (``SegmentedGraph.items``):
    a segment's node count, a conditional as {"if" | "while": [its body's
    parts]}."""
    from spt_tpu_torch.ops import cuda_graph

    api = cuda_graph.Api()
    return [api.nodes(it.graph.raw_cuda_graph())[0]
            if isinstance(it, cuda_graph.Segment) else
            {"if" if isinstance(it, cuda_graph.Branch) else "while":
             body_nodes(it.body)} for it in items]


# Rows of the band that phase 27 renders on the CPU: 9 x 1920 lanes, past
# COMPACT_MIN_LANES, so that the compact integrator takes its chunk loops
# there as on the card.
CPU_BAND_ROWS = 9
# The band's gate: at most this share of its pixels off by more than 1e-3
# in a channel, and its mean within 1 %.  Not a relative RMSE: at spp 1 a
# path through RTIOW's glass and mirror spheres changes outright when its
# ray moves by an ulp (CUDA's and the CPU's transcendentals differ by
# ulps), so a few pixels differ by up to ~0.3 whatever the two devices; the
# CPU against itself with the camera nudged by one ulp shows as much, and
# is printed beside it.
CPU_BAND_OFF_SHARE = 0.01


def _cpu_band(torch, np, make, img, cfg):
    """The card's first frame `img` ((H * W, 3) at `cfg`) in its middle
    CPU_BAND_ROWS rows against the same band rendered on the CPU by
    ``make(cpu)``, and that band against the CPU's with the camera nudged
    by one ulp -> (whether the card's passes the gate, the line's text)."""
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.engine.renderer import frame_chain

    cpu = torch.device("cpu")
    c = make(cpu)
    row0 = (cfg.height - CPU_BAND_ROWS) // 2
    cam = c.camera.rays(cpu)

    def band(cam):
        st = state_mod.init_state(cfg.width * CPU_BAND_ROWS, cpu)
        return frame_chain(c.cfg, c.scene, c.env, c.lights, cam, st, 1,
                           row0, CPU_BAND_ROWS)[0].accum.numpy()

    t0 = time.perf_counter()
    want = band(cam)
    secs = time.perf_counter() - t0
    nudged = band(cam._replace(position=torch.nextafter(
        cam.position, torch.full_like(cam.position, float("inf")))))
    card = img.reshape(cfg.height, cfg.width, 3)[
        row0:row0 + CPU_BAND_ROWS].reshape(-1, 3).cpu().numpy()

    def diff(a):
        off = float((np.abs(a - want).max(axis=1) > 1e-3).mean())
        return (off, rel_rmse(np, a, want),
                float(abs(a.mean() / want.mean() - 1)))

    (off, err, mean), (n_off, n_err, _) = diff(card), diff(nudged)
    return off <= CPU_BAND_OFF_SHARE and mean < 0.01, (
        f"rows [{row0}, {row0 + CPU_BAND_ROWS}) against the CPU's: "
        f"{off:.3%} of pixels off by more than 1e-3 (limit "
        f"{CPU_BAND_OFF_SHARE:.0%}), means within {mean:.3e} (limit 1e-2), "
        f"relative RMSE {err:.3e}; the CPU against itself with the camera "
        f"nudged by one ulp {n_off:.3%}, {n_err:.3e}; {secs:.1f} s a band "
        f"on the CPU")


def _unfused_config(torch, np, name, r, make, smi, failed, with_plain,
                    cpu_band, phase=27, skip_note="phase 10 holds K7"):
    """Phase 27 (phase 28 with `phase`) on one Renderer `r`: two eager frames
    (``frame_chain``, timed one at a time) from the initial state; the
    Renderer's first frame (the warm-up and the capture) and one replay
    under sync-debug "error" against them, bit for bit, every launch count
    of the two runs equal, one graph launch; eager against captured frames
    in turns (2 pairs at 512x384, 1 at 1080p); the graph's nodes a frame and
    its pool; the first frame's image against the plain path's
    (`with_plain`; else `skip_note` says why not) and against a band
    rendered on the CPU (`cpu_band`, ``_cpu_band``)."""
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.engine.renderer import frame_chain

    args = (r.cfg, r.scene, r.env, r.lights, r.camera.rays(r.device))
    st0 = state_mod.init_state(r.cfg.num_pixels, r.device)
    wants, bad = [], []

    def chain():
        st = st0
        for _ in range(2):
            st, stats = frame_chain(*args, st, 1)
            wants.append((st, stats))

    def captured():
        r.render_frames(1)
        bad.extend(f"{p} after the capture" for p in same_run(
            torch, (r.state, r.last_stats), wants[0]))
        try:
            got = replay_sync_free(torch, r.captured_step(), args[4],
                                   r.state, 1)
            bad.extend(f"{p} after a replay under sync-debug" for p in
                       same_run(torch, got, wants[1]))
        except RuntimeError as e:
            failed.append(f"{name}: a replay waited for the device: {e}")

    eager = counts_of(torch, chain)
    got = counts_of(torch, captured)
    graph = r.captured_step().graph
    if bad:
        failed.append(f"{name}: captured against frame_chain differs in {bad}")
    if got != captured_counts(r, eager, 2):
        failed.append(f"{name}: launch counts eager {eager}, captured {got}")
    launches = graph.launches
    if launches != 1:
        failed.append(f"{name}: {launches} graph launches for a frame")
    nodes = graph_nodes_a_frame(graph)
    pool = graph_pool_bytes(torch, graph)
    state = [wants[1][0]]

    def eager_frame():
        state[0], _ = frame_chain(*args, state[0], 1)

    pairs = 2 if r.cfg.num_pixels < W * H else 1
    ms = timed_pairs(torch, {"eager": eager_frame,
                             "captured": lambda: r.render_frames(1)},
                     pairs, 1)
    check_image(np, r, f"{'unfused' if phase == 27 else 'tables'}_"
                f"{name.split()[0]}", os.path.join(
        HERE, "build", "chip_smoke"), 1)
    img, notes = wants[0][0].accum, []
    if with_plain:
        with plain_path():
            plain = frame_chain(*args, st0, 1)[0].accum.cpu().numpy()
        err = rel_rmse(np, img.cpu().numpy(), plain)
        notes.append(f"against the plain path {err:.3e}")
        if not err < 0.01:
            failed.append(f"{name}: image against the plain path {err:.3e}")
    else:
        notes.append(f"against the plain path skipped ({skip_note})")
    if cpu_band:
        ok, note = _cpu_band(torch, np, make, img, r.cfg)
        notes.append(note)
        if not ok:
            failed.append(f"{name}: image {note}")
    whiles = cond_kinds(graph.items).count("while")
    log(f"phase {phase} {name} {r.cfg.width}x{r.cfg.height} "
        f"d{r.cfg.max_depth}: "
        f"captured against frame_chain (the capture, then a replay under "
        f"sync-debug \"error\"): {'bit for bit' if not bad else bad}; "
        f"launch counts over 2 frames "
        f"{'as expected' if got == captured_counts(r, eager, 2) else 'unexpected'}"
        f": {got}; {launches} graph launch for the replayed frame, {whiles} "
        f"WHILE nodes, device tallies {device_tallies(graph)}; "
        f"{nodes:.0f} graph nodes a replayed frame; pool {pool} B; wall "
        f"ms/frame eager "
        f"{_med(ms['eager'])}, captured {_med(ms['captured'])} ({pairs} "
        f"pairs); image (1 frame, relative RMSE) {'; '.join(notes)} "
        f"[{smi}]")
    return dict(name=name, ms={k: sorted(v)[len(v) // 2]
                               for k, v in ms.items()},
                nodes=nodes, pool=pool, counts=got, whiles=whiles,
                image="; ".join(notes))


def phase_unfused(torch, np, dev, smi):
    """Phase 27: the unfused route, the scenes the fused kernels decline
    (``wavefront._fused_ok``): (a) the final render of *Ray Tracing in One
    Weekend* (``rtiow_scene``: 487 spheres, 487 materials, no accel) at
    1920x1080 d6, masked and compact; (b) the mesh scene with a ring of 40
    spheres (K4 standalone) and (c) the instanced grid with one (K7
    standalone) at 512x384 d4, with the tracers' shared bytes and blocks per
    SM at 41 spheres; (d) cornell with its light split into 8x8 quads (128
    NEE emitters, 140 primitives) at 1920x1080 d8.  For each: the decline
    reason; ``_unfused_config``; no fused kernel launched and the scene's
    tracer kernels launched (the counts reset before, read after)."""
    from spt_tpu_torch.integrators import wavefront
    from spt_tpu_torch.ops import cuda_bounce

    failed, rows = [], []
    for name, make, tracers, with_plain, cpu_band in unfused_scenes():
        t0 = time.perf_counter()
        r = make(dev)
        reason = cuda_bounce.explain_decline(r.cfg, r.scene, r.lights)
        if reason is None or wavefront._fused_ok(r.cfg, r.scene, r.lights):
            failed.append(f"{name}: the fused kernels take it")
        sc = r.scene
        accel = ("an instanced" if sc.inst is not None
                 else "a cluster" if sc.accel is not None else "no")
        log(f"phase 27 {name}: {sc.num_triangles} triangles, "
            f"{sc.num_spheres} spheres, {sc.materials.count} materials, "
            f"{0 if sc.emitters is None else sc.emitters.count} emitters, "
            f"{accel} accel; declined: {reason}")
        if tracers:
            # the standalone tracers' tables with every sphere of the scene
            inst = sc.inst is not None
            log_occupancy(27, smi, {k: _trace_shared_bytes(
                ("inst_" + k[:-5]) if inst else k,
                sc.inst if inst else sc.accel, sc) for k in tracers})
        reset_counts()
        row = _unfused_config(torch, np, name, r, make, smi, failed,
                              with_plain, cpu_band)
        launched = {k: v for k, v in read_counts().items() if v}
        if any(k in launched for k in FUSED_KERNELS):
            failed.append(f"{name}: fused kernels launched: {launched}")
        if not all(k in launched for k in tracers):
            failed.append(f"{name}: {tracers} not all launched: {launched}")
        row.update(reason=reason, launched=launched)
        rows.append(row)
        log(f"phase 27 {name}: the phase's launches {launched or 'none'} "
            f"(the tracer kernels); {time.perf_counter() - t0:.1f} s [{smi}]")
        del r
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("\n".join(failed))
    return rows


# --- tables in global memory (phase 28) ---------------------------------------

# The many-lights scenes: a row of 1 200 point lights over the default
# scene (its tables pass the small forms' 48 KiB at 1 100) and one of 5 000
# over the mesh scene and the baked grid (past the mesh forms' 227 KiB at
# about 4 900); 12 000 spheres beside a mesh pass the standalone tracers'
# 227 KiB.
LIGHT_ROW = dict(start=(-6.0, 3.0, 1.0), step=(0.01, 0.0, 0.0),
                 intensity=0.01)
MANY_LIGHTS = 1200
MESH_LIGHTS = 5000
MANY_SPHERES = 12000
# Lanes of each recorded call that phase 28 holds against the plain version
# (the plain shading tests every light's shadow ray against every
# triangle, in one chunk, ``one_chunk``: on the baked grid under 5 000
# lights some 40 s a bounce at 128 lanes), by scene.
BAND_LANES = {"lights": 4 * W, "grid": 4096, "mesh": 1024, "baked": 64,
              "spheres": 512}
# Ray-primitive tests one plain any-hit slice holds at once in
# ``one_chunk``: 64 Mi, 256 MB a float plane.
ONE_CHUNK_TESTS = 1 << 26
# Repeats of each same-process pair of placements (phase 28 (d)).
PLACEMENT_PAIRS = 3


@contextlib.contextmanager
def one_chunk():
    """The plain tracers' chunked brute force in one chunk a trace: the
    winner is the first minimum whatever the chunking
    (``intersect._scan_min``) and an any-hit an any, so the results are the
    same bits, and a plain frame over thousands of lights launches a few
    kernels a light, not a few a 128 triangles.  A small scene's unrolled
    any-hit (``intersect._occluded_unrolled``, some 70 launches a primitive)
    takes the chunked one too: the same tests in the same order of
    arithmetic (``_tri_chunk_test``, ``_sph_chunk_test``), so the same
    flags (tests/test_torch_tables.py holds the plain bounce's bits with
    and without this).  The shading's light groups hand the any-hit a
    group's lanes at once (``transport.light_group``), so it takes them in
    slices of at most ONE_CHUNK_TESTS / primitives lanes: each lane's flag
    is its own, so the slices give the same bits."""
    import torch

    from spt_tpu_torch.ops import intersect as isect
    from spt_tpu_torch.ops.vec3 import Vec3

    chunk = 1 << 17
    closest, occluded = isect._intersect_chunked, isect._occluded_chunked
    unrolled = isect._occluded_unrolled

    def sliced(scene, o, d, tmin, tmax, **k):
        n = o.x.shape[0]
        step = max(1, ONE_CHUNK_TESTS // max(
            1, min(chunk, scene.num_triangles + scene.num_spheres)))
        if n <= step:
            return occluded(scene, o, d, tmin, tmax, chunk_size=chunk)
        tmax = isect._lane_tmax(tmax, o)
        return torch.cat([occluded(
            scene, Vec3(*(c[a:a + step] for c in o)),
            Vec3(*(c[a:a + step] for c in d)), tmin, tmax[a:a + step],
            chunk_size=chunk) for a in range(0, n, step)])

    isect._intersect_chunked = lambda *a, **k: closest(*a, chunk_size=chunk,
                                                       **k)
    isect._occluded_chunked = sliced
    isect._occluded_unrolled = sliced
    try:
        yield
    finally:
        isect._intersect_chunked, isect._occluded_chunked = closest, occluded
        isect._occluded_unrolled = unrolled


def spread(torch, ids, k):
    """k of the lane ids `ids` at evenly spaced places (all when fewer)."""
    if ids.numel() <= k:
        return ids
    return ids[torch.linspace(0, ids.numel() - 1, k,
                              device=ids.device).long()]


def band_lanes(torch, ps, n):
    """The ids of at most n lanes of the PathState `ps`, spread evenly over
    its live lanes (up to n / 2, more when the dead ones are fewer) and its
    dead ones, in lane order, so that the band sees the image's mix of
    paths, not its first rows."""
    alive = torch.nonzero(ps.alive).flatten()
    dead = torch.nonzero(~ps.alive).flatten()
    k = min(alive.numel(), max(n - min(dead.numel(), n // 2), n // 2))
    return torch.sort(torch.cat([spread(torch, alive, k),
                                 spread(torch, dead, n - k)])).values


def lane_band(torch, ps, n):
    """The PathState `ps` on its ``band_lanes``, every plane gathered."""
    return _take_lanes(ps, band_lanes(torch, ps, n))


def lights_renderer(dev, w, h, depth, n=MANY_LIGHTS, **cfg_kw):
    """The default scene under a row of `n` point lights (``light_row``)."""
    from spt_tpu_torch import scene as tscene
    from spt_tpu_torch.camera import default_camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.engine.renderer import Renderer
    from spt_tpu_torch.lights import LightManager

    cfg = RenderConfig(width=w, height=h, spp=1, max_depth=depth, **cfg_kw)
    return Renderer(tscene.build_default_scene(), cfg,
                    lights=light_row(LightManager(), n, **LIGHT_ROW).device(
                        dev), camera=default_camera(w, h), device=dev)


def scene_renderer(dev, build, w, h, depth, lights=0, spheres=0, **cfg_kw):
    """``build``'s scene (a builder of this file, at its default size) with
    a row of `lights` point lights 2 above its camera target (the default
    lights without), and a ring of `spheres` spheres beside it."""
    from spt_tpu_torch import materials
    from spt_tpu_torch import scene as tscene
    from spt_tpu_torch.camera import Camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.engine.renderer import Renderer
    from spt_tpu_torch.lights import LightManager
    from spt_tpu_torch.scene import desc as tdesc

    desc, cam = build(tscene, materials, tdesc)
    c = [float(x) for x in cam["target"]]
    if spheres:
        add_sphere_ring(desc, (c[0], c[1] + 0.3, c[2]), 1.3, n=spheres,
                        r=0.01)
    kw = {}
    if lights:
        kw["lights"] = light_row(
            LightManager(), lights, (c[0] - 2.0, c[1] + 2.0, c[2] + 1.0),
            (4.0 / lights, 0.0, 0.0), 0.002).device(dev)
    cfg = RenderConfig(width=w, height=h, spp=1, max_depth=depth, **cfg_kw)
    return Renderer(desc, cfg, camera=Camera(aspect_ratio=w / h, **cam),
                    device=dev, **kw)


def _frame_name(mode, in_global=True):
    """fused_frame's form for accel `mode` as a profiler trace names it, in
    the global placement or the shared one."""
    from spt_tpu_torch.ops import cuda_bounce

    return (cuda_bounce.FRAME_KERNELS_GLOBAL if in_global
            else cuda_bounce.FRAME_KERNELS)[mode]


def _global_fused(torch, what, fn_name, args, kw, band, smi, band_kw=None,
                  iters=10):
    """A fused_frame or fused_bounce (`fn_name`) call its main path gave it,
    its tables in global memory: the whole call's device ms; on `band` of
    its lanes (``lane_band``) the kernel against its plain version (every
    plane bit for bit, the rays per bounce exact: check_frame /
    check_bounce), its device ms, the plain version's ms and its bound
    (the bytes and the walks' operations of that band's call), with
    `band_kw` in place of `kw` where given (a later start_bounce: the plain
    version's Python loop over thousands of lights takes some 20 s a
    bounce).  -> the kernel-line numbers, all of the band's call, with the
    whole call's ms beside them."""
    from spt_tpu_torch.ops import cuda_bounce

    cfg, scene, lights, ps = args[:4]
    mode = cuda_bounce._accel_mode(scene)
    if not cuda_bounce.tables_in_global(cfg, scene, lights):
        raise AssertionError(f"{what}: the tables fit a block's shared "
                             "memory")
    fn = getattr(cuda_bounce, fn_name)
    name = (_frame_name(mode) if fn_name == "fused_frame"
            else cuda_bounce.BOUNCE_KERNELS_GLOBAL[mode])
    full_ms = kernel_device_ms(torch, lambda: fn(*args, **kw), name, iters)
    bargs = (cfg, scene, lights, lane_band(torch, ps, band)) + tuple(args[4:])
    kw = kw if band_kw is None else band_kw
    with one_chunk():
        if fn_name == "fused_frame":
            worst, b, plain_ms = check_frame(torch, 28, what, bargs, kw,
                                             with_bound=True)
            ms = kernel_device_ms(torch, lambda: fn(*bargs, **kw), name, iters)
            row = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound=b)
        else:
            row = check_bounce(torch, 28, what, bargs, kw, with_bound=True,
                               smi=smi, iters=iters)
    row.update(full_ms=full_ms, library_ms=None, lanes=ps.num_paths,
               band=bargs[3].num_paths)
    log(f"phase 28 {name} at {what}: the whole call ({ps.num_paths} lanes, "
        f"{int(ps.alive.sum())} alive) {full_ms:.4f} ms (device time); on "
        f"{row['band']} of its lanes kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
        f"({row['bound'][1]}), max |d| {row['max_abs_err']:.3g} [{smi}]")
    return row


# Each standalone tracer family by its wrappers' prefix: (packed inputs,
# kernel name in the global placement, operations counter, closest and
# any-hit plain versions).
TRACE_FAMILIES = {
    "": ("_resident_inputs", "trace_global_kernel", "_cluster_trace_ops",
         "closest_hit_reference", "any_hit_reference"),
    "inst_": ("_inst_inputs", "inst_trace_global_kernel", "_inst_trace_ops",
              "inst_closest_hit_reference", "inst_any_hit_reference"),
    "stream_": ("_stream_inputs", "stream_trace_global_kernel",
                "_stream_trace_ops", "closest_hit_reference",
                "any_hit_reference")}


def _global_trace(torch, what, fn_name, args, band, smi):
    """A standalone tracer call its main path gave it (regen), its tables in
    global memory: the whole call's device ms; on `band` of its rays (spread
    over the call) the
    kernel against its plain version, every plane bit for bit, its device
    ms, the plain version's ms and its bound (the rays' bytes in and out,
    the tables and tri_pack once, the walks' operations)."""
    from spt_tpu_torch.ops import cuda_trace as ct
    from spt_tpu_torch.ops.vec3 import Vec3

    src, scene, o, d, tmin, tmax = args
    fn = getattr(ct, fn_name)
    any_hit = fn_name.endswith("any_hit")
    family = fn_name[:-len("any_hit" if any_hit else "closest_hit")]
    inputs, kernel, ops_name, closest_ref, any_ref = TRACE_FAMILIES[family]
    tables, pack, dims = getattr(ct, inputs)(src, scene)[:3]
    if not ct.tables_in_global(tables, dims[0]):
        raise AssertionError(f"{what}: the tables fit a block's shared memory")
    name = f"{kernel}<{'true' if any_hit else 'false'}>"
    full_ms = kernel_device_ms(torch, lambda: fn(*args), name)
    idx = spread(torch, torch.arange(o.x.shape[0], device=o.x.device), band)
    n = idx.numel()
    bo, bd = Vec3(*(c[idx].contiguous() for c in o)), Vec3(
        *(c[idx].contiguous() for c in d))
    btmax = (torch.broadcast_to(tmax, o.x.shape)[idx].contiguous()
             if isinstance(tmax, torch.Tensor) else tmax)
    bargs = (src, scene, bo, bd, tmin, btmax)
    ref = getattr(ct, any_ref if any_hit else closest_ref)
    pk = fn(*bargs)
    with one_chunk():
        pp, plain_ms = _timed(torch, lambda: ref(*bargs))
    ops_fn = globals()[ops_name]
    if any_hit:
        planes = {"blocked": (pk, pp)}
        t_end = torch.as_tensor(btmax, device=bo.x.device,
                                dtype=torch.float32)
        ops = ops_fn(torch, scene, bo, bd, tmin, btmax, t_end, blocked=pp)
        nbytes = n * (7 * 4 + 1)
    else:
        planes = _hit_planes(torch, pk, pp)
        ops = ops_fn(torch, scene, bo, bd, tmin, btmax, pp.t)
        nbytes = n * (7 * 4 + 24)
    worst = check_planes(torch, f"{what} ({n} of {o.x.shape[0]} rays)",
                         planes, phase=28, exact=tuple(planes))
    ms = kernel_device_ms(torch, lambda: fn(*bargs), name)
    b = bound(nbytes + 4 * tables.numel() + 4 * pack.numel(), ops)
    log(f"phase 28 {name} at {what}: the whole call ({o.x.shape[0]} rays) "
        f"{full_ms:.4f} ms (device time); on {n} rays kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; "
        f"{ops_note(ops)}) [{smi}]")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound=b,
                library_ms=None, full_ms=full_ms, lanes=o.x.shape[0], band=n)


def _recorded(targets, run):
    """{function name: [(args, kw), ...]} of the calls of the (module,
    name) targets that `run` makes, eagerly (``capture_calls``)."""
    out = {}
    with capture_calls(targets) as calls:
        run()
    for name, args, kw in calls:
        out.setdefault(name, []).append((args, kw))
    return out


def _main_path_counts(torch, r, frames, keys):
    """The launch counts of `frames` frames of `r` (the counts reset
    before, read after), and a check that each of `keys` launched."""
    reset_counts()
    r.render_frames(frames)
    torch.cuda.synchronize()
    got = {k: v for k, v in read_counts().items() if v}
    if not all(k in got for k in keys):
        raise AssertionError(f"{keys} not all launched: {got}")
    return got


def _placement_pairs(torch, what, calls, smi, failed):
    """Phase 28 (d): each (label, fn, args, kw, shared kernel, global
    kernel) of `calls`, a call that fits both placements, run with its
    tables in shared memory and with the global placement forced: the
    results bit for bit, then each placement's device ms, in turns,
    PLACEMENT_PAIRS times.  -> {label: (shared ms, global ms)} medians."""
    out = {}
    for label, fn, args, kw, shared_name, global_name in calls:
        a = _flat_planes(fn(*args, **kw, _in_global=False))
        b = _flat_planes(fn(*args, **kw, _in_global=True))
        torch.cuda.synchronize()
        if len(a) != len(b) or not all(_same_bits(torch, x, y)
                                       for x, y in zip(a, b)):
            failed.append(f"{what} {label}: the global placement differs from "
                          "the shared one")
        ms = {"shared": [], "global": []}
        for i in range(PLACEMENT_PAIRS):
            order = (("shared", False, shared_name), ("global", True,
                                                     global_name))
            for key, g, name in (order if i % 2 == 0 else order[::-1]):
                ms[key].append(kernel_device_ms(
                    torch, lambda: fn(*args, **kw, _in_global=g), name))
        med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
        out[label] = (med["shared"], med["global"])
        log(f"phase 28 (d) {what} {label}: shared {_med(ms['shared'])} ms, "
            f"global {_med(ms['global'])} ms (device time a launch, "
            f"{PLACEMENT_PAIRS} in turns), global / shared "
            f"{med['global'] / med['shared']:.3f}; results bit for bit "
            f"[{smi}]")
    return out


def _flat_planes(v):
    """The tensors of a kernel's result: a tuple / NamedTuple of planes,
    Vec3s or tensors, flattened; None dropped."""
    import torch

    if v is None:
        return []
    if isinstance(v, torch.Tensor):
        return [v]
    return [t for x in v for t in _flat_planes(x)]


def phase_tables_global(torch, np, dev, smi):
    """Phase 28: scenes whose tables pass a block's shared memory, their
    kernels reading the tables from global memory. (a) the default scene
    under a row of 1 200 point lights at 1920x1080 d6: the captured masked frames
    against ``frame_chain``, wall ms/frame; K1 small at the masked frame's
    call (held on its band from bounce 5, one bounce) and K3 small at the
    compact path's bounce-0 call; compact's main path, the captured frame
    at 128x128 d3 (two chunk loops) against ``frame_chain``
    (``_captured_replay``, then ``_replay_again``) and the other captured
    frames under those lights (``_many_light_frames``); (b) the 4 096-instance grid
    (``wide_grid_scene``) at 512x384 d4: K3 and K1 instanced at the sorted
    frame's calls, the captured sorted frame against ``frame_chain``, and
    regen's K7 at one regen frame's first two calls of each kind; (c) the
    mesh scene and the baked grid under 5 000 point lights at 128x96 d2:
    the captured sorted frames against ``frame_chain``
    (``_captured_replay``), K3 and K1 resident and stream at the sorted
    frame's calls (K3 at bounce 0, K1 from bounce 1, the last); (e) the
    mesh scene and the baked grid with 12 000 spheres at 128x96 d2, regen:
    K4 and K8. Each K1, K3 and tracer call against its plain version on a
    band of its lanes (BAND_LANES, ``lane_band``; the plain any-hit in one
    chunk, ``one_chunk``), every plane bit for bit, with its device ms,
    bound and plain ms there and the whole call's device ms; each kernel
    launched on its main path (the counts reset before, read after); no
    shared-placement K1 or K3 launched on an overflowing scene. (d) the
    same kernels on scenes that fit both placements, shared against forced
    global (the wrappers' private `_in_global`) in one process, in turns,
    bit for bit: default 1080p (K1, K3 small), the mesh scene (K1, K3
    resident, K4), the instanced grid (K1, K3 instanced, K7) and the baked
    grid (K1, K3 stream, K8) at 512x384 d4, the tracers on the primary
    rays. Returns (the kernel-line numbers by name, {pair: (shared ms,
    global ms)})."""
    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.ops import cuda_bounce, cuda_trace
    from spt_tpu_torch.ops.vec3 import Vec3

    failed, out = [], {}
    fused = [(cuda_bounce, "fused_frame"), (cuda_bounce, "fused_bounce")]
    traces = [(cuda_trace, f) for f in (
        "closest_hit", "any_hit", "inst_closest_hit", "inst_any_hit",
        "stream_closest_hit", "stream_any_hit")]
    t_all = time.perf_counter()

    def shared_note(r):
        return (f"{cuda_bounce.shared_bytes(r.cfg, r.scene, r.lights)} B of "
                f"shared memory a block in the shared placement, "
                f"{cuda_bounce.shared_bytes(r.cfg, r.scene, r.lights, True)} "
                "in the global one")

    def no_shared(what, got):
        if any(k in got for k in ("fused_frame", "fused_bounce",
                                  "whole_frame")):
            failed.append(f"{what}: a shared-placement fused kernel "
                          f"launched: {got}")

    # (a) the default scene under 1 200 point lights
    t0 = time.perf_counter()
    r = lights_renderer(dev, W, H, 6)
    if cuda_bounce.explain_decline(r.cfg, r.scene, r.lights) is not None:
        failed.append("(a): the fused kernels decline 1 200 lights")
    log(f"phase 28 (a) default + {MANY_LIGHTS} point lights {W}x{H} d6: "
        f"{r.lights.count} lights, {shared_note(r)}")
    reset_counts()
    row = _unfused_config(torch, np, f"lights {MANY_LIGHTS}", r, None, smi,
                          failed, False, False, phase=28,
                          skip_note="the kernels are held on bands below")
    got = {k: v for k, v in read_counts().items() if v}
    no_shared("(a)", got)
    calls = _recorded(fused, lambda: r.render_frames(1))
    a, k = calls["fused_frame"][0]
    out["fused_frame_global"] = _global_fused(
        torch, f"default + {MANY_LIGHTS} lights {W}x{H} d6", "fused_frame",
        a, k, BAND_LANES["lights"], smi,
        band_kw=dict(k, start_bounce=r.cfg.max_depth - 1))
    # the captured masked frames take K1's whole-frame form; the split form
    # runs in frame_chain, which they are held against
    if got.get("whole_frame_global", 0) < 1:
        failed.append(f"(a): the captured masked frames launched no "
                      f"whole_frame_global: {got}")
    out["fused_frame_global"].update(launches=got.get("fused_frame_global",
                                                      0),
                                     captured_ms=row["ms"]["captured"])
    out["whole_frame_global"] = {"launches": got.get("whole_frame_global",
                                                     0)}
    ps0 = transport.gen_primary(r.cfg, r.camera.rays(dev), 0)
    out["fused_bounce_small_global"] = _global_fused(
        torch, f"compact bounce 0, default + {MANY_LIGHTS} lights {W}x{H}",
        "fused_bounce", (r.cfg, r.scene, r.lights, ps0, 0, False), {},
        BAND_LANES["lights"], smi)
    del r, calls, a, ps0
    torch.cuda.empty_cache()
    # compact's chunks shade through the plain path, its lights in groups
    # (transport.light_group); depth 3 runs two chunk loops (ROADMAP.md
    # section 3, fault 3)
    rc = lights_renderer(dev, 128, 128, 3, integrator="compact")
    what = f"(a) compact + {MANY_LIGHTS} lights"
    got, _ = _captured_replay(torch, what, rc, "fused_bounce_global", smi,
                              failed, nodes=True)
    out["fused_bounce_small_global"]["launches"] = got.get(
        "fused_bounce_global", 0)
    _replay_again(torch, what, rc, smi, failed)
    del rc
    torch.cuda.empty_cache()
    _many_light_frames(torch, dev, smi, failed)
    log(f"phase 28 (a): {time.perf_counter() - t0:.1f} s [{smi}]")

    # (b) 4 096 instances
    t0 = time.perf_counter()
    r = scene_renderer(dev, wide_grid_scene, MW, MH, MESH_DEPTH)
    ia = r.scene.inst
    log(f"phase 28 (b) wide grid {MW}x{MH} d{MESH_DEPTH}: "
        f"{r.scene.num_triangles} world triangles, {ia.num_instances} "
        f"instances of {ia.num_meshes} mesh, {shared_note(r)}")
    reset_counts()
    row = _unfused_config(torch, np, "wide grid", r, None, smi, failed, False,
                          False, phase=28,
                          skip_note="the kernels are held on bands below")
    got = {k: v for k, v in read_counts().items() if v}
    no_shared("(b)", got)
    calls = _recorded(fused, lambda: r.render_frames(1))
    a, k = calls["fused_bounce"][0]
    out["fused_bounce_instanced_global"] = _global_fused(
        torch, "wide grid sorted frame bounce 0", "fused_bounce", a, k,
        BAND_LANES["grid"], smi)
    a, k = calls["fused_frame"][0]
    out["fused_frame_instanced_global"] = _global_fused(
        torch, "wide grid sorted frame", "fused_frame", a, k,
        BAND_LANES["grid"], smi)
    for k in ("fused_frame", "fused_bounce"):
        out[f"{k}_instanced_global"]["launches"] = got.get(f"{k}_global", 0)
    out["fused_frame_instanced_global"]["captured_ms"] = row["ms"]["captured"]
    rr = _twin(r, "regen")
    calls = _recorded(traces, lambda: rr.render_frames(1))
    for fn_name, key in (("inst_closest_hit", "closest_hit_inst_global"),
                         ("inst_any_hit", "any_hit_inst_global")):
        # the first call (bounce 0): the plain any-hit walks every instance
        # in a Python loop
        out[key] = _global_trace(torch, "wide grid regen call 1", fn_name,
                                 calls[fn_name][0][0], BAND_LANES["grid"],
                                 smi)
    got = _main_path_counts(torch, rr, 2, ("closest_hit_inst_global",
                                           "any_hit_inst_global"))
    for key in ("closest_hit_inst_global", "any_hit_inst_global"):
        out[key]["launches"] = got[key]
    log(f"phase 28 (b) wide grid regen 2 frames: launches {got}; "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    del r, rr, calls
    torch.cuda.empty_cache()

    # (c) 5 000 point lights over the mesh scene and the baked grid (3 timed
    # launches of each: 50-900 ms each)
    for label, build, mode in (("mesh", mesh_scene, "resident"),
                               ("baked", unique_grid_scene, "stream")):
        t0 = time.perf_counter()
        r = scene_renderer(dev, build, 128, 96, 2, lights=MESH_LIGHTS)
        if cuda_bounce._accel_mode(r.scene) != mode:
            failed.append(f"(c) {label}: accel mode "
                          f"{cuda_bounce._accel_mode(r.scene)}, not {mode}")
        log(f"phase 28 (c) {label} + {MESH_LIGHTS} point lights 128x96 d2: "
            f"{r.scene.num_triangles} triangles, {shared_note(r)}")
        got, ms = _captured_replay(torch, f"(c) {label} + {MESH_LIGHTS} "
                                   "lights", r, "fused_frame_global", smi,
                                   failed)
        calls = _recorded(fused, lambda: r.render_frames(1))
        for fn_name, key, what in (
                ("fused_bounce", {"resident": "fused_bounce_global",
                                  "stream": "fused_bounce_stream_global"},
                 "bounce 0"),
                ("fused_frame", {"resident": "fused_frame_resident_global",
                                 "stream": "fused_frame_stream_global"},
                 "sorted frame")):
            a, k = calls[fn_name][0]
            out[key[mode]] = _global_fused(
                torch, f"{label} + {MESH_LIGHTS} lights {what}", fn_name, a,
                k, BAND_LANES[label], smi, iters=3)
            out[key[mode]].update(launches=got.get(f"{fn_name}_global", 0),
                                  captured_ms=ms)
        log(f"phase 28 (c) {label}: {time.perf_counter() - t0:.1f} s [{smi}]")
        del r, calls
        torch.cuda.empty_cache()

    # (e) 12 000 spheres beside the mesh scene and the baked grid (regen)
    for label, build, fns in (
            ("mesh", mesh_scene, (("closest_hit", "closest_hit_global"),
                                  ("any_hit", "any_hit_global"))),
            ("baked", unique_grid_scene,
             (("stream_closest_hit", "closest_hit_stream_global"),
              ("stream_any_hit", "any_hit_stream_global")))):
        t0 = time.perf_counter()
        r = scene_renderer(dev, build, 128, 96, 2, spheres=MANY_SPHERES,
                           integrator="regen")
        log(f"phase 28 (e) {label} + {MANY_SPHERES} spheres 128x96 d2 regen: "
            f"{r.scene.num_triangles} triangles, {r.scene.num_spheres} "
            f"spheres; declined: "
            f"{cuda_bounce.explain_decline(r.cfg, r.scene, r.lights)}")
        calls = _recorded(traces, lambda: r.render_frames(1))
        for fn_name, key in fns:
            rows = [_global_trace(torch, f"{label} + {MANY_SPHERES} spheres "
                                  f"regen call {i + 1}", fn_name, a,
                                  BAND_LANES["spheres"], smi)
                    for i, (a, _) in enumerate(calls[fn_name])]
            out[key] = _mean_rows(rows)
        got = _main_path_counts(torch, r, 2, [k for _, k in fns])
        for _, key in fns:
            out[key]["launches"] = got[key]
        log(f"phase 28 (e) {label} regen 2 frames: launches {got}; "
            f"{time.perf_counter() - t0:.1f} s [{smi}]")
        del r, calls
        torch.cuda.empty_cache()

    # (d) on scenes that fit both placements: shared against forced global
    t0 = time.perf_counter()
    pairs = {}
    r = renderer("default", W, H, dev)
    calls = _recorded(fused, lambda: r.render_frames(1))
    a, k = calls["fused_frame"][0]
    ps0 = transport.gen_primary(r.cfg, r.camera.rays(dev), 0)
    pairs.update(_placement_pairs(torch, f"default {W}x{H} d6", [
        ("K1 small", cuda_bounce.fused_frame, a, k, _frame_name(None, False),
         _frame_name(None)),
        ("K3 small (compact bounce 0)", cuda_bounce.fused_bounce,
         (r.cfg, r.scene, r.lights, ps0, 0, False), {},
         cuda_bounce.BOUNCE_KERNELS[None],
         cuda_bounce.BOUNCE_KERNELS_GLOBAL[None])], smi, failed))
    for label, make, mode, tr in (
            ("mesh", mesh_renderer, "resident", ("closest_hit", "any_hit",
                                                 "trace_kernel")),
            ("instanced grid", inst_renderer, "instanced",
             ("inst_closest_hit", "inst_any_hit", "inst_trace_kernel")),
            ("baked grid", stream_renderer, "stream",
             ("stream_closest_hit", "stream_any_hit",
              "stream_trace_kernel"))):
        r = make(dev)
        calls = _recorded(fused, lambda: r.render_frames(1))
        fa, fk = calls["fused_frame"][0]
        ba, bk = calls["fused_bounce"][0]
        # the tracers on the frame's primary rays
        ps0 = ba[3]
        ta = (r.scene.inst if mode == "instanced" else r.scene.accel,
              r.scene, Vec3(*(c.contiguous() for c in ps0.origin)),
              Vec3(*(c.contiguous() for c in ps0.direction)), 1e-4, 1e30)
        g = tr[2].replace("_kernel", "_global_kernel")
        pairs.update(_placement_pairs(torch, f"{label} {MW}x{MH} d4", [
            (f"K1 {mode}", cuda_bounce.fused_frame, fa, fk,
             _frame_name(mode, False), _frame_name(mode)),
            (f"K3 {mode} bounce 0", cuda_bounce.fused_bounce, ba, bk,
             cuda_bounce.BOUNCE_KERNELS[mode],
             cuda_bounce.BOUNCE_KERNELS_GLOBAL[mode]),
            (f"{tr[0]} (primary rays)", getattr(cuda_trace, tr[0]), ta, {},
             f"{tr[2]}<false>", f"{g}<false>"),
            (f"{tr[1]} (primary rays)", getattr(cuda_trace, tr[1]), ta, {},
             f"{tr[2]}<true>", f"{g}<true>")], smi, failed))
        del r, calls
        torch.cuda.empty_cache()
    log(f"phase 28 (d): {time.perf_counter() - t0:.1f} s [{smi}]")
    for v in out.values():
        v.setdefault("launches", 0)
    log(f"phase 28: {time.perf_counter() - t_all:.1f} s in all [{smi}]")
    if failed:
        raise AssertionError("\n".join(failed))
    return out, pairs


def _captured_replay(torch, what, r, key, smi, failed, nodes=False):
    """Phase 28 on an overflowing scene's main path, the Renderer's captured
    frame: the first call (the eager warm-up and the capture), then one
    replay, the launch counts reset just before it and read just after,
    held bit for bit against ``frame_chain`` from the same state; no
    shared-placement K1 or K3 in it and `key` (a kernel's launch counter)
    in it; the replay's ms beside the eager frame's, and with `nodes` the
    graph's nodes by body (``body_nodes``).  -> (the replay's launch
    counts, its wall ms)."""
    from spt_tpu_torch.engine.renderer import frame_chain

    args = (r.cfg, r.scene, r.env, r.lights, r.camera.rays(r.device))
    t0 = time.perf_counter()
    r.render_frames(1)
    torch.cuda.synchronize()
    t_cap = time.perf_counter() - t0
    st = type(r.state)(*(t.clone() for t in r.state))
    t0 = time.perf_counter()
    want = frame_chain(*args, st, 1)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    r.render_frames(1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    got = {k: v for k, v in read_counts().items() if v}
    bad = same_run(torch, (r.state, r.last_stats), want)
    if bad:
        failed.append(f"{what}: the replayed frame differs from frame_chain "
                      f"in {bad}")
    if not got.get(key) or "fused_frame" in got or "fused_bounce" in got:
        failed.append(f"{what}: the replayed frame launched {got}, not "
                      f"{key} alone of the fused kernels")
    shape = (f"; nodes by body {body_nodes(r.captured_step().graph.items)}"
             if nodes else "")
    log(f"phase 28 {what} {r.cfg.width}x{r.cfg.height} d{r.cfg.max_depth}, "
        f"the Renderer's captured frame: the warm-up and the capture "
        f"{t_cap:.1f} s; one replay {ms:.4f} ms wall, the eager frame "
        f"{1e3 * t_eager:.4f} ms wall, launches {got}{shape}; against "
        f"frame_chain from the same state: "
        f"{'bit for bit' if not bad else bad} [{smi}]")
    return got, ms


def _replay_again(torch, what, r, smi, failed):
    """One more replay of `r`'s captured frame, held bit for bit against
    ``frame_chain`` from the same state (a graph whose conditional bodies
    held ~3 million nodes ran its first launch right and faulted at its
    second: ROADMAP.md section 3, fault 3); logs its wall ms beside the
    eager frame's."""
    from spt_tpu_torch.engine.renderer import frame_chain

    args = (r.cfg, r.scene, r.env, r.lights, r.camera.rays(r.device))
    st = type(r.state)(*(t.clone() for t in r.state))
    t0 = time.perf_counter()
    want = frame_chain(*args, st, 1)
    torch.cuda.synchronize()
    eager = 1e3 * (time.perf_counter() - t0)
    launches = r.captured_step().graph.launches
    t0 = time.perf_counter()
    r.render_frames(1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    bad = same_run(torch, (r.state, r.last_stats), want)
    if bad:
        failed.append(f"{what}: the graph's launch {launches + 1} differs "
                      f"from frame_chain in {bad}")
    log(f"phase 28 {what} {r.cfg.width}x{r.cfg.height} d{r.cfg.max_depth}: "
        f"the graph's launch {launches + 1}, {ms:.4f} ms wall, the eager "
        f"frame {eager:.4f} ms wall; against frame_chain: "
        f"{'bit for bit' if not bad else bad} [{smi}]")


# The other captured frames phase 28 (a) runs under MANY_LIGHTS lights at
# 128x128 (tests/test_torch_tables.py holds each, and compact at 1920x1080
# d6): (integrator, depth, scene), "spheres" the unfused route's
# ``sphere_field``.
MANY_LIGHT_FRAMES = (("compact", 4, "default"), ("regen", 3, "default"),
                     ("megakernel", 3, "default"), ("masked", 3, "spheres"),
                     ("compact", 3, "spheres"))


def _many_light_frames(torch, dev, smi, failed):
    """Phase 28 (a): each of MANY_LIGHT_FRAMES, the Renderer's first call
    (the eager warm-up and the capture), its graph's nodes by body, then
    two replays (``_replay_again``)."""
    from spt_tpu_torch import scene as tscene
    from spt_tpu_torch.camera import Camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.engine.renderer import Renderer
    from spt_tpu_torch.lights import LightManager

    for integrator, depth, name in MANY_LIGHT_FRAMES:
        if name == "spheres":
            cfg = RenderConfig(width=128, height=128, spp=1, max_depth=depth,
                               integrator=integrator)
            r = Renderer(sphere_field(tscene), cfg, lights=light_row(
                LightManager(), MANY_LIGHTS, **LIGHT_ROW).device(dev),
                camera=Camera(aspect_ratio=1.0, **SPHERE_POSE), device=dev)
        else:
            r = lights_renderer(dev, 128, 128, depth, integrator=integrator)
        what = f"(a) {integrator} on {name} + {MANY_LIGHTS} lights"
        t0 = time.perf_counter()
        r.render_frames(1)
        torch.cuda.synchronize()
        log(f"phase 28 {what} d{depth}: the warm-up and the capture "
            f"{time.perf_counter() - t0:.1f} s; nodes by body "
            f"{body_nodes(r.captured_step().graph.items)}")
        for _ in range(2):
            _replay_again(torch, what, r, smi, failed)
        del r
        torch.cuda.empty_cache()


def _twin(r, integrator):
    """A Renderer on `r`'s scene, environment, lights and camera with
    another integrator, from its initial state (no second flatten)."""
    import copy

    from spt_tpu_torch.engine import state as state_mod

    twin = copy.copy(r)
    twin.cfg = r.cfg.replace(integrator=integrator)
    twin.state = state_mod.init_state(twin.cfg.num_pixels, r.device)
    twin.last_stats = None
    twin._captured = None
    twin._wavefront_integrator = integrator
    return twin


def _mean_rows(rows):
    """One kernel-line row from a form's rows at several calls: the worst
    error, the means of the times and of the bounds' ms."""
    k = len(rows)
    b = sum(r["bound"][0] for r in rows) / k
    by = max(rows, key=lambda r: r["bound"][0])["bound"][1]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows) / k,
                plain_ms=sum(r["plain_ms"] for r in rows) / k, bound=(b, by),
                full_ms=sum(r["full_ms"] for r in rows) / k, library_ms=None,
                calls=k)


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
    log(f"phase 0 build: {time.perf_counter() - t0:.2f} s in all, its parts "
        f"{library_parts()}")
    log(f"phase 0 kernels: {cuda_lib.kernel_info()}")
    for line in cuda_lib.PTXAS_LOG.splitlines():
        if "Compiling entry" in line or "spill" in line or "Used" in line:
            log("phase 0 ptxas: " + line.strip())

    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)

    def timed(phase, *args):
        """phase(*args), its wall seconds logged (where a later slice's
        phase finds its room in the call's time)."""
        t = time.perf_counter()
        try:
            return phase(*args)
        finally:
            log(f"{phase.__name__}: {time.perf_counter() - t:.1f} s wall "
                f"(script at {time.perf_counter() - T_START:.1f} s)")

    small = timed(phase_kernel_vs_plain, torch, cuda_bounce, dev, smi)
    whole = small.pop("whole")
    small_launches, whole_launches, env_launches = timed(
        phase_main_path, torch, np, cuda_bounce, dev, out_dir)
    timed(phase_image_vs_plain, torch, np, dev)
    timed(phase_times, torch, dev, smi)

    mesh = timed(phase_mesh_kernels, torch, np, dev, smi)
    counts, branches = timed(phase_mesh_main_path, torch, np, dev, out_dir)
    regen = timed(phase_regen_path, torch, np, dev, out_dir)
    timed(phase_mesh_images, torch, np, dev)
    timed(phase_mesh_times, torch, dev, smi)

    inst = timed(phase_inst_kernels, torch, np, dev, smi)
    inst_counts = timed(phase_inst_main_path, torch, np, dev, out_dir, smi)
    inst_regen = timed(phase_inst_regen_path, torch, np, dev, out_dir)
    timed(phase_inst_images, torch, np, dev)

    stream = timed(phase_stream_kernels, torch, np, dev, smi)
    stream_counts = timed(phase_stream_main_path, torch, np, dev, out_dir,
                          smi)
    stream_regen = timed(phase_stream_regen_path, torch, np, dev, out_dir)
    timed(phase_stream_images, torch, np, dev)
    timed(phase_any_size, torch, np, dev, smi)
    env_k = timed(phase_env_kernel, torch, np, dev, smi)

    k3_small, k3_small_launches = timed(phase_compact, torch, np, dev,
                                        out_dir, smi)
    timed(phase_megakernel, torch, np, dev, out_dir, smi)
    timed(phase_debug_views, torch, np, dev, smi)
    timed(phase_entry_points, np, out_dir, smi)
    timed(phase_sharding, torch, np, dev, smi)
    timed(phase_sharded_world, torch, np, dev, smi)
    timed(phase_captured_step, torch, np, dev, smi)
    trainer = timed(phase_trainer, torch, np, dev, smi)
    timed(phase_unfused, torch, np, dev, smi)
    tables, _ = timed(phase_tables_global, torch, np, dev, smi)

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
        # K1 small from lane index to accumulation (phases 1, 2 and 28 (a))
        entry("whole_frame", "fused_frame.cu",
              "spt_tpu/ops/pallas_bounce.py:1090", whole_launches,
              whole["whole_frame"]),
        entry("whole_frame_global", "fused_frame.cu",
              "spt_tpu/ops/pallas_bounce.py:1090",
              tables["whole_frame_global"]["launches"],
              whole["whole_frame_global"]),
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
    # the same kernels with their tables in global memory (phase 28)
    for name, source, replaces in (
            ("fused_frame_global", "fused_frame.cu", "pallas_bounce.py:1090"),
            ("fused_bounce_small_global", "fused_bounce.cu",
             "pallas_bounce.py:752"),
            ("fused_frame_resident_global", "fused_frame.cu",
             "pallas_bounce.py:1090"),
            ("fused_bounce_global", "fused_bounce.cu", "pallas_bounce.py:752"),
            ("fused_frame_instanced_global", "fused_frame.cu",
             "pallas_bounce.py:1090"),
            ("fused_bounce_instanced_global", "fused_bounce.cu",
             "pallas_bounce.py:752"),
            ("fused_frame_stream_global", "fused_frame.cu",
             "pallas_bounce.py:1090"),
            ("fused_bounce_stream_global", "fused_bounce.cu",
             "pallas_bounce.py:752"),
            ("closest_hit_global", "cluster_trace.cu", "pallas_trace.py:497"),
            ("any_hit_global", "cluster_trace.cu", "pallas_trace.py:617"),
            ("closest_hit_inst_global", "inst_trace.cu",
             "pallas_inst.py:823"),
            ("any_hit_inst_global", "inst_trace.cu", "pallas_inst.py:840"),
            ("closest_hit_stream_global", "stream_trace.cu",
             "pallas_stream.py:104"),
            ("any_hit_stream_global", "stream_trace.cu",
             "pallas_stream.py:250")):
        kernels.append(entry(name, source, f"spt_tpu/ops/{replaces}",
                             tables[name]["launches"], tables[name]))
    for k in kernels:
        # the trainer's captured gradient step (phase 26 (b), (c)) runs the
        # cluster tracer and the equirect sampler too
        if k["name"] in trainer:
            k["trainer_launches_per_step"] = trainer[k["name"]]
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
