#!/usr/bin/env python3
"""Time fused_frame (K1, its small and mesh forms), fused_bounce (K3) and the
equirect sampler (K2) on one CUDA card, beside variants of the kernels'
constants and another checkout's kernels.

    python3 frame_sweep.py [--part all|small|mesh|bounce]
                           [--variants NAME:kConst=V[+kConst=V]/...]
                           [--other DIR] [--frames 16] [--pairs 1]
                           [--small-only] [--edits NAME,...] [--sass DIR]
                           [--queue-grids]
    python3 frame_sweep.py --part sass --sass DIR --other DIR
    python3 frame_sweep.py --part step --other DIR [--pairs 1] [--frames 8]
                           [--reps 5] [--configs NAME,...]

Builds the port's kernels as committed and, for each variant, with the
named ``constexpr int`` constants of ``spt_tpu_torch/csrc`` (each defined
once in one source) set to the values given
(``--variants b256:kSmallBlock=256/m3:kFrameMinBlocks=3``).
With ``--other``, it also loads ``DIR``'s kernels through ``DIR``'s own
wrappers (``DIR/spt_tpu_torch/ops/cuda_lib.py``, ``cuda_bounce.py`` and
``cuda_env.py``; another commit's checkout, e.g. ``git archive`` of the
parent unpacked in an ignored directory), so a kernel whose C interface
changed is timed beside its predecessor.  Every build's outputs are held
to the committed build's, bit for bit, and every build is timed in turns,
forward then backward.

The small part (``--part small``): K1 small on the three small-scene
configs at 1920x1080 (``chip_smoke.workload``: default depth 6, cornell
depth 8, hdr depth 6, from bounce 0 of sample 0's primary rays) by
torch.profiler device time per launch and its wrapper by CUDA events
around whole calls; env_sample at the hdr frame's call by CUDA events
behind a spin kernel; last, default 1920x1080 depth 6 through each build's
wrappers and ``Renderer.render_frames``: ms/frame (CUDA events) and device
launches per frame (torch.profiler).  ``--depth1`` adds default at depth 1
(bounce 0 alone); ``--notrig`` adds a build of the sampler with its atan2f
and acosf replaced by a subtraction, timed only, for what the exact
trigonometry costs.

The bounce part (``--part bounce``): K3 (fused_bounce) per call, at the
compact path's bounce-0 call on default, cornell and hdr at 1920x1080 (the
small form), at each of the sorted frame's three calls on the three mesh
scenes, at the compact path's bounce-0 call on the mesh scene and at each
call of band 0 of a 2-band mesh frame (``sharding.shard_frames``): the
lanes and live lanes of the call, every build's result against the
committed build's bit for bit, torch.profiler device time per launch, and
each build's K3 registers, spill and blocks per SM; then each mesh scene's
sorted frame through the committed build's and ``--other``'s fused_bounce
(images bit for bit, ms/frame, busy and launches per frame) and the
compact path's default 1920x1080 d6 frame through every build (device
busy and launches).  ``--small-only`` keeps the small form's calls and the
compact default frame.  The kernel's constants take variants as above
(``--variants c2:kTakeMax=2``, ``m5:kSmallBounceMinBlocks=5``);
``--queue-grids`` adds a build that runs the instanced and stream forms as
queue kernels too, timed only (the package runs them one thread a lane);
``--edits`` builds of the small form with lines of it rewritten (``EDITS``:
fed by a counter, functions not inlined, loops not unrolled, and, timed
only, with no lane shaded or the closest hit alone); ``--sass DIR``
writes each build's SASS of the small form there and logs its
instruction counts.  ``--part sass --sass DIR --other DIR`` makes the
builds, holds every kernel of ``--other``'s build to its SASS there and
stops (exit 1 if one differs or is missing; a kernel only this build has
is listed; a change to the launch code alone leaves every kernel's).

The mesh part (``--part mesh``): K1's resident, instanced and stream forms
on the three mesh scenes of ``chip_smoke.py`` at 512x384 depth 4
(``port_mesh_scene``, ``port_inst_scene``, ``port_stream_scene``), at the
inputs of the sorted frame's fused_frame call (recorded from one frame)
and at sample 0's bounce-0 state (the unsorted route), by torch.profiler
device time per launch, with the live lanes of each call and each build's
registers, spill and blocks per SM; then each scene's frame, sorted and
unsorted, through the committed build's and ``--other``'s fused_frame:
the image against the committed build's bit for bit, ms/frame (CUDA
events; ``--pairs`` rounds of the builds in turns, with each build's
median and range), device busy and launches per frame (torch.profiler).

The step part (``--part step``): the captured frame step of this
checkout against ``--other``'s, in turns.  Each run is a process of its
own that imports one checkout's package and ``chip_smoke.py`` (so two
versions of ``spt_tpu_torch`` never meet in one interpreter; each builds
its kernels into its own ``build/``) and times ``Renderer.render_frames``
on the card, captured, for every config (``--configs``, default all of
``STEP_CONFIGS``: default, cornell and hdr at 1920x1080, the mesh scene,
the instanced grid and the baked grid at 512x384 d4, sorted and
``*_unsorted``; masked; and compact default 1080p and regen on the mesh
scene): after a first call of one frame (the capture), ``--reps`` calls
of ``--frames`` frames, each between CUDA events with one sync after,
then the median and range of ms/frame, the graph launches a frame and a
hash of the accumulation after the last call, the same frames in every
process, so the summary says whether both checkouts render them bit for
bit.  The processes run in the order other, this, this,
other (``--pairs`` times), so a drift of the card or its host falls on
both alike; the summary gives each checkout's median over its processes,
config by config.

Needs ``nvcc`` and one card; prints the card's name and power limit with
every time.  The builds are made by ``sweep_builds.py``.
"""

from __future__ import annotations

import argparse
import difflib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CONFIGS = ("default", "cornell", "hdr")
# Timed only, its results not held to the committed build's: the sampler
# with atan2f / acosf replaced by a subtraction, for what the exact
# trigonometry costs.
NOTRIG = (("atan2f(d.z, d.x)", "(d.z - d.x)"),
          ("acosf(fminf(fmaxf(d.y, -1.0f), 1.0f))", "(1.0f - d.y)"))


# The q23 build (--queue-grids, timed only): fused_bounce's instanced and
# stream forms launched as the queue kernel the resident form is, which the
# package does not do; counter_wrappers hands them its counters.
QUEUE_GRIDS = tuple(
    (f"err = launch_lanes<{k}>(io, sc, sa, smem, st);",
     f"err = launch_queue(fused_bounce_queue_kernel<{k}>, io, sc, sa, smem, st);")
    for k in (2, 3)) + tuple(
    (f"kernel_info(fused_bounce_kernel<{k}>, smem",
     f"kernel_info(fused_bounce_queue_kernel<{k}>, smem") for k in (2, 3))

# Edits of the small fused_bounce (--edits NAME,...), each a build of the
# committed sources with these (text, replacement) pairs, timed beside the
# others.  Bit-equal to the committed build, each a design tried once:
# - cnt: the lanes taken from a counter in chunks of 32 a warp (spt_queue.cuh
#   run_paths, K1 small's loop, one bounce a path) in place of the
#   grid-stride loop; its wrapper (counter_wrappers) zeroes the counter, one
#   fill launch a call more;
# - nocc: the small tracer's shadow test not inlined;
# - u1: the small tracer's triangle loops not unrolled.
# Timed only, not bit-equal (TIMED_ONLY), for where the time goes:
# - floor: no lane shaded (the loop's loads and stores alone);
# - trace: the closest hit alone (no shading, no shadow ray).
SHADE = ("p.alive = shade_bounce<Tracer, kSmallBounceBrdfCall != 0>(\n          tb, "
         "tracer, sa, p.bounce, is_last, p.o, p.d, p.thr, p.rad, p.rng, p.emok, "
         "p.missed);")
OCCLUDED = ("  __device__ bool occluded(V3 o, V3 d, float tmin, float tmax) "
            "const {\n    float t, u, v;\n"
            "    for (int i = 0; i < tb->n_tris; ++i)\n")
EDITS = {
    "cnt": (("stride_paths(io, tb, tracer, sa);",
             "run_paths<false>(io, tb, tracer, sa, nullptr, io.n, 32, 32);"),),
    "nocc": ((OCCLUDED, OCCLUDED.replace("__device__ bool",
                                         "__device__ __noinline__ bool")),),
    "u1": (("    for (int i = 0; i < tb->n_tris; ++i) {\n      float t, u, v;",
            "    _Pragma(\"unroll 1\") for (int i = 0; i < tb->n_tris; ++i) {\n"
            "      float t, u, v;"),
           (OCCLUDED, OCCLUDED.replace("    for (int", "    _Pragma(\"unroll 1\") for (int"))),
    "floor": ((SHADE, "p.missed = true;"),),
    "trace": ((SHADE, "p.alive = [&] { float t, hu, hv; int mat; V3 n; "
               "p.missed = tracer.closest(p.o, p.d, 0.0f, F32(1e30), t, mat, "
               "n, hu, hv) == 0; p.rad.x += t + n.x + n.y + n.z + hu + hv + "
               "mat; return !p.missed; }();"),),
}
TIMED_ONLY = ("notrig", "floor", "trace")

# The kernels whose SASS --sass writes and counts, by a part of their
# mangled names: the small fused_bounce (this checkout's and the
# one-thread-a-lane kernel before it); every other kernel's SASS is held to
# --other's.
SASS_KERNELS = ("small_bounce_kernel", "fused_bounce_kernelILi0E")

STEP_CONFIGS = ("default", "cornell", "hdr", "mesh", "mesh_unsorted", "inst",
                "inst_unsorted", "baked", "baked_unsorted", "default_compact",
                "mesh_regen")

# The body each process of --part step runs, in its checkout's root; argv:
# configs, frames, reps.
STEP_CHILD = r"""
import hashlib, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
names, frames, reps = sys.argv[1].split(","), int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda", 0)
W, H = cs.W, cs.H
makers = {
    "default": lambda: cs.renderer("default", W, H, dev),
    "cornell": lambda: cs.renderer("cornell", W, H, dev),
    "hdr": lambda: cs.renderer("hdr", W, H, dev),
    "mesh": lambda: cs.mesh_renderer(dev),
    "mesh_unsorted": lambda: cs.mesh_renderer(dev, ray_sort=False),
    "inst": lambda: cs.inst_renderer(dev),
    "inst_unsorted": lambda: cs.inst_renderer(dev, ray_sort=False),
    "baked": lambda: cs.stream_renderer(dev),
    "baked_unsorted": lambda: cs.stream_renderer(dev, ray_sort=False),
    "default_compact": lambda: cs.renderer("default", W, H, dev,
                                           integrator="compact"),
    "mesh_regen": lambda: cs.mesh_renderer(dev, integrator="regen"),
}
out = {}
t0 = torch.cuda.Event(enable_timing=True)
t1 = torch.cuda.Event(enable_timing=True)
for name in names:
    r = makers[name]()
    r.render_frames(1)
    graph = r.captured_step().graph
    before = graph.launches
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0.record()
        r.render_frames(frames)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1) / frames)
    out[name] = {"ms": ms, "graphs": (graph.launches - before) / (reps * frames),
                 "accum": hashlib.sha256(
                     r.state.accum.cpu().numpy().tobytes()).hexdigest()[:16]}
    del r, graph
    torch.cuda.empty_cache()
print("STEP " + json.dumps(out), flush=True)
"""


def sass_of(lib_path) -> dict:
    """{kernel: its SASS instructions} of every kernel in the library at
    `lib_path` (cuobjdump, beside nvcc), without the per-build hash of each
    source's anonymous namespace and the numbers of its internal
    subroutines in the names and the calls."""
    from spt_tpu_torch.ops import cuda_lib

    exe = Path(cuda_lib.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(exe), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", text)
    out = {}
    for part in re.sub(r"\$__internal_\d+_\$", "$__internal_$", text).split(
            "Function : ")[1:]:
        name, body = part.split("\n", 1)
        # the instructions alone, not the listing's headers after them
        out[name.strip()] = "".join(
            re.findall(r"^\s+/\*[0-9a-f]{4,}\*/.*\n", body, re.M))
    return out


def _short(name: str) -> str:
    """A kernel's mangled name as `name<template argument>`, or as it is."""
    m = re.search(r"\d+([A-Za-z_]+_kernel)(?:IL[ib](\d)E)?", name)
    if not m:
        return name
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def sass_counts(sass: dict) -> dict:
    """Per kernel of SASS_KERNELS in `sass` (sass_of): its instruction count
    and its local loads and stores, branches, special-function (MUFU),
    shared and global instructions."""
    out = {}
    for name, body in sass.items():
        if not any(k in name for k in SASS_KERNELS):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         body)
        base = [o.split(".")[0] for o in ops]
        out[name] = {"instructions": len(ops),
                     **{k: base.count(k) for k in ("LDL", "STL", "BRA", "MUFU",
                                                   "LDS", "LDG", "STG")}}
    return out


def counter_wrappers(torch, cb, modes, names):
    """The q23 and cnt builds' wrappers: cuda_bounce `cb` with a
    fused_bounce that, on the accel modes `modes`, allocates the kernel's
    zeroed counters after the RNG words and a queue, as cb.fused_bounce
    does on the resident form; `names` overrides cb.BOUNCE_KERNELS."""
    from types import SimpleNamespace

    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.ops.vec3 import Vec3

    def fused_bounce(cfg, scene, lights, ps, bounce, is_last):
        if cb._accel_mode(scene) not in modes:
            return cb.fused_bounce(cfg, scene, lights, ps, bounce, is_last)
        dev, n = ps.rng.device, ps.num_paths
        ins, scene_args, keep = cb._kernel_inputs(cfg, scene, lights, ps,
                                                  "fused_bounce")
        outs = [torch.empty(n, dtype=torch.float32, device=dev)
                for _ in range(12)]
        flags = [torch.empty(n, dtype=torch.bool, device=dev)
                 for _ in range(3)]
        rng = torch.empty(n + 3, dtype=torch.int64, device=dev)
        rng[n:].zero_()
        queue = torch.empty(n, dtype=torch.int32, device=dev)
        err = cb.cuda_lib.build().spt_fused_bounce(
            *ins, *(t.data_ptr() for t in outs), rng.data_ptr(),
            *(t.data_ptr() for t in flags), rng[n:].data_ptr(),
            queue.data_ptr(), *scene_args, n, bounce, int(bool(is_last)),
            min(cfg.rr_after, 2 ** 31 - 1), cfg.hit_eps, cfg.ray_offset_dir,
            cfg.firefly_clamp, cb.cuda_lib.stream_of(dev))
        cb.cuda_lib.check(err, "fused_bounce")
        del keep, queue
        return transport.PathState(
            origin=Vec3(*outs[0:3]), direction=Vec3(*outs[3:6]),
            throughput=Vec3(*outs[6:9]), radiance=Vec3(*outs[9:12]),
            rng=rng[:n], alive=flags[0], emission_ok=flags[1]), flags[2]

    names = dict(cb.BOUNCE_KERNELS, **names)
    return SimpleNamespace(fused_bounce=fused_bounce, BOUNCE_KERNELS=names,
                           fused_frame=cb.fused_frame,
                           shared_bytes=cb.shared_bytes)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="",
                    help="NAME:kConst=V[+kConst=V], separated by '/'")
    ap.add_argument("--other", default=None,
                    help="a checkout whose kernels and wrappers to time beside")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--part", choices=("all", "small", "mesh", "bounce",
                                       "sass", "step"),
                    default="all",
                    help="the small forms (K1 small, K2), K1's mesh forms, "
                         "K3 at its calls, or the first two; sass: only the "
                         "builds and, with --sass and --other, every "
                         "kernel's SASS against --other's (exit 1 if any "
                         "differs); step: the captured frame step against "
                         "--other's in processes of their own")
    ap.add_argument("--pairs", type=int, default=1,
                    help="rounds of the mesh frames (and, with --part "
                         "bounce, of K3's calls) through each build, in "
                         "turns forward then backward")
    ap.add_argument("--notrig", action="store_true",
                    help="also time the sampler without its trigonometry "
                         "(wrong results, timed only)")
    ap.add_argument("--queue-grids", action="store_true",
                    help="also time, with --part bounce, a build that runs "
                         "fused_bounce's instanced and stream forms as "
                         "queue kernels")
    ap.add_argument("--edits", default="",
                    help="with --part bounce, also time these edits of the "
                         "small form, comma-separated: " + ", ".join(EDITS))
    ap.add_argument("--sass", default=None,
                    help="a directory to write each build's SASS of the small "
                         "fused_bounce to, with its instruction counts logged")
    ap.add_argument("--small-only", action="store_true",
                    help="with --part bounce, only the small form's calls "
                         "and the compact default frame")
    ap.add_argument("--depth1", action="store_true",
                    help="also time fused_frame on default at depth 1 (bounce 0 "
                         "alone)")
    ap.add_argument("--reps", type=int, default=5,
                    help="with --part step, the timed calls a config")
    ap.add_argument("--configs", default=",".join(STEP_CONFIGS),
                    help="with --part step, the configs, comma-separated")
    args = ap.parse_args()
    if args.part == "step":
        return step_part(args)
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    import sweep_builds
    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.ops import cuda_bounce, cuda_env, cuda_lib
    from spt_tpu_torch.scene import flatten_scene

    if not torch.cuda.is_available():
        print("frame_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    cs.log(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)} [{smi}]")
    made = sweep_builds.Builds(cuda_lib, "frame_sweep", cs.log)

    def note(cl):
        info = cl.kernel_info()
        return "; ".join(f"{k} {info[k]}" for k in info if k.startswith(
            "fused_bounce" if args.part == "bounce" else "fused_frame"))

    made.load("committed", note=note)
    for name, subs in sweep_builds.parse_consts(args.variants):
        made.variant(name, subs, note=note)
    if args.notrig:
        made.variant("notrig", [sweep_builds.literal(*p) for p in NOTRIG])
    if args.queue_grids:
        made.variant("q23", [sweep_builds.literal(*p) for p in QUEUE_GRIDS],
                     note=note)
    for name in filter(None, args.edits.split(",")):
        made.variant(name, [sweep_builds.literal(*p) for p in EDITS[name]],
                     note=note)
    # name -> (cuda_bounce module, cuda_env module, K1 small's kernel name in
    # a trace, cuda_lib module); the builds of this checkout share its
    # wrappers
    builds = {name: (cuda_bounce, cuda_env, cuda_bounce.SMALL_KERNEL, cuda_lib)
              for name in made.libs}
    if args.queue_grids:
        builds["q23"] = (counter_wrappers(
            torch, cuda_bounce, ("instanced", "stream"),
            {"instanced": "fused_bounce_queue_kernel<2>",
             "stream": "fused_bounce_queue_kernel<3>"}),) + builds["q23"][1:]
    if "cnt" in builds:
        builds["cnt"] = (counter_wrappers(torch, cuda_bounce, (None,), {}),
                         ) + builds["cnt"][1:]
    if args.other:
        o = made.load_other(Path(args.other).resolve(),
                            ("cuda_lib", "cuda_bounce", "cuda_env"), note=note)
        builds["other"] = (o["cuda_bounce"], o["cuda_env"],
                           getattr(o["cuda_bounce"], "SMALL_KERNEL",
                                   "fused_frame_kernel<0>"), o["cuda_lib"])
    names = list(builds)
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
        sass = {}
        for v in names:
            lib = (builds[v][3]._LIB if v == "other" else made.libs[v])._name
            sass[v] = sass_of(lib)
            Path(args.sass, f"{v}.sass").write_text("".join(
                f"Function : {k}\n{t}" for k, t in sass[v].items()
                if any(n in k for n in SASS_KERNELS)))
            for k, c in sass_counts(sass[v]).items():
                cs.log(f"SASS of {v} {_short(k)}: {c}")
        if "other" in sass:
            a, b = sass["committed"], sass["other"]
            for k in (k for k in a if k in b and b[k] != a[k]):
                Path(args.sass, f"{_short(k)}.diff").write_text("".join(
                    difflib.unified_diff(b[k].splitlines(True),
                                         a[k].splitlines(True), "other",
                                         "committed", n=2)))
            cs.log("SASS of the committed build against other's, kernel by "
                   "kernel: identical "
                   f"{sorted(_short(k) for k in a if b.get(k) == a[k])}; "
                   "different "
                   f"{sorted(_short(k) for k in a if k in b and b[k] != a[k])}"
                   f"; only in committed {sorted(map(_short, set(a) - set(b)))}"
                   f"; only in other {sorted(map(_short, set(b) - set(a)))}")
            if args.part == "sass":
                # every kernel of other's build is in this one, unchanged; a
                # kernel only this build has is listed above
                return int(any(a.get(k) != b[k] for k in b))
    if args.part == "sass":
        cs.log("frame_sweep: --part sass needs --sass and --other")
        return 2

    def use(name):
        if name in made.libs:
            made.use(name)
        return builds[name]

    def same(a, b):
        a, b = _flat(a), _flat(b)
        return len(a) == len(b) and all(
            x.dtype == y.dtype and cs._same_bits(torch, x, y) for x, y in zip(a, b))

    if args.part == "bounce":
        failed = bounce_part(args, torch, cs, names, use, same, smi)
        cs.log("frame_sweep done")
        return int(failed)
    if args.part in ("all", "mesh"):
        if mesh_part(args, torch, cs, names, use, same, smi):
            return 1
    if args.part == "mesh":
        cs.log("frame_sweep done")
        return 0

    # K1 small from bounce 0 at each config's primary rays
    use("committed")
    hdr_env_call = None
    for name in CONFIGS + (("default_d1",) if args.depth1 else ()):
        desc, cfg, env, lights, cam = cs.workload(name.split("_")[0], cs.W, cs.H,
                                                  dev)
        if name == "default_d1":
            cfg = cfg.replace(max_depth=1)
        scene = flatten_scene(desc, dev)
        ps = transport.gen_primary(cfg, cam.rays(dev), 0)
        outs = {}
        for v in names:
            b = use(v)[0]
            outs[v] = b.fused_frame(cfg, scene, lights, ps)
        torch.cuda.synchronize()
        off = [v for v in names if not same(outs[v], outs["committed"])]
        rays = outs["committed"][4].tolist()
        cs.log(f"{name} {cs.W}x{cs.H} d{cfg.max_depth}: rays_per_bounce {rays}; "
               f"builds not bit-equal to the committed one: {off or 'none'}")
        if off:
            return 1
        kern, wrap = {v: [] for v in names}, {v: [] for v in names}
        for v in names + names[::-1]:
            b, _, kname, _ = use(v)
            call = lambda: b.fused_frame(cfg, scene, lights, ps)
            kern[v].append(cs.kernel_device_ms(torch, call, kname, iters=10))
            wrap[v].append(cs.time_call(torch, call, warmup=3, iters=20))
        cs.log(f"{name} fused_frame small, kernel ms per launch forward/backward: "
               + ", ".join(f"{v} {t[0]:.4f}/{t[1]:.4f}" for v, t in kern.items())
               + "; wrapper ms per call: "
               + ", ".join(f"{v} {t[0]:.4f}/{t[1]:.4f}" for v, t in wrap.items())
               + f" [{smi}]")
        if name == "hdr":
            use("committed")
            r = cs.renderer("hdr", cs.W, cs.H, dev)
            with cs.capture_calls([(cuda_env, "env_sample")]) as calls:
                r.render_frames(1)
                torch.cuda.synchronize()
            (_, hdr_env_call, kw), = calls
            if kw:
                raise RuntimeError(f"env_sample called with keywords {kw}")

    # K2 at the hdr frame's call; a wrapper from before the texel layout
    # reads the map as a contiguous (H, W, 3) tensor, made here once
    env, *rest = hdr_env_call
    flat_call = (env._replace(image=env.image.contiguous()), *rest)
    calls = {v: hdr_env_call if hasattr(builds[v][1], "has_texel_layout")
             else flat_call for v in names}
    outs = {}
    for v in names:
        e = use(v)[1]
        outs[v] = tuple(e.env_sample(*calls[v]))
    torch.cuda.synchronize()
    ok = all(same(outs[v], outs["committed"]) for v in names
             if v not in TIMED_ONLY)
    ms = {v: [] for v in names}
    for v in names + names[::-1]:
        e = use(v)[1]
        ms[v].append(cs.queued_device_ms(torch, lambda: e.env_sample(*calls[v])))
    need = hdr_env_call[2]
    cs.log(f"hdr env_sample ({need.shape[0]} lanes, {int(need.sum())} need the "
           f"term): every build but notrig bit-equal {ok}; device ms per call "
           "forward/backward: "
           + ", ".join(f"{v} {t[0]:.4f}/{t[1]:.4f}" for v, t in ms.items())
           + f" [{smi}]")
    if not ok:
        return 1

    # the main path: default 1920x1080 d6 through each build's wrappers
    saved = cuda_bounce.fused_frame
    try:
        for v in names + names[::-1]:
            b = use(v)[0]
            cuda_bounce.fused_frame = saved if b is cuda_bounce else b.fused_frame
            r = cs.renderer("default", cs.W, cs.H, dev)
            r.render_frames(2)
            ms_f = cs.time_call(torch, lambda: r.render_frames(1), warmup=0,
                                iters=args.frames)
            busy, launches = cs.device_busy_ms(torch, lambda: r.render_frames(1))
            cs.log(f"default {cs.W}x{cs.H} d6 frame with the {v} build: "
                   f"{ms_f:.4f} ms/frame over {args.frames} frames, device busy "
                   f"{busy:.4f} ms/frame over {launches:.1f} launches (profiled) "
                   f"[{smi}]")
    finally:
        cuda_bounce.fused_frame = saved
    cs.log("frame_sweep done")
    return 0


# The mesh scenes: (label, chip_smoke renderer, accel mode, K1's kernel name)
MESH = (("mesh", "mesh_renderer", "resident", "fused_frame_kernel<1>"),
        ("instanced grid", "inst_renderer", "instanced", "fused_frame_kernel<2>"),
        ("baked grid", "stream_renderer", "stream", "fused_frame_kernel<3>"))


def _step_run(root, configs, frames: int, reps: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", STEP_CHILD, ",".join(configs),
                           str(frames), str(reps)], cwd=root,
                          capture_output=True, text=True, timeout=900)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("STEP ")), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"the run in {root} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return json.loads(line[5:])


def step_part(args) -> int:
    """--part step: the captured step of this checkout and --other's in
    turns, each run a process of its own."""
    import torch

    if not torch.cuda.is_available():
        print("frame_sweep: no CUDA device", file=sys.stderr)
        return 2
    if not args.other:
        print("frame_sweep: --part step needs --other", file=sys.stderr)
        return 2
    configs = args.configs.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    other = str(Path(args.other).resolve())
    order = [("other", other), ("this", str(HERE)), ("this", str(HERE)),
             ("other", other)]
    runs = {"this": [], "other": []}
    for _ in range(args.pairs):
        for label, root in order:
            out = _step_run(root, configs, args.frames, args.reps)
            runs[label].append(out)
            print(f"frame_sweep step {label}: " + "; ".join(
                f"{k} {statistics.median(v['ms']):.4f} ({min(v['ms']):.4f}-"
                f"{max(v['ms']):.4f}) ms/frame, {v['graphs']:.2f} graphs"
                for k, v in out.items()) + f" [{smi}]", flush=True)
    for name in configs:
        med = {label: [statistics.median(o[name]["ms"]) for o in outs]
               for label, outs in runs.items()}
        graphs = {label: outs[0][name]["graphs"]
                  for label, outs in runs.items()}
        same = len({o[name]["accum"] for outs in runs.values()
                    for o in outs}) == 1
        print(f"frame_sweep step {name}: this "
              f"{statistics.median(med['this']):.4f} ({min(med['this']):.4f}-"
              f"{max(med['this']):.4f}), other "
              f"{statistics.median(med['other']):.4f} "
              f"({min(med['other']):.4f}-{max(med['other']):.4f}) ms/frame "
              f"over {len(med['this'])} processes each; graph launches a "
              f"frame this {graphs['this']:.2f}, other "
              f"{graphs['other']:.2f}; the accumulation after the last call "
              f"{'bit for bit' if same else 'differs'} across every process "
              f"[{smi}]", flush=True)
    return 0


def mesh_part(args, torch, cs, names, use, same, smi) -> bool:
    """K1's mesh forms at the sorted frame's call and from bounce 0, then
    the frames, sorted and unsorted, through each build (see the module
    docstring).  Returns whether a build's outputs differed."""
    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.ops import cuda_bounce

    dev = torch.device("cuda", 0)
    for label, make, mode, kname in MESH:
        use("committed")
        r = getattr(cs, make)(dev)
        if cuda_bounce._accel_mode(r.scene) != mode:
            raise RuntimeError(f"{label} in accel mode "
                               f"{cuda_bounce._accel_mode(r.scene)}, not {mode}")
        with cs.capture_calls([(cuda_bounce, "fused_frame")]) as calls:
            r.render_frames(1)
            torch.cuda.synchronize()
        (_, sorted_args, sorted_kw), = calls
        cfg, scene, lights = sorted_args[:3]
        ps0 = transport.gen_primary(cfg, r.camera.rays(dev), 0)
        inputs = {"sorted frame's call": (sorted_args, sorted_kw),
                  "bounce 0": ((cfg, scene, lights, ps0), {})}
        for what, (a, kw) in inputs.items():
            outs = {}
            for v in names:
                outs[v] = use(v)[0].fused_frame(*a, **kw)
            torch.cuda.synchronize()
            off = [v for v in names if not same(outs[v], outs["committed"])]
            ps = a[3]
            cs.log(f"{label} K1 {mode} at the {what} (from bounce "
                   f"{kw.get('start_bounce', 0)}, {ps.num_paths} lanes, "
                   f"{int(ps.alive.sum())} alive): rays_per_bounce "
                   f"{outs['committed'][4].tolist()}; builds not bit-equal to "
                   f"the committed one: {off or 'none'}")
            if off:
                return True
            ms = {v: [] for v in names}
            for v in names + names[::-1]:
                b = use(v)[0]
                ms[v].append(cs.kernel_device_ms(
                    torch, lambda: b.fused_frame(*a, **kw), kname, iters=10))
            cs.log(f"{label} K1 {mode} at the {what}, kernel ms per launch "
                   "forward/backward: " + ", ".join(
                       f"{v} {t[0]:.4f}/{t[1]:.4f}" for v, t in ms.items())
                   + f" [{smi}]")
        occ = []
        for v in names:
            b, _, _, cl = use(v)
            smem = b.shared_bytes(cfg, scene, lights)
            info = cl.kernel_info({f"fused_frame_{mode}": smem})
            occ.append(f"{v} {info[f'fused_frame_{mode}']}")
        cs.log(f"{label} K1 {mode} occupancy: " + "; ".join(occ) + f" [{smi}]")
        frame_builds = [v for v in names if v in ("committed", "other")]
        if frames_with_each_build(args, torch, cs, frame_builds, use, smi,
                                  label, make):
            return True
    return False


def frames_with_each_build(args, torch, cs, names, use, smi, label,
                           make, fn="fused_frame",
                           routes=(("sorted", {}),
                                   ("unsorted", {"ray_sort": False}))) -> bool:
    """The scene's frame on each route through each build's wrapper `fn`
    (fused_frame or fused_bounce): images against the committed build's,
    ms/frame, busy and launches.  Returns whether an image differed."""
    from spt_tpu_torch.ops import cuda_bounce

    dev = torch.device("cuda", 0)
    saved = getattr(cuda_bounce, fn)
    try:
        for route, kw in routes:
            images, times = {}, {v: [] for v in names}
            for v in (names + names[::-1]) * args.pairs:
                b = use(v)[0]
                setattr(cuda_bounce, fn,
                        saved if b is cuda_bounce else getattr(b, fn))
                r = getattr(cs, make)(dev, **kw)
                r.render_frames(4)
                img = r.hdr_image()
                images.setdefault(v, img)
                ms_f = cs.time_call(torch, lambda: r.render_frames(1),
                                    warmup=1, iters=args.frames)
                times[v].append(ms_f)
                busy, launches = cs.device_busy_ms(torch,
                                                   lambda: r.render_frames(1))
                cs.log(f"{label} 512x384 d4 {route} frame with the {v} "
                       f"build's {fn}: "
                       f"{ms_f:.4f} ms/frame over {args.frames} frames, device "
                       f"busy {busy:.4f} ms/frame over {launches:.1f} launches "
                       f"(profiled) [{smi}]")
            cs.log(f"{label} 512x384 d4 {route} ms/frame over "
                   f"{2 * args.pairs} runs a build, median (min-max): "
                   + ", ".join(f"{v} {statistics.median(t):.4f} "
                               f"({min(t):.4f}-{max(t):.4f})"
                               for v, t in times.items()) + f" [{smi}]")
            ref = images["committed"]
            off = [v for v in names
                   if images[v].tobytes() != ref.tobytes()]
            cs.log(f"{label} {route}: 4-frame images not bit-equal to the "
                   f"committed build's: {off or 'none'}")
            if off:
                return True
    finally:
        setattr(cuda_bounce, fn, saved)
    return False


# fused_bounce's kernels by accel mode in a checkout from before their
# names were kept in cuda_bounce.BOUNCE_KERNELS.
BOUNCE_FORMS = {None: 0, "resident": 1, "instanced": 2, "stream": 3}


def bounce_kernel(b, mode) -> str:
    """The profiler name of fused_bounce's form `mode` in the build whose
    wrapper module is `b`."""
    names = getattr(b, "BOUNCE_KERNELS", None)
    return (names[mode] if names else
            f"fused_bounce_kernel<{BOUNCE_FORMS[mode]}>")


def _flat(x):
    """The tensors of a (nested) tuple of them, in order."""
    if isinstance(x, tuple):
        return [t for y in x for t in _flat(y)]
    return [x]


def bounce_part(args, torch, cs, names, use, same, smi) -> bool:
    """K3 (fused_bounce) through each build, per call: at the compact
    path's bounce-0 call on the three small configs at 1920x1080, then,
    unless --small-only, at each of the sorted frame's calls on the three
    mesh scenes, at the compact path's bounce-0 call on the mesh scene and
    at each call of band 0 of a 2-band mesh frame; the lanes and live lanes
    of each call, the builds' results bit for bit, device ms per launch
    (torch.profiler) over --pairs rounds of the builds in turns, and each
    build's K3 registers, spill and blocks per SM; then each mesh scene's
    sorted frame through each build's fused_bounce (images bit for bit,
    ms/frame, busy, launches) and the device busy time and launches of the
    compact path's default 1920x1080 d6 frame through every build.
    Returns whether a build's results differed."""
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.env import make_procedural_environment
    from spt_tpu_torch.lights import default_lights
    from spt_tpu_torch.ops import cuda_bounce
    from spt_tpu_torch.parallel import sharding
    from spt_tpu_torch.scene import flatten_scene

    dev = torch.device("cuda", 0)

    def calls_of(fn):
        use("committed")
        with cs.capture_calls([(cuda_bounce, "fused_bounce")]) as calls:
            fn()
            torch.cuda.synchronize()
        return [(a, k) for _, a, k in calls]

    sets = []
    for name in CONFIGS:
        sets.append((f"{name} {cs.W}x{cs.H} compact frame", None, calls_of(
            lambda: cs.renderer(name, cs.W, cs.H, dev,
                                integrator="compact").render_frames(1))))
    for label, make, mode, _ in () if args.small_only else MESH:
        sets.append((f"{label} sorted frame", mode,
                     calls_of(lambda: getattr(cs, make)(dev).render_frames(1))))
    if not args.small_only:
        sets.append(("mesh compact frame", "resident", calls_of(
            lambda: cs.mesh_renderer(dev,
                                     integrator="compact").render_frames(1))))
        desc, cfg, cam = cs.port_mesh_scene()
        band = (cfg, flatten_scene(desc, dev), make_procedural_environment(dev),
                default_lights(dev), cam.rays(dev))
        sets.append(("mesh band 0 of 2", "resident", calls_of(
            lambda: sharding.shard_frames(
                *band, state_mod.init_state(cfg.num_pixels // 2, dev), 1, 0,
                2))))

    for what, mode, calls in sets:
        for a, kw in calls:
            ps, bounce = a[3], a[4]
            outs = {v: use(v)[0].fused_bounce(*a, **kw) for v in names}
            torch.cuda.synchronize()
            off = [v for v in names if v not in TIMED_ONLY
                   and not same(outs[v], outs["committed"])]
            ms = {v: [] for v in names}
            for v in (names + names[::-1]) * args.pairs:
                b = use(v)[0]
                ms[v].append(cs.kernel_device_ms(
                    torch, lambda: b.fused_bounce(*a, **kw),
                    bounce_kernel(b, mode), iters=10))
            cs.log(f"{what} K3 {mode} bounce {bounce} ({ps.num_paths} lanes, "
                   f"{int(ps.alive.sum())} alive): builds not bit-equal to the "
                   f"committed one: {off or 'none'}; kernel ms per launch over "
                   f"{2 * args.pairs} runs a build in turns, median (min-max): "
                   + ", ".join(f"{v} {statistics.median(t):.4f} "
                               f"({min(t):.4f}-{max(t):.4f})"
                               for v, t in ms.items()) + f" [{smi}]")
            if off:
                return True
        a = calls[0][0]
        key = "fused_bounce" if mode is None else f"fused_bounce_{mode}"
        occ = []
        for v in names:
            b, _, _, cl = use(v)
            info = cl.kernel_info({key: b.shared_bytes(*a[:3])})
            occ.append(f"{v} {info[key]}")
        cs.log(f"{what} K3 {mode} occupancy: " + "; ".join(occ) + f" [{smi}]")

    frame_builds = [v for v in names if v in ("committed", "other")]
    for label, make, _, _ in () if args.small_only else MESH:
        if frames_with_each_build(args, torch, cs, frame_builds, use, smi,
                                  label, make, fn="fused_bounce",
                                  routes=(("sorted", {}),)):
            return True
    saved = cuda_bounce.fused_bounce
    try:
        for v in (v for v in names if v not in TIMED_ONLY):
            b = use(v)[0]
            cuda_bounce.fused_bounce = (saved if b is cuda_bounce
                                        else b.fused_bounce)
            r = cs.renderer("default", cs.W, cs.H, dev, integrator="compact")
            busy, launches = cs.device_busy_ms(torch, lambda: r.render_frames(1),
                                               iters=1)
            cs.log(f"default {cs.W}x{cs.H} d6 compact frame with the {v} "
                   f"build's fused_bounce: device busy {busy:.4f} ms over "
                   f"{launches:.1f} launches (profiled) [{smi}]")
    finally:
        cuda_bounce.fused_bounce = saved
    return False


if __name__ == "__main__":
    sys.exit(main())
