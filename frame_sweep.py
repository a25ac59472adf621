#!/usr/bin/env python3
"""Time the small-scene fused_frame (K1 small) and the equirect sampler (K2)
on one CUDA card, beside variants of K1 small and another checkout's
kernels.

    python3 frame_sweep.py [--variants NAME:kConst=V[+kConst=V]/...]
                           [--other DIR] [--frames 16]

Builds the port's kernels as committed and, for each variant, with the
named ``constexpr int`` constants of ``spt_tpu_torch/csrc`` (each defined
once in one source) set to the values given
(``--variants b256:kSmallBlock=256/r8:kRefillMin=8``).
With ``--other``, it also loads ``DIR``'s kernels through ``DIR``'s own
wrappers (``DIR/spt_tpu_torch/ops/cuda_lib.py``, ``cuda_bounce.py`` and
``cuda_env.py``; another commit's checkout, e.g. ``git archive`` of the
parent unpacked in an ignored directory), so a kernel whose C interface
changed is timed beside its predecessor.  On the three small-scene configs
at 1920x1080 (``chip_smoke.workload``: default depth 6, cornell depth 8, hdr
depth 6, from bounce 0 of sample 0's primary rays) and at the hdr frame's
``env_sample`` call it holds every build's outputs to the committed
build's, bit for bit, and times every build in turns, forward then backward:
fused_frame's kernel by torch.profiler device time per launch and its
wrapper by CUDA events around whole calls, env_sample by CUDA events behind
a spin kernel.  Last, each build's wrappers render default 1920x1080 depth
6 through ``Renderer.render_frames``: ms/frame (CUDA events) and device
launches per frame (torch.profiler).  Needs ``nvcc`` and one card; prints
the card's name and power limit with every time.  ``--depth1`` adds
default at depth 1 (bounce 0 alone) to the fused_frame timings;
``--notrig`` adds a build of the sampler with its atan2f and acosf replaced
by a subtraction, timed only, for what the exact trigonometry costs.  The
builds are made by ``sweep_builds.py``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CONFIGS = ("default", "cornell", "hdr")
# Timed only, its results not held to the committed build's: the sampler
# with atan2f / acosf replaced by a subtraction, for what the exact
# trigonometry costs.
NOTRIG = (("atan2f(d.z, d.x)", "(d.z - d.x)"),
          ("acosf(fminf(fmaxf(d.y, -1.0f), 1.0f))", "(1.0f - d.y)"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="",
                    help="NAME:kConst=V[+kConst=V], separated by '/'")
    ap.add_argument("--other", default=None,
                    help="a checkout whose kernels and wrappers to time beside")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--notrig", action="store_true",
                    help="also time the sampler without its trigonometry "
                         "(wrong results, timed only)")
    ap.add_argument("--depth1", action="store_true",
                    help="also time fused_frame on default at depth 1 (bounce 0 "
                         "alone)")
    args = ap.parse_args()
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
        return f"K1 small {cl.kernel_info()['fused_frame']}"

    made.load("committed", note=note)
    for name, subs in sweep_builds.parse_consts(args.variants):
        made.variant(name, subs, note=note)
    if args.notrig:
        made.variant("notrig", [sweep_builds.literal(*p) for p in NOTRIG])
    # name -> (cuda_bounce module, cuda_env module, K1 small's kernel name in
    # a trace); the builds of this checkout share its wrappers
    builds = {name: (cuda_bounce, cuda_env, cuda_bounce.SMALL_KERNEL)
              for name in made.libs}
    if args.other:
        o = made.load_other(Path(args.other).resolve(),
                            ("cuda_lib", "cuda_bounce", "cuda_env"), note=note)
        builds["other"] = (o["cuda_bounce"], o["cuda_env"],
                           getattr(o["cuda_bounce"], "SMALL_KERNEL",
                                   "fused_frame_kernel<0>"))
    names = list(builds)

    def use(name):
        if name in made.libs:
            made.use(name)
        return builds[name]

    def same(a, b):
        a = [t for x in a for t in (x if isinstance(x, tuple) else (x,))]
        b = [t for x in b for t in (x if isinstance(x, tuple) else (x,))]
        return len(a) == len(b) and all(
            x.dtype == y.dtype and cs._same_bits(torch, x, y) for x, y in zip(a, b))

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
            b, _, _ = use(v)
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
            b, _, kname = use(v)
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
        _, e, _ = use(v)
        outs[v] = tuple(e.env_sample(*calls[v]))
    torch.cuda.synchronize()
    ok = all(same(outs[v], outs["committed"]) for v in names if v != "notrig")
    ms = {v: [] for v in names}
    for v in names + names[::-1]:
        _, e, _ = use(v)
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
            b, _, _ = use(v)
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


if __name__ == "__main__":
    sys.exit(main())
