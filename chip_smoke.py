#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and a checkout of this repository around
this file; exits non-zero (printing no result) without them.  Phases:

0. build the ``fused_frame`` CUDA kernel from ``spt_tpu_torch/csrc``;
1. kernel vs plain PyTorch version on the card, from the same primary
   rays: default scene 1920x1080 depth 6 and Cornell 512x512 depth 8; the
   kernel's device time (torch.profiler) and the plain version's time;
2. the main path: ``Renderer.render_frames(8)`` on default 1920x1080
   depth 6, Cornell (NEE) and HDR glass with a 1024x2048 synthetic map,
   with the kernel's launch count reset before and read after;
3. the kernel's image against the plain path's image at 320x240, 8 frames;
4. times: ms/frame and Mrays/s of the kernel path and of the plain path on
   the card at 1920x1080 depth 6, with CUDA events after a warm-up.

PNGs go to ``build/chip_smoke/`` beside this file.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernel.
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


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_path(cuda_bounce):
    """Route the wavefront's depth loop through the plain PyTorch version
    on the card (for comparison and timing only)."""
    kernel = cuda_bounce.fused_frame
    cuda_bounce.fused_frame = cuda_bounce.fused_frame_reference
    try:
        yield
    finally:
        cuda_bounce.fused_frame = kernel


def workload(name, width, height, dev):
    """(SceneDesc, RenderConfig, env, lights, Camera) of a BASELINE config
    as the JAX package's bench.py builds it (the .hdr file round trip of its
    hdr config is skipped: the map is used as generated)."""
    from spt_tpu_torch.camera import Camera, default_camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.env import make_hdr_environment, synthetic_equirect
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
        env = make_hdr_environment(synthetic_equirect(1024), dev)
        return build_hdr_glass_scene(), cfg, env, lm.device(dev), cam
    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=6)
    return (build_default_scene(), cfg, None, default_lights(dev),
            default_camera(width, height))


def renderer(name, width, height, dev):
    from spt_tpu_torch.engine.renderer import Renderer

    desc, cfg, env, lights, cam = workload(name, width, height, dev)
    return Renderer(desc, cfg, env=env, lights=lights, camera=cam, device=dev)


def phase_kernel_vs_plain(torch, cuda_bounce, dev, smi):
    """Phase 1.  Returns the default-scene numbers for the kernel line."""
    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.scene import flatten_scene

    result = {}
    for name, width, height in (("default", W, H), ("cornell", 512, 512)):
        desc, cfg, _, lights, cam = workload(name, width, height, dev)
        scene = flatten_scene(desc, dev)
        ps = transport.gen_primary(cfg, cam.rays(dev), 0)
        k = cuda_bounce.fused_frame(cfg, scene, lights, ps)
        p = cuda_bounce.fused_frame_reference(cfg, scene, lights, ps)
        torch.cuda.synchronize()
        dk = torch.stack([*k[0]], -1) - torch.stack([*p[0]], -1)
        err = dk.abs().amax(-1)
        bad = float((err > 1e-3).float().mean())
        max_abs = float(err.max())
        rk, rp = k[4].cpu().numpy(), p[4].cpu().numpy()
        ray_diff = float((abs(rk - rp) / rp.clip(min=1)).max())
        miss_diff = float((k[3] != p[3]).float().mean())
        log(f"phase 1 {name} {width}x{height} d{cfg.max_depth}: lanes with "
            f"|d radiance| > 1e-3: {bad * 100:.4f} % (limit 0.1 %), "
            f"max |d| {max_abs:.6g}, rays_per_bounce kernel {rk.tolist()} "
            f"plain {rp.tolist()} (max rel diff {ray_diff * 100:.4f} %, "
            f"limit 0.1 %), missed_ever differs on {miss_diff * 100:.4f} %")
        if not (bad <= 1e-3 and ray_diff <= 1e-3):
            raise AssertionError(f"kernel disagrees with the plain version "
                                 f"on {name}")
        if name == "default":
            result["max_abs_err"] = max_abs
            # times at the main path's shape: the kernel's own device time,
            # the wrapper's (table packing and ray counts included) and the
            # plain version's
            call = lambda: cuda_bounce.fused_frame(cfg, scene, lights, ps)
            wrapper_ms = time_call(torch, call, warmup=3, iters=20)
            result["ms"] = kernel_device_ms(torch, call, "fused_frame_kernel")
            result["plain_ms"] = time_call(
                torch, lambda: cuda_bounce.fused_frame_reference(
                    cfg, scene, lights, ps), warmup=1, iters=3)
            log(f"phase 1 fused_frame at {width}x{height} d{cfg.max_depth}: "
                f"kernel {result['ms']:.4f} ms (device time), wrapper "
                f"{wrapper_ms:.4f} ms, plain {result['plain_ms']:.4f} ms per "
                f"call [{smi}]")
    return result


def kernel_device_ms(torch, fn, kernel_name: str, iters: int = 10) -> float:
    """Mean device time of the named kernel per call of `fn`, read from a
    torch.profiler trace of `iters` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel_name in e.key]
    total = sum(e.self_device_time_total for e in events)
    count = sum(e.count for e in events)
    if count != iters or total <= 0:
        raise AssertionError(f"profiler saw {count} launches of {kernel_name} "
                             f"with {total} us of device time, expected {iters}")
    return total / count / 1e3


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


def phase_main_path(torch, np, cuda_bounce, dev, out_dir):
    """Phase 2: the Renderer on the card; returns the launch count."""
    frames = 8
    renderers = {name: renderer(name, W, H, dev)
                 for name in ("default", "cornell", "hdr")}
    torch.cuda.synchronize()
    cuda_bounce.LAUNCHES = 0
    for name, r in renderers.items():
        before = cuda_bounce.LAUNCHES
        r.render_frames(frames)
        torch.cuda.synchronize()
        grew = cuda_bounce.LAUNCHES - before
        rays, path = check_image(np, r, name, out_dir, frames)
        log(f"phase 2 {name} {W}x{H} d{r.cfg.max_depth}: {frames} frames, "
            f"LAUNCHES +{grew}, rays_per_bounce {rays.tolist()}, "
            f"mean hdr {float(r.hdr_image().mean()):.6g}, png {path}")
        if grew != frames:
            raise AssertionError(f"{name}: LAUNCHES grew by {grew}, "
                                 f"expected {frames}")
    launches = cuda_bounce.LAUNCHES
    if launches == 0:
        raise AssertionError("the main path launched no kernel")
    return launches


def phase_image_vs_plain(torch, np, cuda_bounce, dev):
    """Phase 3: kernel image vs plain image, 8 frames at 320x240."""
    for name in ("default", "cornell", "hdr"):
        a = renderer(name, 320, 240, dev)
        a.render_frames(8)
        b = renderer(name, 320, 240, dev)
        with plain_path(cuda_bounce):
            b.render_frames(8)
        ha, hb = a.hdr_image(), b.hdr_image()
        rel = float(np.sqrt(np.mean((ha - hb) ** 2)) / np.sqrt(np.mean(hb ** 2)))
        log(f"phase 3 {name} 320x240 8 frames: kernel vs plain relative "
            f"RMSE {rel * 100:.5f} % (limit 1 %)")
        if not rel < 0.01:
            raise AssertionError(f"{name}: kernel image differs from plain")


def phase_times(torch, cuda_bounce, dev, smi):
    """Phase 4: end-to-end ms/frame and Mrays/s, kernel and plain path."""
    from spt_tpu_torch.bench import count_rays, shadow_rays_per_surface_lane

    out = {}
    for label, frames, ctx in (("kernel", 32, contextlib.nullcontext),
                               ("plain", 3, lambda: plain_path(cuda_bounce))):
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
        log(f"phase 4 {label} path, default {W}x{H} d6, {frames} frames: "
            f"{ms:.4f} ms/frame, {mrays:.2f} Mrays/s [{smi}]")
    return out


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
        from spt_tpu_torch.ops import cuda_bounce
    except ImportError as e:
        print(f"chip_smoke: the spt_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    smi = smi_line()
    nvcc = subprocess.run([cuda_bounce._nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}")
    log("nvcc: " + " | ".join(nvcc.stdout.strip().splitlines()[-2:]))
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    cuda_bounce.build()
    log(f"phase 0 build fused_frame: {time.perf_counter() - t0:.2f} s, "
        f"{cuda_bounce.kernel_info()}")

    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)

    k = phase_kernel_vs_plain(torch, cuda_bounce, dev, smi)
    launches = phase_main_path(torch, np, cuda_bounce, dev, out_dir)
    phase_image_vs_plain(torch, np, cuda_bounce, dev)
    phase_times(torch, cuda_bounce, dev, smi)

    for v in k.values():
        if not math.isfinite(v):
            raise AssertionError(f"non-finite kernel measurement {k}")
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_frame",
        "route": "cuda",
        "source": "spt_tpu_torch/csrc/fused_frame.cu",
        "replaces": "spt_tpu/ops/pallas_bounce.py:1090",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
