"""Benchmark entry of the PyTorch port: Mrays/s of one config on the card.

    python -m spt_tpu_torch.bench [--scene NAME] [--quick] [--iters N] [--all]

The counterpart of the repo's ``bench.py`` (bench.py:65-292): the same
configs (``default``, ``cornell``, ``hdr``, ``gltf``, ``bigmesh``,
``stream`` and the animated ``anim``), resolutions and chain lengths.  It
warms up with the chain length it times, times three chains with one
device sync each and prints one JSON line with the median:

  {"metric": "...", "value": Mrays/s, "unit": "Mrays/s", "vs_baseline": x,
   "ms_per_frame": t, "spp": s, "max_depth": d, "device": "..."}

(plus ``tier`` on bigmesh and stream).  Rays are counted with the JAX
package's convention (``count_rays``, copied from bench.py:31-62, not
imported, so that a Mrays/s figure of the port means what the JAX
package's figure means).  ``vs_baseline`` is the value over the repo's
target ``TARGET_MRAYS``, a constant and not a measurement.  ``--all`` runs
every config in its own subprocess and prints a ``FAILED_<scene>`` line
for one that fails.  The gltf, bigmesh and stream configs need the chair
asset (``scene.builder.CHAIR_GLTF``) and fail, naming its path, without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TARGET_MRAYS = 100.0  # the repo's target (BASELINE.json: ">=100 Mrays/sec/chip")
SCENES = ("default", "cornell", "gltf", "hdr", "anim", "bigmesh", "stream")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shadow_rays_per_surface_lane(renderer) -> int:
    """Occlusion rays traced per surface-hit lane per bounce: one per active
    analytic light (KIND_NONE padding rows trace nothing) plus one for NEE
    when the scene has emitters."""
    cfg = renderer.cfg
    if not cfg.shadow_rays:
        return 0
    kinds = renderer.lights.kind.cpu().numpy().reshape(-1)
    n_lights = int((kinds != 0).sum())
    nee = int(cfg.nee and renderer.scene.emitters is not None)
    return n_lights + nee


def count_rays(stats, n_shadow: int) -> int:
    """Rays traced: per-bounce live lanes + shadow rays.  Live lanes at
    bounce b > 0 all hit a surface at bounce b-1 and traced `n_shadow`
    occlusion rays there; terminated lanes are assumed to have missed, so
    the count is a lower bound."""
    rays = np.asarray(stats.rays_per_bounce.cpu(), np.int64)
    primary_and_bounce = int(rays.sum())
    if n_shadow > 0 and rays.size > 1:
        shadow = int(rays[1:].sum()) * n_shadow
    else:
        shadow = 0
    return primary_and_bounce + shadow


def _hdr_map() -> str:
    """The hdr config's map as bench.py:79-94 makes it: the 1024x2048
    synthetic sun-sky written once as a Radiance .hdr file, here under
    build/spt_tpu_torch/bench/ in the checkout."""
    from spt_tpu_torch.env import synthetic_equirect
    from spt_tpu_torch.io.hdr import write_hdr

    path = os.path.join(REPO, "build", "spt_tpu_torch", "bench",
                        "spt_bench_sunsky_1024.hdr")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        write_hdr(tmp, synthetic_equirect(1024))
        os.replace(tmp, path)
    return path


def _grid_renderer(build, width, height, device):
    from spt_tpu_torch.camera import Camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.engine.renderer import Renderer

    desc, center, radius = build()
    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=4)
    cam = Camera(position=tuple(center + np.array([0.3, 0.35, 1.0]) * radius),
                 target=tuple(center), fov_degrees=45.0,
                 aspect_ratio=width / height)
    return Renderer(desc, cfg, camera=cam, device=device)


def build_workload(scene_name: str, width: int, height: int, device="cuda"):
    """The Renderer of a BASELINE config (bench.py:65-153): default,
    cornell, hdr, gltf, bigmesh and stream; `anim` is built by main."""
    from spt_tpu_torch.camera import Camera, default_camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.engine.renderer import Renderer, render_device
    from spt_tpu_torch import scene as scenes

    device = render_device(device)
    if scene_name == "hdr":
        from spt_tpu_torch.env import load_environment
        from spt_tpu_torch.lights import LightManager

        lm = LightManager()
        lm.add_directional_light((0.4, -1.0, -0.3), (1.0, 0.95, 0.9), 1.0)
        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=6)
        cam = Camera(position=(0, 2.0, 6.0), target=(0, 1.0, 0.0),
                     fov_degrees=50.0, aspect_ratio=width / height)
        return Renderer(scenes.build_hdr_glass_scene(), cfg,
                        env=load_environment(_hdr_map(), device),
                        lights=lm.device(device), camera=cam, device=device)
    if scene_name == "cornell":
        from spt_tpu_torch.lights import LightManager

        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=8)
        cam = Camera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                     fov_degrees=50.0, aspect_ratio=width / height)
        return Renderer(scenes.build_cornell_box_scene(), cfg,
                        lights=LightManager().device(device), camera=cam,
                        device=device)
    if scene_name == "bigmesh":
        # a 4x4 grid of the chair, instanced (TLAS/BLAS, the instanced tier)
        return _grid_renderer(scenes.build_chair_grid_scene, width, height,
                              device)
    if scene_name == "stream":
        # the same grid baked to unique meshes (the stream tier)
        return _grid_renderer(scenes.build_unique_grid_scene, width, height,
                              device)
    if scene_name == "gltf":
        from spt_tpu_torch.io.gltf import bounding_box, load_gltf
        from spt_tpu_torch.scene.builder import chair_path

        desc = load_gltf(chair_path())
        lo, hi = bounding_box(desc)
        center = (lo + hi) / 2
        extent = float(np.linalg.norm(hi - lo))
        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=4)
        cam = Camera(position=center + np.array([0.0, 0.35, 1.1]) * extent,
                     target=center, fov_degrees=60.0,
                     aspect_ratio=width / height)
        return Renderer(desc, cfg, camera=cam, device=device)
    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=6)
    return Renderer(scenes.build_default_scene(), cfg,
                    camera=default_camera(width, height), device=device)


def run_all() -> None:
    """One JSON line per config, each in its own subprocess."""
    for scene in SCENES:
        cmd = [sys.executable, "-m", "spt_tpu_torch.bench", "--scene", scene]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=900, cwd=REPO)
        except subprocess.TimeoutExpired:
            print(json.dumps({"metric": f"FAILED_{scene}",
                              "stderr": "timeout after 900 s"}), flush=True)
            continue
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        print(lines[-1] if out.returncode == 0 and lines else
              json.dumps({"metric": f"FAILED_{scene}",
                          "stderr": out.stderr[-500:]}), flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spt_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--scene", choices=SCENES, default="default")
    p.add_argument("--quick", action="store_true",
                   help="640x480 and 8-frame chains")
    p.add_argument("--iters", type=int,
                   help="frames per timed chain (default 128; 32 on bigmesh, "
                        "16 on stream)")
    p.add_argument("--all", action="store_true",
                   help="every config, one subprocess each")
    return p


def main(argv=None, device="cuda") -> int:
    import torch

    from spt_tpu_torch.engine.renderer import Renderer, render_device

    args = build_parser().parse_args(argv)
    if args.all:
        run_all()
        return 0
    device = render_device(device)
    scene_name = args.scene
    width, height, iters = 1920, 1080, 128
    warmup = 2
    if args.quick:
        width, height, iters = 640, 480, 8
    if scene_name == "gltf":
        width, height = 512, 384
    if scene_name in ("bigmesh", "stream"):
        width, height, iters = 512, 384, 32
    if scene_name == "stream":
        iters = 16
    if args.iters is not None:
        iters = args.iters

    # Config #5: the progressive wavefront with a camera that orbits each
    # frame, so every frame resets accumulation (GLRenderer.cpp:145-161)
    # and renders at spp 4 like the reference's interactive default.
    animate = scene_name == "anim"
    if animate:
        from spt_tpu_torch.camera import default_camera
        from spt_tpu_torch.config import RenderConfig
        from spt_tpu_torch.scene import build_default_scene

        cfg = RenderConfig(width=width, height=height, spp=4, max_depth=6)
        r = Renderer(build_default_scene(), cfg,
                     camera=default_camera(width, height), device=device)
    else:
        r = build_workload(scene_name, width, height, device)
    cfg = r.cfg

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def advance_camera():
        # 2 degrees of orbit per frame (the --orbit CLI flag's math)
        r.camera.process_mouse(2.0 / r.camera.mouse_sensitivity, 0.0)

    r.camera.reset_movement_tracking()
    # warm up with the chain the timed loop runs (the kernels build here)
    if animate:
        for _ in range(warmup):
            advance_camera()
            r.render_frame(check_camera=True)
    else:
        r.render_frames(iters)
    sync()

    n_shadow = shadow_rays_per_surface_lane(r)
    trials = []
    for _ in range(3):
        t0 = time.perf_counter()
        if animate:
            frame_stats = []
            for _ in range(iters):
                advance_camera()
                r.render_frame(check_camera=True)
                frame_stats.append(r.last_stats)   # device tensors: no sync
        else:
            r.render_frames(iters)
            frame_stats = [r.last_stats]
        sync()                                      # one sync per chain
        dt = time.perf_counter() - t0
        total = sum(count_rays(s, n_shadow) for s in frame_stats)
        trials.append((total / dt / 1e6, dt / iters * 1e3))
    trials.sort()
    mrays, ms_per_frame = trials[len(trials) // 2]
    result = {
        "metric": f"wavefront_mrays_per_sec_{scene_name}_scene_{width}x{height}",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / TARGET_MRAYS, 3),
        "ms_per_frame": round(ms_per_frame, 2),
        "spp": cfg.spp,
        "max_depth": cfg.max_depth,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    if scene_name in ("bigmesh", "stream"):
        from spt_tpu_torch.ops.cuda_bounce import _accel_mode

        result["tier"] = _accel_mode(r.scene) or "small"
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
