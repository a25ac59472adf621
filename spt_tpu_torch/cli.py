"""CLI entry of the PyTorch port (the reference's main.cpp, headless first).

    python -m spt_tpu_torch.cli [--scene cornell] [--frames 16] [-o out.png]

The counterpart of ``spt_tpu.cli``: the same flags with the same defaults
and choices (``--i <gltf>``, ``--s <hdr>``, main.cpp:21-54, plus the knobs
the reference hard-coded).  It renders N progressive frames of a scene on
the card and writes a PNG; ``--interactive`` opens the terminal viewer
(``engine/display``).  There is no ``--device`` flag, as the JAX CLI has
none: ``make_renderer`` and ``main`` take a ``device`` keyword, the card
by default; without one the Renderer raises.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spt-tpu-torch",
        description="Progressive Monte-Carlo path tracer (wavefront, "
        "PyTorch and CUDA)",
    )
    p.add_argument("--i", "-i", dest="gltf", metavar="FILE",
                   help="load a glTF model (replaces the default scene)")
    p.add_argument("--s", "-s", dest="skybox", metavar="FILE",
                   help="load an HDR skybox (replaces the procedural sky)")
    p.add_argument("--scene", choices=["default", "triangle", "cornell"],
                   default="default", help="built-in scene")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=4,
                   help="samples per pixel per frame (reference default: 4)")
    p.add_argument("--depth", type=int, default=6,
                   help="max path depth (reference default: 6)")
    p.add_argument("--frames", type=int, default=16,
                   help="progressive frames to accumulate")
    p.add_argument("--o", "-o", dest="output", default="render.png",
                   help="output PNG path")
    p.add_argument("--checkpoint", metavar="FILE",
                   help="save render state here (resume with --resume)")
    p.add_argument("--resume", metavar="FILE",
                   help="resume accumulation from a checkpoint")
    p.add_argument("--interactive", action="store_true",
                   help="interactive terminal viewer (WASD + mouse-less look)")
    p.add_argument("--tonemap", choices=["reinhard", "aces", "none"],
                   default="reinhard",
                   help="display transform at resolve (reference GPU default:"
                        " reinhard; EnvironmentManager also ships ACES)")
    p.add_argument("--exposure", type=float, default=2.2)
    p.add_argument("--stats", action="store_true",
                   help="print per-frame ray telemetry")
    p.add_argument("--orbit", type=float, default=0.0, metavar="DEG",
                   help="rotate the camera DEG degrees around the target "
                        "each frame (animated camera; progressive "
                        "accumulation resets on motion, GLRenderer.cpp:145-161)")
    p.add_argument("--integrator",
                   choices=["masked", "compact", "regen", "megakernel"],
                   default="masked",
                   help="wavefront lane scheduling: masked lanes (default), "
                        "compacted queues or per-lane path regeneration; or "
                        "the megakernel (the differentiable path)")
    p.add_argument("--swizzle", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="accepted for compatibility with the JAX CLI; it has "
                        "no effect here (the port keeps pixels in row-major "
                        "lane order)")
    p.add_argument("--debug-mode", choices=["geomtype", "hitmiss", "normal",
                                            "depth", "matid"],
                   help="render a single-bounce debug visualization instead "
                        "of path tracing (the reference's debug_mode, "
                        "LaunchParams.h:76-78)")
    return p


def make_renderer(args, device="cuda"):
    from spt_tpu_torch.camera import Camera, default_camera
    from spt_tpu_torch.config import RenderConfig
    from spt_tpu_torch.engine.renderer import Renderer, render_device
    from spt_tpu_torch.env import load_environment
    from spt_tpu_torch.scene import (
        build_cornell_box_scene,
        build_default_scene,
        build_test_triangle_scene,
    )

    device = render_device(device)

    cfg = RenderConfig(width=args.width, height=args.height,
                       spp=args.spp, max_depth=args.depth,
                       tonemap=args.tonemap, exposure=args.exposure,
                       integrator=args.integrator, swizzle=args.swizzle)

    camera = default_camera(cfg.width, cfg.height)
    if args.gltf:
        from spt_tpu_torch.io.gltf import bounding_box, load_gltf

        desc = load_gltf(args.gltf)
        lo, hi = bounding_box(desc)
        center = (lo + hi) / 2
        extent = float(np.linalg.norm(hi - lo)) or 1.0
        camera = Camera(
            position=center + np.array([0.0, 0.35, 1.1]) * extent,
            target=center,
            fov_degrees=60.0,
            aspect_ratio=cfg.width / cfg.height,
        )
        print(f"Loaded {args.gltf}: {len(desc.meshes)} meshes, "
              f"{desc.total_triangles} triangles, {len(desc.materials)} materials")
    elif args.scene == "triangle":
        desc = build_test_triangle_scene()
    elif args.scene == "cornell":
        desc = build_cornell_box_scene()
        camera = Camera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                        fov_degrees=50.0, aspect_ratio=cfg.width / cfg.height)
    else:
        desc = build_default_scene()

    # Quirk 8 parity: a bad skybox warns and falls back to the procedural
    # sky instead of aborting (main.cpp:196-202 "Failed to load skybox...
    # Continuing with default environment").
    try:
        env = load_environment(args.skybox, device)
    except (FileNotFoundError, ValueError, OSError) as e:
        print(f"warning: failed to load skybox {args.skybox}: {e}; "
              f"continuing with the procedural sky", file=sys.stderr)
        env = load_environment(None, device)
    else:
        if args.skybox:
            print(f"Loaded skybox {args.skybox}")

    return Renderer(desc, cfg, env=env, camera=camera, device=device)


def main(argv=None, device="cuda") -> int:
    import torch

    args = build_parser().parse_args(argv)
    try:
        r = make_renderer(args, device)
    except FileNotFoundError as e:
        print(f"error: {e.filename or e}: no such file", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.debug_mode:
        from spt_tpu_torch.engine.image import write_png
        from spt_tpu_torch.integrators.debug import render_debug

        img = render_debug(r.cfg, r.scene, r.camera.rays(r.device),
                           args.debug_mode)
        write_png(args.output, img.cpu().numpy())
        print(f"Wrote {args.output} ({args.debug_mode} debug view)")
        return 0

    if args.resume:
        try:
            r.load_checkpoint(args.resume)
        except FileNotFoundError:
            print(f"error: checkpoint {args.resume}: no such file", file=sys.stderr)
            return 2
        except ValueError as e:
            print(f"error: {e} (checkpoint was saved at a different "
                  f"resolution than --width/--height)", file=sys.stderr)
            return 2
        print(f"Resumed from {args.resume} at {r.accumulated_samples:.0f} samples")

    if args.interactive:
        from spt_tpu_torch.engine.display import run_viewer

        run_viewer(r)
        return 0

    r.camera.reset_movement_tracking()
    t0 = time.perf_counter()
    last_log = t0
    # Static camera without per-frame stats: queue frames in batches of 4
    # between the progress checks; an orbit or --stats steps frame by frame.
    batch = 4 if not (args.orbit or args.stats) else 1
    f = 0
    while f < args.frames:
        if batch > 1:
            k = min(batch, args.frames - f)
            r.render_frames(k)
            f += k
        else:
            if args.orbit and f:
                r.camera.process_mouse(args.orbit / r.camera.mouse_sensitivity,
                                       0.0)
            r.render_frame(check_camera=bool(args.orbit))
            f += 1
            if args.stats and r.last_stats is not None:
                rays = r.last_stats.rays_per_bounce.cpu().numpy()
                print(f"frame {f - 1}: rays/bounce {rays.tolist()}")
        now = time.perf_counter()
        # FPS + samples every 5 s (GLRenderer.cpp:183-187)
        if now - last_log > 5.0:
            fps = f / (now - t0)
            print(f"[{now - t0:6.1f}s] {fps:5.1f} fps, "
                  f"{r.accumulated_samples:.0f} samples/pixel")
            last_log = now
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    dt = time.perf_counter() - t0
    print(f"Rendered {args.frames} frames ({r.accumulated_samples:.0f} spp) "
          f"in {dt:.2f}s ({args.frames / dt:.1f} fps)")

    r.save_png(args.output)
    print(f"Wrote {args.output}")
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
        print(f"Checkpointed to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
