"""Megakernel integrator: the whole path per pixel batch, bounce after bounce.

The counterpart of ``spt_tpu.integrators.megakernel`` (the reference's CPU
recursive tracer, PathTracer.cpp:113-224, restated iteratively in
wf_pt_cpu.cpp:94-248): every bounce traces and shades the full pixel batch
through ``transport.trace_bounce`` and ``transport.shade``, dead lanes
masked.

This is the differentiable path: it is plain PyTorch over the shading, so
``torch.autograd`` reaches the material tables (set ``requires_grad`` on
``scene.materials.base_color``, ``roughness`` or ``metallic``, which
``flatten_scene`` makes as leaves).  On a mesh scene on the card the hits
come from the CUDA tracers (``ops/cuda_trace``), whose outputs carry no
gradient, as in the JAX package: a hit's t, ids, normal and uv are
constants of the graph, and the gradient reaches the materials through
shading only.  An HDR environment on the card goes through the equirect
sampler (``ops/cuda_env``), which passes no gradient to the miss direction
either; the procedural sky is plain PyTorch and does.
"""

from __future__ import annotations

import torch

from spt_tpu_torch.camera import CameraRays
from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.env import Environment
from spt_tpu_torch.integrators import transport
from spt_tpu_torch.lights import DeviceLights
from spt_tpu_torch.scene.flatten import DeviceScene


def render_sample(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index,
    sample_index: int = 0,
) -> torch.Tensor:
    """One sample per pixel -> (N, 3) linear radiance."""
    ps = transport.gen_primary(cfg, camera, frame_index, sample_index)
    for bounce in range(cfg.max_depth):
        hit = transport.trace_bounce(scene, ps)
        ps = transport.shade(cfg, scene, env, lights, ps, hit, bounce=bounce,
                             is_last=bounce == cfg.max_depth - 1)
    return ps.radiance.to_array()


def render_megakernel(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index=0,
) -> torch.Tensor:
    """cfg.spp samples averaged -> (H, W, 3) linear radiance (the spp loop
    of PathTracer::traceRay, PathTracer.cpp:280-303, minus its per-sample
    tonemap; resolve happens once downstream)."""
    acc = None
    for s in range(cfg.spp):
        rad = render_sample(cfg, scene, env, lights, camera, frame_index, s)
        acc = rad if acc is None else acc + rad
    return (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
