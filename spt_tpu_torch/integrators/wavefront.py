"""Wavefront integrator, masked path: the depth loop in one kernel launch.

The counterpart of ``spt_tpu.integrators.wavefront`` for
``integrator="masked"``.  One sample is gen_primary, then the whole depth
loop in ``cuda_bounce.fused_frame`` (the CUDA kernel for a CUDA tensor, its
plain PyTorch version for a CPU tensor), then the deferred environment term:
a lane dies at most once by missing and keeps its direction and throughput
frozen, so one environment evaluation after the loop replaces one per
bounce.

A CUDA run the kernel cannot take raises (the JAX package falls back to its
staged loop with a warning; the port does not).  The JAX package's
block swizzle of the lane -> pixel mapping is not ported: RNG is seeded per
pixel, so the image does not depend on lane order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from spt_tpu_torch.camera import CameraRays
from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.env import Environment, environment_color_v
from spt_tpu_torch.integrators import transport
from spt_tpu_torch.lights import DeviceLights
from spt_tpu_torch.ops import cuda_bounce
from spt_tpu_torch.ops import vec3 as v3
from spt_tpu_torch.scene.flatten import DeviceScene


class WavefrontStats(NamedTuple):
    """Per-bounce telemetry (the frame-0 `rays N -> hits M -> next N'` log,
    OptixBackend.cpp:1690-1695), as device tensors."""

    rays_per_bounce: torch.Tensor   # (max_depth,) int64 — live rays traced
    bounces_run: torch.Tensor       # () int64 — bounces with any live ray


def _wavefront_masked(cfg: RenderConfig, scene: DeviceScene, env: Environment,
                      lights: DeviceLights, ps: transport.PathState):
    """The depth loop of one sample plus the deferred env term."""
    radiance, direction, throughput, missed_ever, rays = cuda_bounce.fused_frame(
        cfg, scene, lights, ps)
    env_c = environment_color_v(env, direction)
    zero = torch.zeros_like(radiance.x)
    radiance = radiance + v3.where(missed_ever, throughput * env_c,
                                   v3.Vec3(zero, zero, zero))
    bounces = (rays > 0).sum()
    return radiance.to_array(), WavefrontStats(rays_per_bounce=rays,
                                               bounces_run=bounces)


def wavefront_sample(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index,
    sample_index: int = 0,
) -> Tuple[torch.Tensor, WavefrontStats]:
    """One sample per pixel -> ((N, 3) radiance, stats)."""
    ps = transport.gen_primary(cfg, camera, frame_index, sample_index)
    return _wavefront_masked(cfg, scene, env, lights, ps)


def render_wavefront(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index=0,
) -> Tuple[torch.Tensor, WavefrontStats]:
    """cfg.spp samples -> ((H, W, 3) linear radiance, summed stats)."""
    if cfg.integrator != "masked":
        raise NotImplementedError(
            f"integrator={cfg.integrator!r} is not ported yet; spt_tpu_torch "
            "runs the 'masked' wavefront integrator")
    device = camera.position.device
    acc = torch.zeros((cfg.num_pixels, 3), dtype=torch.float32, device=device)
    rays = torch.zeros(cfg.max_depth, dtype=torch.int64, device=device)
    bounces = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(cfg.spp):
        rad, stats = wavefront_sample(cfg, scene, env, lights, camera,
                                      frame_index, s)
        acc = acc + rad
        rays = rays + stats.rays_per_bounce
        bounces = torch.maximum(bounces, stats.bounces_run)
    img = (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return img, WavefrontStats(rays_per_bounce=rays, bounces_run=bounces)
