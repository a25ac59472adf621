"""Environment lighting: procedural sky + equirectangular HDR maps.

The counterpart of ``spt_tpu.env`` (EnvironmentManager.cpp, Cubemap.cpp):

- env color = clamp(sample, max=5.0) * intensity 0.8
  (EnvironmentManager.cpp:9-28, EnvironmentManager.h:12-13);
- procedural sky fallback (EnvironmentManager.cpp:35-61);
- equirect mapping theta = atan2(z, x), phi = acos(y), u = (theta+pi)/2pi,
  v = phi/pi, texel-center bilinear with wrap in u and per-tap clamp in v
  (device_programs.cu:374-387).  On a CUDA tensor the HDR term is the
  equirect sampler kernel (K2, ``ops/cuda_env``), which reads the map in
  its texel layout (``equirect_texels``: 16 bytes a texel, one load a tap,
  the layout every environment is made in); its plain version indexes the
  four taps of ``sample_equirect_v`` with plain tensor indexing, the
  counterpart of the JAX package's flat ``jnp.take``;
- ``load_environment`` reads a Radiance ``.hdr`` file (``io/hdr``),
  resampling a 4:3 cross cubemap to equirect once.

The environment term is evaluated once per sample after the depth loop (the
deferred-env contract of the wavefront integrator).  The JAX package's
snap/packed lookups (opt-in TPU trades) and its ``SPT_PALLAS_ENV`` /
``SPT_ENV_KERNEL`` switches are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spt_tpu_torch.ops import math3d as m3
from spt_tpu_torch.ops import vec3 as v3

SUN_DIRECTION = np.array([0.3, 0.6, -0.8], np.float64)
SUN_DIRECTION /= np.linalg.norm(SUN_DIRECTION)

_PI = float(np.pi)


class Environment(NamedTuple):
    """Environment.  `enabled`, `intensity` and `max_clamp` are host values:
    the choice between the HDR map and the procedural sky is made on the
    host, so neither side is computed for nothing and nothing syncs.
    `image` is held in the texel layout (``equirect_texels``), which the
    sampler kernel requires and the plain version reads as any map."""

    image: torch.Tensor   # (H, W, 3) float32 linear HDR ((1, 1, 3) placeholder)
    enabled: bool
    intensity: float
    max_clamp: float


def make_procedural_environment(device="cuda") -> Environment:
    return Environment(
        image=equirect_texels(torch.zeros((1, 1, 3), dtype=torch.float32,
                                          device=device)),
        enabled=False,
        intensity=0.8,
        max_clamp=5.0,
    )


def equirect_texels(image: torch.Tensor) -> torch.Tensor:
    """An (H, W, 3) map in the sampler kernel's texel layout: the (H, W, 3)
    view of an (H, W, 4) float32 buffer that holds each texel's RGB and a
    zero, so that a tap is one aligned 16-byte load (the Hopper counterpart
    of pallas_env.env_pretile, which tiles the map for the TPU's DMA)."""
    return torch.nn.functional.pad(image.to(torch.float32), (0, 1))[..., :3]


def has_texel_layout(image: torch.Tensor) -> bool:
    """Whether an (H, W, 3) float32 map is held as equirect_texels holds it:
    16-byte texels, 16-byte aligned, the pad word of the last one in the
    buffer."""
    h, w, _ = image.shape
    return (image.stride() == (4 * w, 4, 1) and image.data_ptr() % 16 == 0
            and image.untyped_storage().nbytes()
            >= 4 * (image.storage_offset() + 4 * h * w))


def make_hdr_environment(image: np.ndarray, device, intensity: float = 0.8,
                         max_clamp: float = 5.0) -> Environment:
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) HDR image, got {img.shape}")
    return Environment(
        image=equirect_texels(torch.as_tensor(np.ascontiguousarray(img),
                                              device=device)),
        enabled=True,
        intensity=float(intensity),
        max_clamp=float(max_clamp),
    )


def synthetic_equirect(height: int = 64, sun_radiance: float = 40.0) -> np.ndarray:
    """Deterministic synthetic equirect HDR (H, 2H, 3): a sky gradient plus a
    bright sun disk whose radiance exceeds the 5.0 clamp — the JAX package's
    stand-in for the reference's missing default skybox (PathTracer.cpp:24)."""
    h, w = height, 2 * height
    v = (np.arange(h, dtype=np.float32) + 0.5) / h          # 0 top .. 1 bottom
    u = (np.arange(w, dtype=np.float32) + 0.5) / w
    vv, uu = np.meshgrid(v, u, indexing="ij")
    zen = np.stack([0.18 + 0 * vv, 0.30 + 0 * vv, 0.65 + 0 * vv], -1)
    hor = np.stack([0.9 + 0 * vv, 0.75 + 0 * vv, 0.55 + 0 * vv], -1)
    t = np.clip(np.abs(vv - 0.5) * 2.0, 0.0, 1.0)[..., None]
    img = hor * (1 - t) + (zen * (vv < 0.5)[..., None] +
                           0.15 * hor * (vv >= 0.5)[..., None]) * t
    du = np.minimum(np.abs(uu - 0.3), 1.0 - np.abs(uu - 0.3)) * 2.0
    dv = vv - 0.25
    r2 = du * du + dv * dv
    sun = np.exp(-r2 / 0.002)[..., None] * np.array(
        [sun_radiance, sun_radiance * 0.9, sun_radiance * 0.7], np.float32
    )
    return (img + sun).astype(np.float32)


def procedural_sky_v(d: v3.Vec3) -> v3.Vec3:
    """getSkyColor (EnvironmentManager.cpp:35-61), Vec3 form."""
    t = 0.5 * (d.y + 1.0)
    t = m3.smoothstep(0.0, 1.0, t)
    sky = v3.Vec3(
        0.7 * (1.0 - t) + 0.2 * t,
        0.8 * (1.0 - t) + 0.4 * t,
        0.9 * (1.0 - t) + 0.8 * t,
    )
    sun = SUN_DIRECTION.astype(np.float32)
    sun_dot = torch.clamp(
        d.x * float(sun[0]) + d.y * float(sun[1]) + d.z * float(sun[2]),
        min=0.0,
    )
    glow = sun_dot ** 64.0 + (sun_dot ** 8.0) * 0.3
    sky = sky + v3.Vec3(glow * 1.0, glow * 0.9, glow * 0.7)
    return sky * 0.8


def _equirect_taps(h: int, w: int, d: v3.Vec3):
    """Texel-center bilinear tap setup (device_programs.cu:374-387): wrap
    in u, per-tap clamp in v (y1 derives from the UNclipped floor, so at the
    top pole both taps clamp to row 0).  Returns (x0i, x1i, y0i, y1i, fx, fy)."""
    theta = torch.atan2(d.z, d.x)
    phi = torch.acos(torch.clamp(d.y, -1.0, 1.0))
    u = (theta + _PI) / (2.0 * _PI)
    v = phi / _PI

    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.remainder(x0.to(torch.int32), w)
    y0f = y0.to(torch.int32)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0f, 0, h - 1)
    y1i = torch.clamp(y0f + 1, 0, h - 1)
    return x0i, x1i, y0i, y1i, fx, fy


def sample_equirect_v(image: torch.Tensor, d: v3.Vec3) -> v3.Vec3:
    """Bilinear equirect lookup (device_programs.cu:374-387), Vec3 form."""
    h, w = image.shape[0], image.shape[1]
    x0i, x1i, y0i, y1i, fx, fy = _equirect_taps(h, w, d)
    flat = image.reshape(h * w, 3)
    c00 = flat[(y0i * w + x0i).long()]
    c01 = flat[(y0i * w + x1i).long()]
    c10 = flat[(y1i * w + x0i).long()]
    c11 = flat[(y1i * w + x1i).long()]
    top = c00 * (1.0 - fx)[..., None] + c01 * fx[..., None]
    bot = c10 * (1.0 - fx)[..., None] + c11 * fx[..., None]
    out = top * (1.0 - fy)[..., None] + bot * fy[..., None]
    return v3.Vec3.from_array(out)


def load_environment(path=None, device="cuda") -> Environment:
    """Load a Radiance .hdr file (the `--s` CLI path, main.cpp:30-46) or fall
    back to the procedural sky (spt_tpu/env.py:247-262): a 2:1 equirect is
    used directly, a 4:3 horizontal cross resampled to equirect once
    (Cubemap.cpp:18-46)."""
    if not path:
        return make_procedural_environment(device)
    from spt_tpu_torch.io.hdr import detect_layout, read_hdr

    img = read_hdr(path)
    if detect_layout(img.shape[1], img.shape[0]) == "cross":
        from spt_tpu_torch.io.cubemap_cross import cross_to_equirect

        img = cross_to_equirect(img)
    return make_hdr_environment(img, device)


def environment_color_v(env: Environment, direction: v3.Vec3,
                        need=None) -> v3.Vec3:
    """getEnvironmentColor (EnvironmentManager.cpp:9-33), Vec3 form
    (spt_tpu/env.py:395-442).

    `need` (optional (N,) bool): the lanes whose result the caller uses.
    With an HDR map, a CUDA tensor goes through the sampler kernel, which
    gives 0 outside `need` and loads nothing there; a CPU tensor runs the
    plain version on every lane.  The procedural sky is full width."""
    if not env.enabled:
        return procedural_sky_v(v3.safe_normalize(direction))
    from spt_tpu_torch.ops import cuda_env

    return cuda_env.env_sample(env, direction, need)
