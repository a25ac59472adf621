"""Analytic lights as SoA device tables (the counterpart of ``spt_tpu.lights``).

- DirectionalLight stores the direction TO the light (Light.cpp:43-46),
  infinite distance, no attenuation (:48-55).
- PointLight has constant/linear/quadratic attenuation (:58-79).

Both kinds live in one padded table; a `kind` tag selects the formula with
masked math.  ``KIND_NONE`` padding rows are inactive and add nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spt_tpu_torch.ops import vec3 as v3

KIND_NONE = 0
KIND_DIRECTIONAL = 1
KIND_POINT = 2

_BIG = 1e30  # stand-in for the infinite directional-light distance


class DeviceLights(NamedTuple):
    """(L,)-padded SoA light table."""

    kind: torch.Tensor        # (L,) int32
    vec: torch.Tensor         # (L, 3) direction-to-light (directional) | position (point)
    color: torch.Tensor       # (L, 3)
    intensity: torch.Tensor   # (L,)
    attenuation: torch.Tensor # (L, 3) constant/linear/quadratic (point only)

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class LightManager:
    """Host-side builder (Light.h:84-105 LightManager add/get/clear)."""

    def __init__(self):
        self._rows = []

    def add_directional_light(self, direction, color=(1.0, 1.0, 1.0), intensity: float = 1.0):
        d = np.asarray(direction, np.float32)
        to_light = -d / np.linalg.norm(d)  # store direction TO light (Light.cpp:44-46)
        self._rows.append((KIND_DIRECTIONAL, to_light, np.asarray(color, np.float32),
                           float(intensity), np.array([1.0, 0.0, 0.0], np.float32)))

    def add_point_light(self, position, color=(1.0, 1.0, 1.0), intensity: float = 1.0,
                        constant: float = 1.0, linear: float = 0.09, quadratic: float = 0.032):
        self._rows.append((KIND_POINT, np.asarray(position, np.float32),
                           np.asarray(color, np.float32), float(intensity),
                           np.array([constant, linear, quadratic], np.float32)))

    def clear_lights(self):
        self._rows = []

    @property
    def light_count(self) -> int:
        return len(self._rows)

    def device(self, device="cuda", pad_multiple: int = 1) -> DeviceLights:
        """The light table on `device` (a torch device)."""
        n = max(len(self._rows), 1)
        n = ((n + pad_multiple - 1) // pad_multiple) * pad_multiple
        kind = np.zeros(n, np.int32)
        vec = np.zeros((n, 3), np.float32)
        color = np.zeros((n, 3), np.float32)
        intensity = np.zeros(n, np.float32)
        atten = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
        for i, (k, v, c, it, a) in enumerate(self._rows):
            kind[i], vec[i], color[i], intensity[i], atten[i] = k, v, c, it, a
        return DeviceLights(
            kind=torch.as_tensor(kind, device=device),
            vec=torch.as_tensor(vec, device=device),
            color=torch.as_tensor(color, device=device),
            intensity=torch.as_tensor(intensity, device=device),
            attenuation=torch.as_tensor(atten, device=device),
        )


def default_lights(device="cuda") -> DeviceLights:
    """setupLights (main.cpp:85-94): one directional light, direction
    (-0.5, -1, 0.3), warm white (1, 0.95, 0.8), intensity 2."""
    lm = LightManager()
    lm.add_directional_light([-0.5, -1.0, 0.3], [1.0, 0.95, 0.8], 2.0)
    return lm.device(device)


def sample_light_v(lights: DeviceLights, i: int, p: v3.Vec3):
    """Per-lane radiance for static light index `i`, Vec3 form.
    Returns (Li: Vec3, dir_to_light: Vec3, distance, active)."""
    kind = lights.kind[i]
    vx, vy, vz = lights.vec[i, 0], lights.vec[i, 1], lights.vec[i, 2]
    it = lights.intensity[i]
    cx = lights.color[i, 0] * it
    cy = lights.color[i, 1] * it
    cz = lights.color[i, 2] * it
    a0, a1, a2 = (lights.attenuation[i, 0], lights.attenuation[i, 1],
                  lights.attenuation[i, 2])

    is_point = kind == KIND_POINT
    lvx, lvy, lvz = vx - p.x, vy - p.y, vz - p.z
    dist_p = torch.sqrt(lvx * lvx + lvy * lvy + lvz * lvz)
    inv = 1.0 / torch.clamp(dist_p, min=1e-12)
    atten = a0 + a1 * dist_p + a2 * dist_p * dist_p
    inv_at = 1.0 / torch.clamp(atten, min=1e-12)

    ldir = v3.Vec3(
        torch.where(is_point, lvx * inv, vx),
        torch.where(is_point, lvy * inv, vy),
        torch.where(is_point, lvz * inv, vz),
    )
    dist = torch.where(is_point, dist_p, _BIG)
    li = v3.Vec3(
        torch.where(is_point, cx * inv_at, cx),
        torch.where(is_point, cy * inv_at, cy),
        torch.where(is_point, cz * inv_at, cz),
    )
    active = kind != KIND_NONE
    return li, ldir, dist, active
