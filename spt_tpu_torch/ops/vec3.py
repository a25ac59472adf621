"""Component-SoA 3-vectors over ``(N,)`` torch tensors.

The counterpart of ``spt_tpu.ops.vec3``: x/y/z live in three independent
``(N,)`` tensors, and every helper evaluates its expression in the same
order as the JAX version, so float32 results round the same way op for op
(the CUDA kernel in ``csrc/fused_frame.cu`` keeps that order too).

Operators are overloaded (`+`, `-`, `*`, `/`, unary `-`); `*` means
componentwise for Vec3*Vec3 and broadcast-scale for Vec3*(N,).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # --- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # --- conversions --------------------------------------------------------
    @staticmethod
    def from_array(a: torch.Tensor) -> "Vec3":
        """(…, 3) tensor -> Vec3 of (…,) components."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full(v, shape, device) -> "Vec3":
        """Constant vector broadcast to `shape` lanes on `device`."""
        v = np.asarray(v, np.float32)
        return Vec3(*(torch.full(shape, float(c), dtype=torch.float32,
                                 device=device) for c in v))

    def to_array(self) -> torch.Tensor:
        """Vec3 -> (…, 3) (boundary use only: accumulation/image output)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    @property
    def shape(self):
        return self.x.shape


# --- core ops -----------------------------------------------------------------

def dot(a: Vec3, b: Vec3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length2(v: Vec3) -> torch.Tensor:
    return dot(v, v)


def length(v: Vec3) -> torch.Tensor:
    return torch.sqrt(length2(v))


def max_component(v: Vec3) -> torch.Tensor:
    return torch.maximum(v.x, torch.maximum(v.y, v.z))


def safe_normalize(v: Vec3) -> Vec3:
    """Zero vectors stay zero (wf_math.h:28-33).  rsqrt, as the JAX
    version: rsqrt and 1/sqrt differ in the last bit."""
    l2 = length2(v)
    ok = l2 > 0.0
    inv = torch.where(ok, torch.rsqrt(torch.where(ok, l2, 1.0)), 0.0)
    return v * inv


def normalize_or(v: Vec3, fallback: Vec3) -> Vec3:
    """Degenerate vectors fall back (device_programs.cu:441-451 pattern)."""
    l2 = length2(v)
    ok = l2 > 0.0
    inv = torch.rsqrt(torch.where(ok, l2, 1.0))
    return where(ok, v * inv, fallback)


def where(mask: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def reflect(i: Vec3, n: Vec3) -> Vec3:
    return i - n * (2.0 * dot(i, n))


def refract(i: Vec3, n: Vec3, eta: torch.Tensor):
    """Snell refraction; returns (dir, can_refract) (wf_math.h:82-91)."""
    cosi = torch.clamp(-dot(n, i), -1.0, 1.0)
    sin2t = eta * eta * torch.clamp(1.0 - cosi * cosi, min=0.0)
    can = sin2t <= 1.0
    tpos = sin2t < 1.0
    cost = torch.where(tpos, torch.sqrt(torch.where(tpos, 1.0 - sin2t, 1.0)),
                       0.0)
    t = i * eta + n * (eta * cosi - cost)
    t = safe_normalize(t)
    zero = torch.zeros_like(t.x)
    return where(can, t, Vec3(zero, zero, zero)), can


def make_onb(n: Vec3):
    """ONB matching make_onb (device_programs.cu:213-218): up = +Z unless
    |n.z| >= 0.999 then +X; t = normalize(up x n); b = n x t."""
    use_z = torch.abs(n.z) < 0.999
    upx = torch.where(use_z, 0.0, 1.0)
    uz = 1.0 - upx
    up = Vec3(upx, torch.zeros_like(upx), uz)
    t = safe_normalize(cross(up, n))
    b = cross(n, t)
    return t, b


def from_onb(t: Vec3, b: Vec3, n: Vec3, lx, ly, lz) -> Vec3:
    """Local (lx, ly, lz) -> world via (t, b, n)."""
    return t * lx + b * ly + n * lz


def lerp(a: Vec3, b: Vec3, t: torch.Tensor) -> Vec3:
    return a * (1.0 - t) + b * t


def faceforward(n: Vec3, d: Vec3):
    """Flip n against d; returns (n_ff, entering)."""
    entering = dot(d, n) < 0.0
    return where(entering, n, -n), entering
