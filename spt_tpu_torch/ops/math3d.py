"""Batched 3-vector math over (..., 3) tensors: the counterpart of
``spt_tpu.ops.math3d``.

The render paths use the component-SoA forms of ``ops/vec3``; these are the
(N, 3) and single-ray helpers beside them, each a wrapper over its Vec3
form, so both round alike.  They agree with the JAX package's array forms
to a few ulps (tests/test_torch_helpers.py): XLA fuses some of what runs
here op by op.
"""

from __future__ import annotations

import torch

from spt_tpu_torch.ops import vec3 as v3

_V = v3.Vec3.from_array


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane dot product; returns (...,) given (..., 3)."""
    return v3.dot(_V(a), _V(b))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return v3.cross(_V(a), _V(b)).to_array()


def length(v: torch.Tensor) -> torch.Tensor:
    return v3.length(_V(v))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)); non-positive lanes give exactly 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize; zero vectors map to zero (wf_math.h:28-33)."""
    return v3.safe_normalize(_V(v)).to_array()


def normalize_or(v: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Normalize; degenerate vectors map to `fallback`
    (device_programs.cu:441-451)."""
    return v3.normalize_or(_V(v), _V(fallback)).to_array()


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror `i` about `n` (device_programs.cu:79-82)."""
    return v3.reflect(_V(i), _V(n)).to_array()


def refract(i: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Snell refraction -> (direction, can_refract); zero on total internal
    reflection (wf_math.h:82-91).  `i` points toward the surface, `n`
    against it, eta = etaI / etaT."""
    t, can = v3.refract(_V(i), _V(n), eta)
    return t.to_array(), can


def make_onb(n: torch.Tensor):
    """Orthonormal basis (t, b) around unit `n` (device_programs.cu:213-218):
    up = +Z unless |n.z| >= 0.999, then +X; t = normalize(up x n);
    b = n x t."""
    t, b = v3.make_onb(_V(n))
    return t.to_array(), b.to_array()


def from_onb(t, b, n, local: torch.Tensor) -> torch.Tensor:
    """Local (x, y, z) -> world via the basis (t, b, n)."""
    return v3.from_onb(_V(t), _V(b), _V(n), *_V(local)).to_array()


def smoothstep(edge0: float, edge1: float, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def faceforward(n: torch.Tensor, d: torch.Tensor):
    """Flip `n` to oppose the ray direction `d` -> (n_ff, entering)
    (wf_pt_cpu.cpp:112-115)."""
    ff, entering = v3.faceforward(_V(n), _V(d))
    return ff.to_array(), entering


def luminance_max(c: torch.Tensor) -> torch.Tensor:
    """max(r, g, b): the RR survival probability (wf_pt_cpu.cpp:234)."""
    return v3.max_component(_V(c))
