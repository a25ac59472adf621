"""Ray-scene intersection, small-scene routes.

The counterpart of ``spt_tpu.ops.intersect`` for scenes of at most
``UNROLL_LIMIT`` primitives: brute force over the triangle and sphere tables
with the semantics of ``_intersect_unrolled`` / ``_occluded_unrolled``
(intersect.py:138,205) — one primitive against all lanes at a time, the
winner carried with selects, triangles before spheres, and the strict
``t < best`` test, so ties resolve the same way as in the JAX package.

Conventions (as the JAX package):
- `t = INF` means miss;
- triangle normals are geometric, cross(e1, e2), unless the scene carries
  interpolated shading normals; integrators faceforward + normalize;
- `kind`: 0 miss, 1 triangle, 2 sphere.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from spt_tpu_torch.ops import math3d as m3
from spt_tpu_torch.ops.vec3 import Vec3

INF = math.inf

KIND_MISS = 0
KIND_TRIANGLE = 1
KIND_SPHERE = 2

# Möller-Trumbore determinant cutoff (parallel-ray rejection).
_MT_EPS = 1e-9

UNROLL_LIMIT = 192


class HitV(NamedTuple):
    """Component-SoA hit record (LaunchParams.h:27-32)."""

    t: torch.Tensor        # (N,) float32, INF on miss
    normal: Vec3           # geometric or shading normal (not normalized)
    mat_id: torch.Tensor   # (N,) int32
    kind: torch.Tensor     # (N,) int32

    @property
    def hit_mask(self) -> torch.Tensor:
        return torch.isfinite(self.t)


def _tri_scalar_test(scene, i, o: Vec3, d: Vec3, tmin, tmax, best_t):
    """Triangle `i` against all lanes; returns (ok, t, normal xyz, (u, v))."""
    v0x, v0y, v0z = scene.tri_v0[i, 0], scene.tri_v0[i, 1], scene.tri_v0[i, 2]
    e1x, e1y, e1z = scene.tri_e1[i, 0], scene.tri_e1[i, 1], scene.tri_e1[i, 2]
    e2x, e2y, e2z = scene.tri_e2[i, 0], scene.tri_e2[i, 1], scene.tri_e2[i, 2]
    hx = d.y * e2z - d.z * e2y
    hy = d.z * e2x - d.x * e2z
    hz = d.x * e2y - d.y * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    big = torch.abs(a) > _MT_EPS
    inv = 1.0 / torch.where(big, a, 1.0)
    sx, sy, sz = o.x - v0x, o.y - v0y, o.z - v0z
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (d.x * qx + d.y * qy + d.z * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    ok = (big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > tmin) & (t < tmax) & (t < best_t))
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    return ok, t, (nx, ny, nz), (u, v)


def _sph_scalar_test(scene, i, o: Vec3, d: Vec3, tmin, tmax, best_t):
    cx, cy, cz = scene.sph_center[i, 0], scene.sph_center[i, 1], scene.sph_center[i, 2]
    r = scene.sph_radius[i]
    ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
    b = ocx * d.x + ocy * d.y + ocz * d.z
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c
    sq = m3.safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where((t0 > tmin) & (t0 < tmax), t0, t1)
    ok = (disc > 0.0) & (r > 0.0) & (t > tmin) & (t < tmax) & (t < best_t)
    return ok, t, (cx, cy, cz, r)


def intersect_v(scene, o: Vec3, d: Vec3, tmin=1e-4, tmax=INF) -> HitV:
    """Closest hit over every primitive (the unrolled route)."""
    _check_small(scene)
    zeros = torch.zeros_like(o.x)
    best_t = torch.full_like(o.x, INF)
    kind = torch.zeros(o.x.shape, dtype=torch.int32, device=o.x.device)
    mat = torch.zeros_like(kind)
    # carry: triangle normal OR sphere center in (ax, ay, az); sphere 1/r
    ax = ay = az = rinv = zeros
    tri_ns = scene.tri_ns
    for i in range(scene.num_triangles):
        ok, t, (nx, ny, nz), (bu, bv) = _tri_scalar_test(
            scene, i, o, d, tmin, tmax, best_t)
        if tri_ns is not None:
            # interpolated shading normal; zero rows keep the geometric one
            rn = tri_ns[i]
            snx = rn[0] + bu * rn[3] + bv * rn[6]
            sny = rn[1] + bu * rn[4] + bv * rn[7]
            snz = rn[2] + bu * rn[5] + bv * rn[8]
            ns_ok = snx * snx + sny * sny + snz * snz > 1e-12
            nx = torch.where(ns_ok, snx, nx)
            ny = torch.where(ns_ok, sny, ny)
            nz = torch.where(ns_ok, snz, nz)
        best_t = torch.where(ok, t, best_t)
        kind = torch.where(ok, KIND_TRIANGLE, kind)
        mat = torch.where(ok, scene.tri_mat[i], mat)
        ax = torch.where(ok, nx, ax)
        ay = torch.where(ok, ny, ay)
        az = torch.where(ok, nz, az)

    for i in range(scene.num_spheres):
        ok, t, (cx, cy, cz, r) = _sph_scalar_test(scene, i, o, d, tmin, tmax, best_t)
        best_t = torch.where(ok, t, best_t)
        kind = torch.where(ok, KIND_SPHERE, kind)
        mat = torch.where(ok, scene.sph_mat[i], mat)
        ax = torch.where(ok, cx, ax)
        ay = torch.where(ok, cy, ay)
        az = torch.where(ok, cz, az)
        rinv = torch.where(ok, 1.0 / torch.clamp(r, min=1e-12), rinv)

    # resolve normals: tri carried its normal; sphere -> (p - c) / r
    t_safe = torch.where(torch.isfinite(best_t), best_t, 0.0)
    is_sph = kind == KIND_SPHERE
    px = o.x + t_safe * d.x
    py = o.y + t_safe * d.y
    pz = o.z + t_safe * d.z
    normal = Vec3(
        torch.where(is_sph, (px - ax) * rinv, ax),
        torch.where(is_sph, (py - ay) * rinv, ay),
        torch.where(is_sph, (pz - az) * rinv, az),
    )
    return HitV(t=best_t, normal=normal, mat_id=mat, kind=kind)


def occluded_v(scene, o: Vec3, d: Vec3, tmin=1e-4, tmax=INF) -> torch.Tensor:
    """Any-hit shadow trace (rtcOccluded1, Light.cpp:16-40)."""
    _check_small(scene)
    blocked = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    far = INF
    for i in range(scene.num_triangles):
        ok = _tri_scalar_test(scene, i, o, d, tmin, tmax, far)[0]
        blocked = blocked | ok
    for i in range(scene.num_spheres):
        ok = _sph_scalar_test(scene, i, o, d, tmin, tmax, far)[0]
        blocked = blocked | ok
    return blocked


def _check_small(scene) -> None:
    if scene.num_triangles + scene.num_spheres > UNROLL_LIMIT:
        raise NotImplementedError(
            f"{scene.num_triangles + scene.num_spheres} primitives > "
            f"UNROLL_LIMIT={UNROLL_LIMIT}: the mesh path's tracers are not "
            "ported yet")


def safe_origin_v(p: Vec3, n: Vec3, front) -> Vec3:
    """Scale-aware self-intersection offset (PathTracer.cpp:101-111)."""
    mag = torch.maximum(torch.abs(p.x), torch.maximum(torch.abs(p.y), torch.abs(p.z)))
    eps = 1e-4 * torch.clamp(mag, min=1.0)
    off = torch.where(front, eps, -eps)
    return p + n * off
