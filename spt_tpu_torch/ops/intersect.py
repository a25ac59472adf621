"""Ray-scene intersection: the routes of ``spt_tpu.ops.intersect``.

- At most ``UNROLL_LIMIT`` primitives: brute force over the triangle and
  sphere tables with the semantics of ``_intersect_unrolled`` /
  ``_occluded_unrolled`` (intersect.py:138,205) — one primitive against all
  lanes at a time, the winner carried with selects, triangles before
  spheres, and the strict ``t < best`` test, so ties resolve the same way as
  in the JAX package.
- Above it the scene carries a cluster accel (``ops/bvh``), and the
  module follows ``_trace_module`` (intersect.py:460-479):
  - with an instanced TLAS/BLAS (``scene.inst``), the instanced tracer of
    ``ops/cuda_trace`` (the counterpart of ``spt_tpu.ops.pallas_inst``) on
    a CUDA tensor, its plain version on a CPU tensor or with ``plain=True``;
  - else on a CUDA tensor the resident cluster tracer (``ops/cuda_trace``,
    the counterpart of ``spt_tpu.ops.pallas_trace``), or past
    ``bvh.MAX_RESIDENT_TRIS`` the stream tier's supercluster tracer (the
    counterpart of ``spt_tpu.ops.pallas_stream``); on a CPU tensor, or
    with ``plain=True``, ``_intersect_chunked`` / ``_occluded_chunked``
    (intersect.py:272,380): (N, chunk) broadcast tests over the flat tables
    with a running minimum — the plain version of both tracers.  They agree
    except on exact ties.
- Textured scenes (``scene.tri_uv``) resolve the hit's interpolated texture
  coordinates (``HitV.uvx`` / ``uvy``) on every route.

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
    # Interpolated texture coordinates at the hit; None when the scene is
    # untextured.
    uvx: torch.Tensor = None
    uvy: torch.Tensor = None

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


def intersect_v(scene, o: Vec3, d: Vec3, tmin=1e-4, tmax=INF,
                plain: bool = False) -> HitV:
    """Closest hit (intersect.py:482-491's routing; `plain` keeps an accel
    scene on the chunked version whatever the device)."""
    if scene.num_triangles + scene.num_spheres <= UNROLL_LIMIT:
        return _intersect_unrolled(scene, o, d, tmin, tmax)
    _check_accel(scene)
    from spt_tpu_torch.ops import cuda_trace

    kernel = o.x.device.type == "cuda" and not plain
    if scene.inst is not None:
        fn = (cuda_trace.inst_closest_hit if kernel
              else cuda_trace.inst_closest_hit_reference)
        return fn(scene.inst, scene, o, d, tmin, tmax)
    if kernel:
        fn = (cuda_trace.stream_closest_hit if cuda_trace.is_stream(scene.accel)
              else cuda_trace.closest_hit)
        return fn(scene.accel, scene, o, d, tmin, tmax)
    return _intersect_chunked(scene, o, d, tmin, tmax)


def occluded_v(scene, o: Vec3, d: Vec3, tmin=1e-4, tmax=INF,
               plain: bool = False) -> torch.Tensor:
    """Any-hit shadow trace (rtcOccluded1, Light.cpp:16-40), routed as
    intersect_v."""
    if scene.num_triangles + scene.num_spheres <= UNROLL_LIMIT:
        return _occluded_unrolled(scene, o, d, tmin, tmax)
    _check_accel(scene)
    from spt_tpu_torch.ops import cuda_trace

    kernel = o.x.device.type == "cuda" and not plain
    if scene.inst is not None:
        fn = (cuda_trace.inst_any_hit if kernel
              else cuda_trace.inst_any_hit_reference)
        return fn(scene.inst, scene, o, d, tmin, tmax)
    if kernel:
        fn = (cuda_trace.stream_any_hit if cuda_trace.is_stream(scene.accel)
              else cuda_trace.any_hit)
        return fn(scene.accel, scene, o, d, tmin, tmax)
    return _occluded_chunked(scene, o, d, tmin, tmax)


def _check_accel(scene) -> None:
    if scene.accel is None:
        raise NotImplementedError(
            f"{scene.num_triangles + scene.num_spheres} primitives > "
            f"UNROLL_LIMIT={UNROLL_LIMIT} and no cluster accel built")


def _intersect_unrolled(scene, o: Vec3, d: Vec3, tmin, tmax) -> HitV:
    zeros = torch.zeros_like(o.x)
    best_t = torch.full_like(o.x, INF)
    kind = torch.zeros(o.x.shape, dtype=torch.int32, device=o.x.device)
    mat = torch.zeros_like(kind)
    # carry: triangle normal OR sphere center in (ax, ay, az); sphere 1/r
    ax = ay = az = rinv = zeros
    tri_ns = scene.tri_ns
    textured = scene.tri_uv is not None
    uvx = uvy = zeros
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
        if textured:
            # a sphere that wins later keeps this uv (intersect.py:173-176)
            r = scene.tri_uv[i]
            uvx = torch.where(ok, r[0] + bu * r[2] + bv * r[4], uvx)
            uvy = torch.where(ok, r[1] + bu * r[3] + bv * r[5], uvy)

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
    if not textured:
        uvx = uvy = None
    return HitV(t=best_t, normal=normal, mat_id=mat, kind=kind, uvx=uvx,
                uvy=uvy)


def _occluded_unrolled(scene, o: Vec3, d: Vec3, tmin, tmax) -> torch.Tensor:
    blocked = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    far = INF
    for i in range(scene.num_triangles):
        ok = _tri_scalar_test(scene, i, o, d, tmin, tmax, far)[0]
        blocked = blocked | ok
    for i in range(scene.num_spheres):
        ok = _sph_scalar_test(scene, i, o, d, tmin, tmax, far)[0]
        blocked = blocked | ok
    return blocked


# --- chunked broadcast route (the cluster tracer's plain version) -------------

def _chunk(n: int, target: int) -> int:
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def _col(tab, i):
    return tab[:, i][None, :]


def _tri_chunk_test(o: Vec3, d: Vec3, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore of every lane against C triangles -> (N, C) t, INF
    where the test fails; the arithmetic of intersect.py:226-242."""
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    e1x, e1y, e1z = _col(e1, 0), _col(e1, 1), _col(e1, 2)
    e2x, e2y, e2z = _col(e2, 0), _col(e2, 1), _col(e2, 2)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    big = torch.abs(a) > _MT_EPS
    inv = 1.0 / torch.where(big, a, 1.0)
    sx, sy, sz = ox - _col(v0, 0), oy - _col(v0, 1), oz - _col(v0, 2)
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2x * qx + e2y * qy + e2z * qz)
    valid = (big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin) & (t < tmax[:, None]))
    return torch.where(valid, t, INF)


def _sph_chunk_test(o: Vec3, d: Vec3, center, radius, tmin, tmax):
    ocx, ocy, ocz = (o.x[:, None] - _col(center, 0), o.y[:, None] - _col(center, 1),
                     o.z[:, None] - _col(center, 2))
    b = ocx * d.x[:, None] + ocy * d.y[:, None] + ocz * d.z[:, None]
    r = radius[None, :]
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c
    ok = (disc > 0.0) & (r > 0.0)
    sq = m3.safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    tmaxc = tmax[:, None]
    t = torch.where((t0 > tmin) & (t0 < tmaxc), t0, t1)
    valid = ok & (t > tmin) & (t < tmaxc)
    return torch.where(valid, t, INF)


def _lane_tmax(tmax, o: Vec3) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32,
                                              device=o.x.device), o.x.shape)


def _scan_min(test, n_prims: int, chunk_size: int, kind_id: int, carry):
    """Running (t, index, kind) minimum over chunks; within a chunk the
    lowest index wins a tie, across chunks the earlier (strict <)."""
    if not n_prims:
        return carry
    c = _chunk(n_prims, chunk_size)
    bt, bi, bk = carry
    for start in range(0, n_prims, c):
        tm, am = torch.min(test(start, start + c), dim=1)
        better = tm < bt
        bt = torch.where(better, tm, bt)
        bi = torch.where(better, am + start, bi)
        bk = torch.where(better, kind_id, bk)
    return bt, bi, bk


def _intersect_chunked(scene, o: Vec3, d: Vec3, tmin, tmax,
                       chunk_size: int = 128) -> HitV:
    """Closest hit by chunked brute force (intersect.py:272-377)."""
    tmax = _lane_tmax(tmax, o)
    n, dev = o.x.shape[0], o.x.device
    carry = (torch.full((n,), INF, device=dev),
             torch.zeros(n, dtype=torch.int64, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev))
    carry = _scan_min(
        lambda a, b: _tri_chunk_test(o, d, scene.tri_v0[a:b], scene.tri_e1[a:b],
                                     scene.tri_e2[a:b], tmin, tmax),
        scene.num_triangles, chunk_size, KIND_TRIANGLE, carry)
    carry = _scan_min(
        lambda a, b: _sph_chunk_test(o, d, scene.sph_center[a:b],
                                     scene.sph_radius[a:b], tmin, tmax),
        scene.num_spheres, chunk_size, KIND_SPHERE, carry)
    best_t, best_idx, kind = carry

    is_tri = kind == KIND_TRIANGLE
    is_sph = kind == KIND_SPHERE
    zero = torch.zeros_like(best_idx)
    ti = torch.where(is_tri, best_idx, zero)
    si = torch.where(is_sph, best_idx, zero)
    we1, we2 = scene.tri_e1[ti], scene.tri_e2[ti]
    nx = we1[:, 1] * we2[:, 2] - we1[:, 2] * we2[:, 1]
    ny = we1[:, 2] * we2[:, 0] - we1[:, 0] * we2[:, 2]
    nz = we1[:, 0] * we2[:, 1] - we1[:, 1] * we2[:, 0]
    t_safe = torch.where(torch.isfinite(best_t), best_t, 0.0)
    # (p - c) * (1 / r) as the unrolled and cluster tracers round it
    # (intersect.py:334 divides by r)
    rinv = (1.0 / torch.clamp(scene.sph_radius[si], min=1e-12)
            if scene.num_spheres else torch.ones_like(best_t))
    sph_n = []
    for k, (oc, dc) in enumerate(zip(o, d)):
        ctr = scene.sph_center[si, k] if scene.num_spheres else torch.zeros_like(best_t)
        sph_n.append((oc + t_safe * dc - ctr) * rinv)
    zf = torch.zeros_like(best_t)
    normal = [torch.where(is_tri, tn, torch.where(is_sph, sn, zf))
              for tn, sn in zip((nx, ny, nz), sph_n)]
    zi = torch.zeros_like(kind)
    tri_mat = scene.tri_mat[ti] if scene.num_triangles else zi
    sph_mat = scene.sph_mat[si] if scene.num_spheres else zi
    mat = torch.where(is_tri, tri_mat, torch.where(is_sph, sph_mat, zi))

    uvx = uvy = None
    if scene.tri_ns is not None or scene.tri_uv is not None:
        # the winner's barycentrics, re-evaluated
        wv0 = scene.tri_v0[ti]
        hx = d.y * we2[:, 2] - d.z * we2[:, 1]
        hy = d.z * we2[:, 0] - d.x * we2[:, 2]
        hz = d.x * we2[:, 1] - d.y * we2[:, 0]
        a = we1[:, 0] * hx + we1[:, 1] * hy + we1[:, 2] * hz
        inv_a = 1.0 / torch.where(torch.abs(a) > _MT_EPS, a, 1.0)
        sx, sy, sz = o.x - wv0[:, 0], o.y - wv0[:, 1], o.z - wv0[:, 2]
        bu = inv_a * (sx * hx + sy * hy + sz * hz)
        qx = sy * we1[:, 2] - sz * we1[:, 1]
        qy = sz * we1[:, 0] - sx * we1[:, 2]
        qz = sx * we1[:, 1] - sy * we1[:, 0]
        bv = inv_a * (d.x * qx + d.y * qy + d.z * qz)
        if scene.tri_uv is not None:
            r = scene.tri_uv[ti]
            uvx = torch.where(is_tri, r[:, 0] + bu * r[:, 2] + bv * r[:, 4], 0.0)
            uvy = torch.where(is_tri, r[:, 1] + bu * r[:, 3] + bv * r[:, 5], 0.0)
        if scene.tri_ns is not None:
            # zero rows keep the geometric normal
            rn = scene.tri_ns[ti]
            sn = [rn[:, k] + bu * rn[:, k + 3] + bv * rn[:, k + 6]
                  for k in range(3)]
            use = is_tri & (sn[0] * sn[0] + sn[1] * sn[1] + sn[2] * sn[2]
                            > 1e-12)
            normal = [torch.where(use, s, c) for s, c in zip(sn, normal)]
    return HitV(t=best_t, normal=Vec3(*normal), mat_id=mat, kind=kind,
                uvx=uvx, uvy=uvy)


def _occluded_chunked(scene, o: Vec3, d: Vec3, tmin, tmax,
                      chunk_size: int = 128) -> torch.Tensor:
    """Any hit by chunked brute force (intersect.py:380-412)."""
    tmax = _lane_tmax(tmax, o)
    blocked = torch.zeros(o.x.shape, dtype=torch.bool, device=o.x.device)
    for n, test in (
            (scene.num_triangles, lambda a, b: _tri_chunk_test(
                o, d, scene.tri_v0[a:b], scene.tri_e1[a:b], scene.tri_e2[a:b],
                tmin, tmax)),
            (scene.num_spheres, lambda a, b: _sph_chunk_test(
                o, d, scene.sph_center[a:b], scene.sph_radius[a:b], tmin,
                tmax))):
        if not n:
            continue
        c = _chunk(n, chunk_size)
        for start in range(0, n, c):
            blocked = blocked | torch.isfinite(test(start, start + c)).any(1)
    return blocked


def safe_origin_v(p: Vec3, n: Vec3, front) -> Vec3:
    """Scale-aware self-intersection offset (PathTracer.cpp:101-111)."""
    mag = torch.maximum(torch.abs(p.x), torch.maximum(torch.abs(p.y), torch.abs(p.z)))
    eps = 1e-4 * torch.clamp(mag, min=1.0)
    off = torch.where(front, eps, -eps)
    return p + n * off
