"""Plain PyTorch path tracer over a sample of pixels: the benchmark's
reference (see the package docstring).

Semantics, those of ``tests/reference_cpu.py`` (the scalar oracle), which
follow the reference renderer's GPU wavefront with its planned fixes:
- a path a (pixel, frame, sample), its RNG word
  ``wang_hash((pixel + 1) ^ (frame * 9781 + 1))``, then
  ``wang_hash(word ^ (sample * 9781 + 1))`` when spp > 1; the sub-pixel
  jitter draws two floats; a float is the word's low 24 bits / 2^24;
- closest hits against world-space triangles (Moller-Trumbore) and
  spheres, every primitive tested; a hit's normal faced against the ray;
- each bounce: emission, then every analytic light through a shadow ray
  from the scale-aware offset origin, shaded with Cook-Torrance GGX x
  NdotL; dielectrics (a delta BSDF, Fresnel-chosen reflect or refract, no
  direct light) draw one float, metals a VNDF half vector (two floats,
  kept only where the view is above the surface), diffuse surfaces a
  cosine direction and a Russian-roulette float, roulette from the bounce
  after ``rr_after``; the last bounce scatters nothing; a ray that misses
  adds throughput x the procedural sky;
- a frame's radiance is the mean of its spp samples, added to the sums
  times spp; ``resolve`` is exposure, Reinhard, gamma.

``shade_dtype`` computes the shading (normals, BRDF, sampling, throughput,
radiance) in another precision while intersection stays float32: the
control of the comparison that decides ``correct`` runs it in bfloat16.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
PI = 3.14159265358979323846
INF = math.inf
MT_EPS = 1e-9

DEFAULTS = dict(jitter=True, rr_after=2, exposure=2.2, gamma=2.2,
                tonemap="reinhard", shadow_rays=True, nee=True,
                direct_light_dielectric=False, metal_vndf=True,
                metal_mirror=False, cpu_transparency=False,
                depth_term_normal_vis=False, hit_eps=1e-4,
                ray_offset_dir=1e-3, firefly_clamp=50.0, integrator="masked",
                ray_sort=True, env_intensity=0.8, env_clamp=5.0)


def settings(render: dict) -> dict:
    """The render settings with the defaults filled in; raises for a
    setting whose non-default value the reference does not implement."""
    s = dict(DEFAULTS)
    s.update(render)
    for key, need in (("tonemap", "reinhard"), ("metal_vndf", True),
                      ("metal_mirror", False), ("cpu_transparency", False),
                      ("depth_term_normal_vis", False),
                      ("env_intensity", 0.8), ("env_clamp", 5.0)):
        if s[key] != need:
            raise NotImplementedError(f"reference: {key}={s[key]!r}")
    return s


# --- RNG ---------------------------------------------------------------------

def wang_hash(x: torch.Tensor) -> torch.Tensor:
    x = x & M32
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & M32
    return x ^ (x >> 15)


def rand01(state: torch.Tensor, dtype=torch.float32):
    state = wang_hash(state)
    u = (state & 0x00FFFFFF).to(torch.float32) * (1.0 / 16777216.0)
    return state, u.to(dtype)


# --- small vector helpers over (L, 3) ----------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    l2 = dot(v, v)
    ok = l2 > 0
    return v * torch.where(ok, torch.rsqrt(torch.where(ok, l2, 1.0)),
                           0.0)[:, None]


def normalize_or(v, fb):
    l2 = dot(v, v)
    ok = l2 > 0
    return torch.where(ok[:, None],
                       v * torch.rsqrt(torch.where(ok, l2, 1.0))[:, None], fb)


def cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


def reflect(i, n):
    return i - n * (2.0 * dot(i, n))[:, None]


def safe_sqrt(x):
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def make_onb(n):
    use_z = n[:, 2].abs() < 0.999
    up = torch.zeros_like(n)
    up[:, 0] = torch.where(use_z, 0.0, 1.0)
    up[:, 2] = 1.0 - up[:, 0]
    t = normalize(cross(up, n))
    return t, cross(n, t)


def from_onb(t, b, n, lx, ly, lz):
    return t * lx[:, None] + b * ly[:, None] + n * lz[:, None]


def safe_origin(p, n):
    eps = 1e-4 * torch.clamp(p.abs().amax(-1), min=1.0)
    return p + n * eps[:, None]


# --- the scene as the reference holds it --------------------------------------

class RefScene(NamedTuple):
    v0: torch.Tensor            # (T, 3) world-space triangles
    e1: torch.Tensor
    e2: torch.Tensor
    tri_mat: torch.Tensor       # (T,) int64
    sph_c: torch.Tensor         # (S, 3)
    sph_r: torch.Tensor         # (S,)
    sph_mat: torch.Tensor       # (S,) int64
    base: torch.Tensor          # (M, 3) materials
    emission: torch.Tensor      # (M, 3)
    metallic: torch.Tensor      # (M,)
    roughness: torch.Tensor
    ior: torch.Tensor
    dielectric: torch.Tensor    # (M,) bool
    lights: list                # (li (3,), direction to the light (3,))


def prepare(data, device) -> RefScene:
    """The reference's scene from the configuration's arrays
    (``portbench.scenes.SceneData``)."""
    v0s, v1s, v2s, mats = [], [], [], []
    for inst in data.instances:
        mesh = data.meshes[inst.mesh]
        xf = np.asarray(inst.world_from_object, np.float32)
        pos_h = np.concatenate([mesh.positions,
                                np.ones((len(mesh.positions), 1), np.float32)],
                               1)
        world = (pos_h @ xf.T)[:, :3].astype(np.float32)
        idx = mesh.indices
        v0s.append(world[idx[:, 0]])
        v1s.append(world[idx[:, 1]])
        v2s.append(world[idx[:, 2]])
        mid = mesh.material if inst.material is None else int(inst.material)
        mats.append(np.full(len(idx), mid, np.int64))
    if v0s:
        v0, v1, v2 = (np.concatenate(a) for a in (v0s, v1s, v2s))
    else:
        v0 = v1 = v2 = np.zeros((0, 3), np.float32)
    ms = data.materials
    if any(float(np.max(m.emission)) > 0 for m in ms):
        raise NotImplementedError("reference: emissive materials (NEE)")
    lights = []
    for lt in data.lights:
        li = np.asarray(lt["color"], np.float32) * np.float32(lt["intensity"])
        if lt["kind"] != "directional":
            raise NotImplementedError(f"reference: {lt['kind']} lights")
        d = np.asarray(lt["direction"], np.float32)
        lights.append((torch.as_tensor(li, device=device),
                       torch.as_tensor(-d / np.linalg.norm(d), device=device)))
    if data.environment != "procedural_sky":
        raise NotImplementedError(f"reference: {data.environment}")

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=device,
                               dtype=dtype)

    f32 = torch.float32
    return RefScene(
        v0=t(v0, f32), e1=t(v1 - v0, f32), e2=t(v2 - v0, f32),
        tri_mat=t(np.concatenate(mats) if mats else np.zeros(0, np.int64)),
        sph_c=t(data.sphere_center, f32), sph_r=t(data.sphere_radius, f32),
        sph_mat=t(data.sphere_material),
        base=t(np.stack([m.base_color for m in ms]), f32),
        emission=t(np.stack([m.emission for m in ms]), f32),
        metallic=t([m.metallic for m in ms], f32),
        roughness=t([m.roughness for m in ms], f32),
        ior=t([m.ior for m in ms], f32),
        dielectric=t([m.dielectric for m in ms], torch.bool),
        lights=lights)


def camera_basis(position, yaw: float, pitch: float, fov_degrees: float,
                 aspect: float) -> dict:
    """Pinhole basis of a yaw/pitch camera (Camera.cpp:32-50): position,
    forward, right, up and the half extents of the image plane, float64."""
    cy, sy = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
    cp, sp = math.cos(math.radians(pitch)), math.sin(math.radians(pitch))
    front = np.array([cy * cp, sp, sy * cp])
    forward = front / np.linalg.norm(front)
    right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    up = np.cross(right, forward)
    up = up / np.linalg.norm(up)
    half_h = math.tan(math.radians(fov_degrees) * 0.5)
    return dict(position=np.asarray(position, np.float64), forward=forward,
                right=right, up=up, half_width=half_h * aspect,
                half_height=half_h)


# --- intersection (float32) ----------------------------------------------------

def _tri_test(o, d, v0, e1, e2, tmin, tmax):
    """Lanes (L,) against triangles (K,) -> t (L, K) with INF where the
    test fails."""
    v0, e1, e2 = v0[None], e1[None], e2[None]
    dx, dy, dz = (d[:, i, None] for i in range(3))
    hx = dy * e2[..., 2] - dz * e2[..., 1]
    hy = dz * e2[..., 0] - dx * e2[..., 2]
    hz = dx * e2[..., 1] - dy * e2[..., 0]
    a = e1[..., 0] * hx + e1[..., 1] * hy + e1[..., 2] * hz
    big = a.abs() > MT_EPS
    inv = 1.0 / torch.where(big, a, 1.0)
    sx = o[:, 0, None] - v0[..., 0]
    sy = o[:, 1, None] - v0[..., 1]
    sz = o[:, 2, None] - v0[..., 2]
    u = inv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1[..., 2] - sz * e1[..., 1]
    qy = sz * e1[..., 0] - sx * e1[..., 2]
    qz = sx * e1[..., 1] - sy * e1[..., 0]
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz)
    ok = (big & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin[:, None])
          & (t < tmax[:, None]))
    return torch.where(ok, t, INF)


def _sph_test(o, d, c, r, tmin, tmax):
    oc = o[:, None, :] - c[None]
    b = (oc * d[:, None, :]).sum(-1)
    cc = (oc * oc).sum(-1) - r[None] * r[None]
    disc = b * b - cc
    sq = safe_sqrt(disc)
    t0, t1 = -b - sq, -b + sq
    lo, hi = tmin[:, None], tmax[:, None]
    t = torch.where((t0 > lo) & (t0 < hi), t0, t1)
    ok = (disc > 0) & (r[None] > 0) & (t > lo) & (t < hi)
    return torch.where(ok, t, INF)


class Hit(NamedTuple):
    t: torch.Tensor             # (L,) INF on a miss
    normal: torch.Tensor        # (L, 3) not normalised
    mat: torch.Tensor           # (L,) int64


def closest_hit(sc: RefScene, o, d, tmin, tmax) -> Hit:
    n = o.shape[0]
    t_tri = torch.full((n,), INF, device=o.device)
    tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    if sc.v0.shape[0]:
        t_tri, arg = _tri_test(o, d, sc.v0, sc.e1, sc.e2, tmin, tmax).min(1)
        tri = torch.where(torch.isfinite(t_tri), arg, -1)
    t_s = (_sph_test(o, d, sc.sph_c, sc.sph_r, tmin, tmax)
           if sc.sph_c.shape[0] else torch.full((n, 1), INF, device=o.device))
    ts, sarg = t_s.min(1)
    use_s = ts < t_tri
    t = torch.where(use_s, ts, t_tri)
    tri_s = tri.clamp(min=0)
    ng = (cross(sc.e1[tri_s], sc.e2[tri_s]) if sc.v0.shape[0]
          else torch.zeros_like(o))
    sm = sarg.clamp(max=max(sc.sph_c.shape[0] - 1, 0))
    if sc.sph_c.shape[0]:
        p = o + d * torch.where(use_s, ts, 0.0)[:, None]
        sn = (p - sc.sph_c[sm]) / torch.clamp(sc.sph_r[sm], min=1e-12)[:, None]
        normal = torch.where(use_s[:, None], sn, ng)
        mat = torch.where(use_s, sc.sph_mat[sm], sc.tri_mat[tri_s]
                          if sc.v0.shape[0] else 0)
    else:
        normal, mat = ng, sc.tri_mat[tri_s]
    return Hit(t, normal, mat)


def occluded(sc: RefScene, o, d, tmin, tmax) -> torch.Tensor:
    n = o.shape[0]
    blocked = torch.zeros(n, dtype=torch.bool, device=o.device)
    if sc.sph_c.shape[0]:
        blocked |= torch.isfinite(_sph_test(o, d, sc.sph_c, sc.sph_r, tmin,
                                            tmax)).any(1)
    if sc.v0.shape[0] == 0:
        return blocked
    t = _tri_test(o, d, sc.v0, sc.e1, sc.e2, tmin, tmax)
    return blocked | torch.isfinite(t).any(1)


# --- shading -----------------------------------------------------------------

def sky(d):
    """The procedural sky (EnvironmentManager.cpp:35-61) of normalised
    directions, times the environment intensity 0.8."""
    t = torch.clamp(0.5 * (d[:, 1] + 1.0), 0.0, 1.0)
    t = t * t * (3.0 - 2.0 * t)
    lo = torch.tensor([0.7, 0.8, 0.9], dtype=d.dtype, device=d.device)
    hi = torch.tensor([0.2, 0.4, 0.8], dtype=d.dtype, device=d.device)
    col = lo * (1.0 - t)[:, None] + hi * t[:, None]
    sun = np.array([0.3, 0.6, -0.8], np.float64)
    sun = torch.tensor((sun / np.linalg.norm(sun)).astype(np.float32),
                       dtype=d.dtype, device=d.device)
    sd = torch.clamp((d * sun).sum(-1), min=0.0)
    glow = sd ** 64.0 + (sd ** 8.0) * 0.3
    tint = torch.tensor([1.0, 0.9, 0.7], dtype=d.dtype, device=d.device)
    return (col + glow[:, None] * tint) * 0.8


def evaluate_brdf(n, v, l, base, metallic, roughness, ior):
    """Cook-Torrance GGX x NdotL (Material.cpp:84-117)."""
    h = normalize(v + l)
    cos_nv = torch.clamp(dot(n, v), min=0.0)
    cos_nl = torch.clamp(dot(n, l), min=0.0)
    cos_hv = torch.clamp(dot(h, v), min=0.0)
    cos_nh = torch.clamp(dot(n, h), min=0.0)
    r = torch.clamp(roughness, 0.02, 1.0)
    alpha = r * r
    a2 = alpha * alpha
    den = cos_nh * cos_nh * (a2 - 1.0) + 1.0
    dd = a2 / (PI * den * den)
    k = torch.clamp(torch.sqrt(torch.clamp(alpha, min=0.0)), 0.02, 1.0)
    k = (k + 1.0) * (k + 1.0) / 8.0
    g = (cos_nv / (cos_nv * (1.0 - k) + k)) * (cos_nl / (cos_nl * (1.0 - k)
                                                         + k))
    f0d = ((ior - 1.0) / (ior + 1.0)) ** 2
    f0 = base * metallic[:, None] + (f0d * (1.0 - metallic))[:, None]
    m = 1.0 - torch.clamp(cos_hv, 0.0, 1.0)
    f = f0 + (1.0 - f0) * ((m * m) * (m * m) * m)[:, None]
    spec = f * ((dd * g) / (4.0 * cos_nv * cos_nl + 1e-4))[:, None]
    diffuse = base * ((1.0 - metallic) / PI)[:, None]
    return ((1.0 - f) * diffuse + spec) * cos_nl[:, None]


def vndf_half(u1, u2, alpha, n, v):
    """Heitz 2014 visible-normal half vector (Material.cpp:145-199)."""
    t, b = make_onb(n)
    vh = normalize(torch.stack([dot(v, t), dot(v, b), dot(v, n)], -1))
    vs = normalize(torch.stack([alpha * vh[:, 0], alpha * vh[:, 1],
                                vh[:, 2]], -1))
    z = torch.zeros_like(vs)
    z[:, 2] = 1.0
    t1 = normalize(cross(z, vs))
    x = torch.zeros_like(vs)
    x[:, 0] = 1.0
    t1 = torch.where((vs[:, 2] < 0.9999)[:, None], t1, x)
    t2 = cross(vs, t1)
    rd = safe_sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = rd * torch.cos(phi)
    p2 = rd * torch.sin(phi)
    s = 0.5 * (1.0 + vs[:, 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = t1 * p1[:, None] + t2 * p2[:, None] + vs * p3[:, None]
    hl = normalize(torch.stack([alpha * nh[:, 0], alpha * nh[:, 1],
                                torch.clamp(nh[:, 2], min=0.0)], -1))
    return normalize(from_onb(t, b, n, hl[:, 0], hl[:, 1], hl[:, 2]))


def cosine_dir(n, u1, u2):
    r = safe_sqrt(u1)
    phi = 2.0 * PI * u2
    t, b = make_onb(n)
    return normalize(from_onb(t, b, n, r * torch.cos(phi), r * torch.sin(phi),
                              safe_sqrt(1.0 - u1)))


def trace_paths(sc: RefScene, s: dict, o, d, rng, sd=torch.float32):
    """Radiance (L, 3) float32 of the paths starting at (o, d) with RNG
    words `rng`; shading in dtype `sd`."""
    n = o.shape[0]
    dev = o.device
    thr = torch.ones(n, 3, dtype=sd, device=dev)
    rad = torch.zeros(n, 3, dtype=sd, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    depth = int(s["max_depth"])
    up = torch.zeros(n, 3, dtype=sd, device=dev)
    up[:, 1] = 1.0
    for bounce in range(depth):
        hit = closest_hit(sc, o, d, torch.zeros(n, device=dev),
                          torch.where(alive, 1e30, 0.0))
        found = torch.isfinite(hit.t)
        missed = alive & ~found
        surf = alive & found
        dn = d.to(sd)
        rad = rad + torch.where(missed[:, None], thr * sky(normalize(dn)),
                                0.0)
        m = hit.mat.clamp(0, sc.base.shape[0] - 1)
        base = sc.base[m].to(sd)
        metallic = sc.metallic[m].to(sd)
        rough = sc.roughness[m].to(sd)
        ior = sc.ior[m].to(sd)
        diel = sc.dielectric[m]
        ng = normalize_or(hit.normal.to(sd), up)
        entering = dot(dn, ng) < 0
        nrm = torch.where(entering[:, None], ng, -ng)
        p = o + d * torch.where(found, hit.t, 0.0)[:, None]
        diffuse_color = base * (1.0 - metallic)[:, None]
        is_metal = (metallic > 0.5) & ~diel
        is_diffuse = ~is_metal & ~diel
        rad = rad + torch.where(surf[:, None], thr * sc.emission[m].to(sd),
                                0.0)
        view = normalize(-dn)
        direct = surf if s["direct_light_dielectric"] else surf & ~diel
        n32 = nrm.float()
        so = safe_origin(p, n32)
        for li, ldir in sc.lights:
            ldir_l = ldir.expand(n, 3)
            cos = torch.clamp(dot(nrm, ldir_l.to(sd)), min=0.0)
            mask = direct & (cos > 0)
            if s["shadow_rays"]:
                tmax = torch.where(mask, 1e30 - s["hit_eps"], 0.0)
                mask = mask & ~occluded(sc, so, ldir_l,
                                        torch.full((n,), s["hit_eps"],
                                                   device=dev), tmax)
            brdf = evaluate_brdf(nrm, view, ldir_l.to(sd), base, metallic,
                                 rough, ior)
            rad = rad + torch.where(mask[:, None], thr * brdf * li.to(sd), 0.0)
        if bounce == depth - 1:
            alive = torch.zeros_like(alive)
            break
        # dielectric: Fresnel-chosen reflect or refract
        rng_d, xi_d = rand01(rng, sd)
        eta_i = torch.where(entering, 1.0, ior)
        eta_t = torch.where(entering, ior, 1.0)
        eta = eta_i / eta_t
        cos_i = torch.clamp(-dot(dn, nrm), -1.0, 1.0)
        r0 = ((eta_t - eta_i) / (eta_t + eta_i)) ** 2
        mm = 1.0 - torch.clamp(cos_i, 0.0, 1.0)
        fr = r0 + (1.0 - r0) * mm * mm * mm * mm * mm
        cosi = torch.clamp(-dot(nrm, dn), -1.0, 1.0)
        sin2t = eta * eta * torch.clamp(1.0 - cosi * cosi, min=0.0)
        can = sin2t <= 1.0
        cost = torch.where(sin2t < 1.0, safe_sqrt(1.0 - sin2t), 0.0)
        refr = normalize(dn * eta[:, None] + nrm * (eta * cosi - cost)[:, None])
        refl = normalize(reflect(dn, nrm))
        d_dir = torch.where((~can | (xi_d < fr))[:, None], refl, refr)
        d_org = p + d_dir.float() * s["ray_offset_dir"]
        # metal: VNDF half vector, mirror where it fails
        cos_nv_raw = dot(nrm, view)
        rng_m, u1 = rand01(rng, sd)
        rng_m, u2 = rand01(rng_m, sd)
        alpha = torch.clamp(rough, 0.02, 1.0) ** 2
        h = vndf_half(u1, u2, alpha, nrm, view)
        l_dir = normalize_or(reflect(-view, h), nrm)
        mirror = normalize_or(reflect(dn, nrm), nrm)
        ok = (cos_nv_raw > 0) & (dot(nrm, h) > 0) & (dot(nrm, l_dir) > 0)
        cos_nv = torch.clamp(cos_nv_raw, min=1e-6)
        cos_nl = torch.clamp(dot(nrm, l_dir), min=1e-6)
        cos_nh = torch.clamp(dot(nrm, h), min=1e-6)
        cos_vh = torch.clamp(dot(view, h), min=1e-6)
        mv = 1.0 - torch.clamp(cos_vh, 0.0, 1.0)
        f = base + (1.0 - base) * ((mv * mv) * (mv * mv) * mv)[:, None]
        kk = torch.clamp(torch.sqrt(torch.clamp(alpha, min=0.0)), 0.02, 1.0)
        kk = (kk + 1.0) * (kk + 1.0) / 8.0
        g = (cos_nv / (cos_nv * (1.0 - kk) + kk)) * (cos_nl / (cos_nl * (1.0 - kk)
                                                             + kk))
        scale = torch.clamp(g * cos_vh / cos_nh, 0.0, s["firefly_clamp"])
        m_dir = torch.where(ok[:, None], l_dir, mirror)
        m_thr = thr * torch.where(ok[:, None], f * scale[:, None], base)
        rng_m = torch.where(cos_nv_raw > 0, rng_m, rng)
        m_org = p + n32 * 1e-3
        # diffuse: cosine direction, Russian roulette
        rng_f, du1 = rand01(rng, sd)
        rng_f, du2 = rand01(rng_f, sd)
        f_dir = cosine_dir(nrm, du1, du2)
        survival = torch.clamp(diffuse_color.amax(-1), 1e-6, 1.0)
        rng_f, xi_rr = rand01(rng_f, sd)
        f_thr = thr * diffuse_color
        if bounce > s["rr_after"]:
            rr_dead = xi_rr >= survival
            f_thr = f_thr * (1.0 / survival)[:, None]
        else:
            rr_dead = torch.zeros_like(surf)
        new_dir = torch.where(diel[:, None], d_dir,
                              torch.where(is_metal[:, None], m_dir, f_dir))
        new_org = torch.where(diel[:, None], d_org,
                              torch.where(is_metal[:, None], m_org, so))
        new_thr = torch.where(diel[:, None], thr,
                              torch.where(is_metal[:, None], m_thr, f_thr))
        new_rng = torch.where(diel, rng_d, torch.where(is_metal, rng_m, rng_f))
        go = surf & ~(is_diffuse & rr_dead)
        o = torch.where(go[:, None], new_org, o)
        d = torch.where(go[:, None], new_dir.float(), d)
        thr = torch.where(go[:, None], new_thr, thr)
        rng = torch.where(surf, new_rng, rng)
        alive = go
        if not bool(alive.any()):
            break
    return rad.float()


def primary(s: dict, cam: dict, pixels, frame: int, sample: int, device):
    """(origins, directions, RNG words) of one sample of `pixels` in
    frame `frame` through the camera basis `cam`
    (``camera_basis``)."""
    w, h = int(s["width"]), int(s["height"])
    pix = pixels.to(torch.int64)
    f = ((frame & M32) * 9781 + 1) & M32
    rng = wang_hash(((pix + 1) & M32) ^ f)
    if int(s["spp"]) > 1 or sample:
        rng = wang_hash(rng ^ (((sample & M32) * 9781 + 1) & M32))
    if s["jitter"]:
        rng, ju = rand01(rng)
        rng, jv = rand01(rng)
    else:
        ju = jv = torch.full(pix.shape, 0.5, device=device)
    x = ((pix % w).to(torch.float32) + ju) / float(w)
    y = ((pix // w).to(torch.float32) + jv) / float(h)
    nx = (x - 0.5) * 2.0
    ny = -(y - 0.5) * 2.0

    def c(name):
        return torch.as_tensor(np.asarray(cam[name], np.float32),
                               device=device)

    hw, hh = c("half_width"), c("half_height")
    dvec = (c("forward")[None] + nx[:, None] * (hw * c("right"))[None]
            + ny[:, None] * (hh * c("up"))[None])
    d = normalize(dvec)
    o = c("position")[None].expand(len(pix), 3).contiguous()
    return o, d, rng


def render_sums(sc: RefScene, render: dict, cam: dict, pixels, frame0: int,
                frames: int, sd=torch.float32, lanes: int = 1 << 18):
    """The accumulated radiance sums (P, 3) of `pixels` over `frames`
    frames from RNG epoch `frame0`, as the renderer's accumulation holds
    them: each frame's mean over its spp samples, times spp, added in frame
    order.  Paths run in blocks of about `lanes` lanes."""
    s = settings(render)
    spp = int(s["spp"])
    dev = sc.base.device
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=dev)
    p = pixels.shape[0]
    acc = torch.zeros(p, 3, dtype=torch.float32, device=dev)
    per = max(1, lanes // max(p * spp, 1))
    for f0 in range(0, frames, per):
        fs = list(range(f0, min(frames, f0 + per)))
        os, ds, rs = [], [], []
        for f in fs:
            for smp in range(spp):
                o, d, r = primary(s, cam, pixels, frame0 + f, smp, dev)
                os.append(o)
                ds.append(d)
                rs.append(r)
        rad = trace_paths(sc, s, torch.cat(os), torch.cat(ds), torch.cat(rs),
                          sd).reshape(len(fs), spp, p, 3)
        for i in range(len(fs)):
            img = rad[i, 0]
            for smp in range(1, spp):
                img = img + rad[i, smp]
            acc = acc + (img / spp) * spp
    return acc


def resolve(acc, count: float, exposure: float = 2.2, gamma: float = 2.2):
    """Linear sums -> display values in [0, 1] (exposure, Reinhard, gamma)."""
    inv = 1.0 / max(float(count), 1e-30) if count > 0 else 0.0
    c = torch.clamp(acc * inv, min=0.0) * exposure
    c = c / (1.0 + c)
    return torch.clamp(torch.pow(torch.clamp(c, min=0.0), 1.0 / gamma), 0.0,
                       1.0)
