"""The canonical light transport over component-SoA path lanes.

The counterpart of ``spt_tpu.integrators.transport``: one per-bounce shading
function with the semantics of the reference's GPU wavefront shade kernel
(device_programs.cu:315-690) plus the planned fixes, each a RenderConfig
toggle — shadow rays, emission, Russian roulette, NdotL applied once, the
tagged dielectric as a delta BSDF.  Every branch is computed for every lane
and selected, in the same order as the JAX version, so the per-lane RNG
streams and the float32 rounding match it.

This is also the plain PyTorch version that ``ops/cuda_bounce`` holds its
CUDA kernel against.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spt_tpu_torch.camera import CameraRays
from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.env import Environment, environment_color_v
from spt_tpu_torch.lights import DeviceLights, sample_light_v
from spt_tpu_torch.materials import (gather_v, tex_res_of, unpack_color,
                                     unpack_mr)
from spt_tpu_torch.ops import intersect as isect
from spt_tpu_torch.ops import rng as rng_ops
from spt_tpu_torch.ops import sampling
from spt_tpu_torch.ops import vec3 as v3
from spt_tpu_torch.ops.vec3 import Vec3
from spt_tpu_torch.scene.flatten import DeviceScene


class PathState(NamedTuple):
    """SoA path state (LaunchParams.h:16-25 as component lane tensors)."""

    origin: Vec3
    direction: Vec3
    throughput: Vec3
    radiance: Vec3
    rng: torch.Tensor          # (N,) int64 holding uint32 words
    alive: torch.Tensor        # (N,) bool
    # True while hit emission should be counted: camera rays and dielectric
    # continuations (NEE'd scatters clear it).
    emission_ok: torch.Tensor  # (N,) bool

    @property
    def num_paths(self) -> int:
        return self.rng.shape[0]


def gen_primary(
    cfg: RenderConfig,
    camera: CameraRays,
    frame_index,
    sample_index: int = 0,
    row0: int = 0,
    rows: Optional[int] = None,
) -> PathState:
    """Primary ray generation (__raygen__gen_primary,
    device_programs.cu:239-274) on the camera's device.

    Rays go through pixel centers unless cfg.jitter, in which case a
    per-(frame, sample) subpixel offset is drawn from the path RNG.
    `row0`/`rows` select a horizontal band of the image (pixel-band
    sharding, ``parallel/sharding``): lanes carry GLOBAL pixel indices in
    row-major order, so the RNG streams and ray directions of a band are
    those of the same pixels in the whole frame, bit for bit."""
    return primary_lanes(cfg, camera, frame_index, sample_index,
                         cfg.spp > 1 or bool(sample_index), row0, rows)


def primary_lanes(cfg: RenderConfig, camera: CameraRays, frame_index,
                  sample_index, per_sample: bool, row0: int = 0,
                  rows: Optional[int] = None) -> PathState:
    """gen_primary with the per-sample seeding chosen by the caller;
    `sample_index` may be a per-lane tensor (path regeneration,
    wavefront.py:761-799)."""
    w, h = cfg.width, cfg.height
    n = w * (h if rows is None else rows)
    device = camera.position.device
    pixel = row0 * w + torch.arange(n, dtype=torch.int64, device=device)
    px = (pixel % w).to(torch.float32)
    py = (pixel // w).to(torch.float32)

    state = rng_ops.seed_paths(pixel, frame_index)
    if per_sample:
        state = rng_ops.seed_samples(state, sample_index)

    if cfg.jitter:
        state, ju, jv = rng_ops.next_float2(state)
    else:
        ju = jv = 0.5

    x = (px + ju) / float(w)
    y = (py + jv) / float(h)
    direction = camera.ray_directions_v(x, y)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    zeros = torch.zeros(n, dtype=torch.float32, device=device)

    return PathState(
        origin=Vec3(camera.position[0] + zeros,
                    camera.position[1] + zeros,
                    camera.position[2] + zeros),
        direction=direction,
        throughput=Vec3(ones, ones, ones),
        radiance=Vec3(zeros, zeros, zeros),
        rng=state,
        alive=torch.ones(n, dtype=torch.bool, device=device),
        emission_ok=torch.ones(n, dtype=torch.bool, device=device),
    )


def trace_bounce(scene: DeviceScene, ps: PathState,
                 plain: bool = False) -> isect.HitV:
    """Trace (__raygen__trace, cu:279-310).  Dead lanes trace with
    tmax = 0, so they hit nothing.  `plain` keeps a mesh scene's trace on
    the cluster tracer's plain version (intersect.intersect_v)."""
    tmax = torch.where(ps.alive, 1e30, 0.0)
    return isect.intersect_v(scene, ps.origin, ps.direction, tmin=0.0,
                             tmax=tmax, plain=plain)


def shade(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    ps: PathState,
    hit: isect.HitV,
    bounce,
    is_last,
) -> PathState:
    """Shade (__raygen__shade, cu:315-690) with the environment term applied
    to the lanes that missed."""
    new_ps, missed = shade_core(cfg, scene, lights, ps, hit, bounce, is_last)
    env_c = environment_color_v(env, ps.direction, need=missed)
    zero = torch.zeros_like(missed, dtype=torch.float32)
    radiance = new_ps.radiance + v3.where(
        missed, ps.throughput * env_c, Vec3(zero, zero, zero))
    return new_ps._replace(radiance=radiance)


def _bilinear_setup(uvx, uvy, res: int):
    """Wrap the uv (glTF REPEAT) and sample at texel centres
    (transport.py:165-182).  Returns ((x0, x1, y0, y1) int32 texel
    coordinates, (wx, wy) fractional weights)."""
    fu = uvx - torch.floor(uvx)
    fv = uvy - torch.floor(uvy)
    sx = fu * float(res) - 0.5
    sy = fv * float(res) - 0.5
    x0 = torch.floor(sx).to(torch.int32)
    y0 = torch.floor(sy).to(torch.int32)
    wx = sx - x0.to(torch.float32)
    wy = sy - y0.to(torch.float32)
    x0w = torch.where(x0 < 0, x0 + res, x0)
    y0w = torch.where(y0 < 0, y0 + res, y0)
    x1 = torch.where(x0 + 1 >= res, 0, x0 + 1)
    y1 = torch.where(y0 + 1 >= res, 0, y0 + 1)
    return (x0w, x1, y0w, y1), (wx, wy)


def sample_texture_v(textures, tex_id, uvx, uvy):
    """Bilinear sample of the packed table (n_tex, res^2, 2) int32
    (transport.py:185-222): four taps, each one row of the table, texel
    (ty, tx) at row ty * res + tx.  Returns (rgb Vec3, roughness_mult,
    metallic_mult); lanes with tex_id < 0 return all-1 multipliers.  The
    plain version of the texture sampler the kernels inline (K6)."""
    res = tex_res_of(textures)
    (x0, x1, y0, y1), (wx, wy) = _bilinear_setup(uvx, uvy, res)
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    flat_tab = textures.reshape(-1, 2)
    acc = [torch.zeros_like(uvx) for _ in range(5)]
    for xi, wxi in ((x0, 1.0 - wx), (x1, wx)):
        for yi, wyi in ((y0, 1.0 - wy), (y1, wy)):
            texel = flat_tab[tid * (res * res) + (yi * res + xi).to(torch.int64)]
            w = wxi * wyi
            r, g, b = unpack_color(texel[:, 0])
            ro, me = unpack_mr(texel[:, 1])
            for i, v in enumerate((r, g, b, ro, me)):
                acc[i] = acc[i] + w * v
    has = tex_id >= 0
    vals = [torch.where(has, a, 1.0) for a in acc]
    return Vec3(vals[0], vals[1], vals[2]), vals[3], vals[4]


# Elements of one plane of shade_core's light loop, by device type: it
# shades G lights of N lanes at once in (G, N) planes, the shadow test's
# (G * N, C) where that test holds a lane against C primitives at once, G =
# LIGHT_PLANE // (N * C) (at least one).  A captured body then holds ~1 400
# nodes a group on the default scene and one add a light, not ~1 400 a
# light (ROADMAP.md section 3, fault 3): on the card 38 groups under 1 200
# lights in the 1920x1080 compact chunk's 519 168 lanes, 150 in the regen
# step's 2 073 600.  On the CPU, where a plane past the caches runs a few
# times slower, the planes stay at 4 MB.  The groups change no bit.
LIGHT_PLANE = {"cuda": 1 << 24, "cpu": 1 << 20}


def light_group(lights: DeviceLights, lanes: int, columns: int = 1,
                device="cuda") -> int:
    """The lights shade_core takes at once on `lanes` lanes of `device`,
    its shadow test `columns` primitives wide
    (``intersect.occluded_columns``)."""
    plane = LIGHT_PLANE.get(torch.device(device).type, LIGHT_PLANE["cpu"])
    return max(1, min(lights.count, plane // (max(lanes, 1) * columns)))


def shade_core(
    cfg: RenderConfig,
    scene: DeviceScene,
    lights: DeviceLights,
    ps: PathState,
    hit: isect.HitV,
    bounce: int,
    is_last: bool,
    plain: bool = False,
):
    """Everything in shade except the environment color: emission, direct
    lighting with shadow rays, NEE, and the scatter branches.  Returns
    (new_state, missed_mask) — the caller owes `throughput * env(direction)`
    to every missed lane (those lanes keep their direction and die here).
    Dead lanes come back unchanged.  `plain` as in trace_bounce."""
    shape = ps.rng.shape
    device = ps.rng.device
    alive = ps.alive
    missed = alive & ~hit.hit_mask
    surf = alive & hit.hit_mask

    radiance = ps.radiance

    # --- surface setup --------------------------------------------------------
    mat = gather_v(scene.materials, hit.mat_id)
    if scene.textures is not None and hit.uvx is not None:
        # miss lanes sample nothing (tex_id -1); the texture channels
        # multiply the material factors (transport.py:257-273)
        tex_rgb, tex_rough, tex_metal = sample_texture_v(
            scene.textures, torch.where(hit.hit_mask, mat.tex_id, -1),
            hit.uvx, hit.uvy)
        mat = mat._replace(
            base_color=mat.base_color * tex_rgb,
            roughness=torch.clamp(mat.roughness * tex_rough, 0.01, 1.0),
            metallic=torch.clamp(mat.metallic * tex_metal, 0.0, 1.0),
        )
    up = Vec3.full((0.0, 1.0, 0.0), shape, device)
    ng = v3.normalize_or(hit.normal, up)
    n, entering = v3.faceforward(ng, ps.direction)
    t_safe = torch.where(hit.hit_mask, hit.t, 0.0)
    p = ps.origin + ps.direction * t_safe

    diffuse_color = mat.base_color * (1.0 - mat.metallic)
    is_dielectric = mat.mat_type == 1
    is_metal = (mat.metallic > 0.5) & ~is_dielectric
    is_diffuse = ~is_metal & ~is_dielectric

    # --- emission (wf_pt_cpu.cpp:121-124) --------------------------------------
    nee_on = cfg.nee and scene.emitters is not None
    zl = torch.zeros(shape, dtype=torch.float32, device=device)
    zero3 = Vec3(zl, zl, zl)
    emit_mask = (surf & ps.emission_ok) if nee_on else surf
    radiance = radiance + v3.where(emit_mask, ps.throughput * mat.emission, zero3)

    # --- direct lighting over the light table ---------------------------------
    direct_ok = surf if cfg.direct_light_dielectric else (surf & ~is_dielectric)
    view = v3.safe_normalize(-ps.direction)
    front = torch.ones(shape, dtype=torch.bool, device=device)
    if cfg.shadow_rays:
        shadow_o = isect.safe_origin_v(p, n, front)
    rad = torch.stack(tuple(radiance))
    group = light_group(lights, shape[0], isect.occluded_columns(
        scene, device, plain) if cfg.shadow_rays else 1, device)
    for a in range(0, lights.count, group):
        # lights a..a+g-1 at once, (g, N) planes; each lane's sum stays in
        # light order
        g = min(group, lights.count - a)
        li_rad, ldir, ldist, lactive = sample_light_v(lights,
                                                      slice(a, a + g), p)
        cos_theta = torch.clamp(v3.dot(n, ldir), min=0.0)
        contrib_mask = direct_ok & lactive & (cos_theta > 0.0)
        if cfg.shadow_rays:
            tmax = torch.where(contrib_mask, ldist - cfg.hit_eps, 0.0)
            blocked = isect.occluded_v(
                scene, Vec3(*(c.expand(g, -1).reshape(-1) for c in shadow_o)),
                Vec3(*(c.reshape(-1) for c in ldir)), tmin=cfg.hit_eps,
                tmax=tmax.reshape(-1), plain=plain,
            ).reshape(g, -1)
            contrib_mask = contrib_mask & ~blocked
        brdf_nl = sampling.evaluate_brdf_v(
            n, view, ldir, mat.base_color, mat.metallic, mat.roughness, mat.ior
        )
        contrib = torch.stack(tuple(v3.where(
            contrib_mask, ps.throughput * brdf_nl * li_rad, zero3
        )))
        for j in range(g):
            rad = rad + contrib[:, j]
    radiance = Vec3(*rad.unbind(0))

    # --- NEE toward emissive triangles (area lights) --------------------------
    rng = ps.rng
    if nee_on:
        emitters = scene.emitters
        e_count = emitters.count
        rng, xe = rng_ops.next_float(rng)
        rng, xu1 = rng_ops.next_float(rng)
        rng, xu2 = rng_ops.next_float(rng)
        # uniform pick: truncate toward zero, then clamp (transport.py:327)
        pick = torch.clamp((xe * e_count).to(torch.int32), 0, e_count - 1).long()

        def g3(tab):
            return Vec3(tab[pick, 0], tab[pick, 1], tab[pick, 2])

        ev0, ee1, ee2, ele = (g3(emitters.v0), g3(emitters.e1),
                              g3(emitters.e2), g3(emitters.le))
        earea = emitters.area[pick]
        # uniform point on the triangle
        su = sampling.safe_sqrt(xu1)
        b1 = 1.0 - su
        b2 = xu2 * su
        pe = ev0 + ee1 * b1 + ee2 * b2
        to_e = pe - p
        dist = torch.clamp(v3.length(to_e), min=1e-6)
        wi = to_e * (1.0 / dist)
        n_e = v3.safe_normalize(v3.cross(ee1, ee2))
        cos_e = torch.abs(v3.dot(n_e, wi))          # two-sided emitters
        cos_s = v3.dot(n, wi)
        nee_mask = surf & ~is_dielectric & (cos_s > 0.0) & (cos_e > 1e-6)
        if cfg.shadow_rays:
            so = isect.safe_origin_v(p, n, front)
            tmax_e = torch.where(nee_mask, dist * (1.0 - 1e-3), 0.0)
            blocked = isect.occluded_v(scene, so, wi, tmin=cfg.hit_eps,
                                       tmax=tmax_e, plain=plain)
            nee_mask = nee_mask & ~blocked
        brdf_nl = sampling.evaluate_brdf_v(
            n, view, wi, mat.base_color, mat.metallic, mat.roughness, mat.ior
        )
        # pdf = 1 / (E * area); geometric term cos_e / dist^2
        weight = (cos_e / (dist * dist)) * (earea * float(e_count))
        radiance = radiance + v3.where(
            nee_mask, ps.throughput * brdf_nl * ele * weight, zero3
        )

    # --- scatter: compute all three branches, select ---------------------------

    # Dielectric (cu:498-543): Fresnel-probabilistic reflect/refract, delta BSDF.
    rng_d, xi_d = rng_ops.next_float(rng)
    eta_i = torch.where(entering, 1.0, mat.ior)
    eta_t = torch.where(entering, mat.ior, 1.0)
    eta = eta_i / eta_t
    cos_i = torch.clamp(-v3.dot(ps.direction, n), -1.0, 1.0)
    fr = sampling.fresnel_schlick_eta(cos_i, eta_i, eta_t)
    refr_dir, can_refract = v3.refract(ps.direction, n, eta)
    reflect_dir = v3.safe_normalize(v3.reflect(ps.direction, n))
    d_dir = v3.where(~can_refract | (xi_d < fr), reflect_dir, refr_dir)
    d_org = p + d_dir * cfg.ray_offset_dir
    d_thr = ps.throughput  # delta BSDF, throughput unchanged (cu:537)
    if cfg.cpu_transparency:
        # quirk 7 (PathTracer.cpp:177-209): reflection x (1-transparency),
        # refraction x transparency, TIR x 1
        w_d = torch.where(xi_d < fr, 1.0 - mat.transparency,
                          torch.where(can_refract, mat.transparency, 1.0))
        d_thr = d_thr * w_d

    # Metal (cu:545-666): GGX sampling; degenerate cases mirror-bounce.
    cos_nv_raw = v3.dot(n, view)
    rng_m, u1, u2 = rng_ops.next_float2(rng)
    alpha = sampling.roughness_to_alpha(mat.roughness)
    if cfg.metal_vndf and not cfg.metal_mirror:
        h = sampling.ggx_sample_vndf_v(u1, u2, alpha, n, view)
    else:
        h = sampling.ggx_sample_half_vector_v(u1, u2, alpha, n)
    cos_nh_raw = v3.dot(n, h)
    l_dir = v3.normalize_or(v3.reflect(-view, h), n)
    cos_nl_raw = v3.dot(n, l_dir)
    mirror_dir = v3.normalize_or(v3.reflect(ps.direction, n), n)

    ggx_ok = (cos_nv_raw > 0.0) & (cos_nh_raw > 0.0) & (cos_nl_raw > 0.0)
    if cfg.metal_mirror:
        # CPU megakernel quirk 6: perfect mirror (PathTracer.cpp:170-176)
        m_dir = mirror_dir
        m_thr = ps.throughput * mat.base_color * mat.metallic
        rng_m_out = rng
    elif cfg.metal_vndf:
        # Heitz VNDF estimator weights (Material.cpp:201-227)
        cos_nv = torch.clamp(cos_nv_raw, min=1e-6)
        cos_nl = torch.clamp(cos_nl_raw, min=1e-6)
        cos_nh = torch.clamp(cos_nh_raw, min=1e-6)
        cos_vh = torch.clamp(v3.dot(view, h), min=1e-6)
        f = sampling.fresnel_schlick_v(cos_vh, mat.base_color)
        g = sampling.g_smith_cpu(cos_nv, cos_nl, alpha)
        scale = torch.clamp(g * cos_vh / cos_nh, 0.0, cfg.firefly_clamp)
        m_dir = v3.where(ggx_ok, l_dir, mirror_dir)
        m_thr = ps.throughput * v3.where(ggx_ok, f * scale, mat.base_color)
        rng_m_out = torch.where(cos_nv_raw > 0.0, rng_m, rng)
    else:
        cos_nv = torch.clamp(cos_nv_raw, min=1e-6)
        cos_nl = torch.clamp(cos_nl_raw, min=1e-6)
        cos_nh = torch.clamp(cos_nh_raw, min=1e-6)
        cos_vh = torch.clamp(v3.dot(view, h), min=0.0)
        f = sampling.fresnel_schlick_v(cos_vh, mat.base_color)
        g = sampling.g_smith_gpu(cos_nl, cos_nv, alpha)
        scale = torch.clamp(g * cos_vh / (cos_nv * cos_nh), 0.0, cfg.firefly_clamp)
        m_dir = v3.where(ggx_ok, l_dir, mirror_dir)
        m_thr = ps.throughput * v3.where(ggx_ok, f * scale, mat.base_color)
        # the GPU's cosNV<=0 fallback bails before drawing randoms (cu:554-576)
        rng_m_out = torch.where(cos_nv_raw > 0.0, rng_m, rng)
    m_org = p + n * 1e-3  # offset along the normal (cu:530,608)

    # Diffuse (cu:668-690 + wf_pt_cpu.cpp:226-247): cosine sample + RR.
    rng_f, du1, du2 = rng_ops.next_float2(rng)
    f_dir = sampling.cosine_sample_v(n, du1, du2)
    f_org = isect.safe_origin_v(p, n, front)
    survival = torch.clamp(v3.max_component(diffuse_color), 1e-6, 1.0)
    rng_f, xi_rr = rng_ops.next_float(rng_f)
    # bounce and is_last are Python values, or per-lane tensors (regen)
    rr_on = bounce > cfg.rr_after
    f_thr = ps.throughput * diffuse_color
    if isinstance(rr_on, torch.Tensor):
        rr_dead = rr_on & (xi_rr >= survival)
        f_thr = v3.where(rr_on, f_thr * (1.0 / survival), f_thr)
    elif rr_on:
        rr_dead = xi_rr >= survival
        f_thr = f_thr * (1.0 / survival)
    else:
        rr_dead = torch.zeros_like(surf)

    # --- select the branch per lane -------------------------------------------
    new_dir = v3.where(is_dielectric, d_dir, v3.where(is_metal, m_dir, f_dir))
    new_org = v3.where(is_dielectric, d_org, v3.where(is_metal, m_org, f_org))
    new_thr = v3.where(is_dielectric, d_thr, v3.where(is_metal, m_thr, f_thr))
    new_rng = torch.where(is_dielectric, rng_d,
                          torch.where(is_metal, rng_m_out, rng_f))

    scatter_alive = surf & ~(is_diffuse & rr_dead)
    if isinstance(is_last, torch.Tensor):
        scatter_alive = scatter_alive & ~is_last
        last_surf = surf & is_last
    elif is_last:
        scatter_alive = torch.zeros_like(surf)
        last_surf = surf
    else:
        last_surf = None

    # Quirk 5 (optional): the GPU paints diffuse * normal-vis at max depth
    # (cu:420-440) instead of going black.
    if cfg.depth_term_normal_vis and last_surf is not None:
        nvis = (v3.normalize_or(ng, up) + 1.0) * 0.5
        term_c = ps.throughput * diffuse_color * nvis
        radiance = radiance + v3.where(last_surf, term_c, zero3)

    if nee_on:
        # dielectric continuations keep counting emission; NEE'd scatters
        # must not double count it on the next hit
        new_emission_ok = (scatter_alive & is_dielectric) | (
            ~scatter_alive & ps.emission_ok)
    else:
        new_emission_ok = ps.emission_ok

    return PathState(
        origin=v3.where(scatter_alive, new_org, ps.origin),
        direction=v3.where(scatter_alive, new_dir, ps.direction),
        throughput=v3.where(scatter_alive, new_thr, ps.throughput),
        radiance=radiance,
        rng=torch.where(surf, new_rng, ps.rng),
        alive=scatter_alive,
        emission_ok=new_emission_ok,
    ), missed


def bounce_loop(cfg: RenderConfig, scene: DeviceScene, lights: DeviceLights,
                ps: PathState, start_bounce: int = 0, plain: bool = False,
                while_loop=None):
    """The masked depth loop: bounces [start_bounce, max_depth), each
    ``trace_bounce`` + ``shade_core`` over every lane, tracking the lanes
    that missed.  `while_loop` None runs every bounce, with no host read
    (dead lanes come back unchanged): ``cuda_bounce.fused_frame_reference``.
    Otherwise it is a ``while_loop(cond_fn, body_fn, carry)`` that stops
    once no lane lives: the unfused route (wavefront.py:683-707).  `plain`
    as in trace_bounce.

    Returns (path state, missed_ever (N,) bool, rays per bounce
    (max_depth,) int64, zero below start_bounce; bounces run).  The caller
    owes `throughput * env(direction)` to the lanes that missed."""
    device = ps.rng.device
    depths = torch.arange(cfg.max_depth, device=device)

    def more(carry):
        b, ps = carry[:2]
        return (b < cfg.max_depth) & ps.alive.any()

    def bounce(carry):
        b, ps, rays, missed_ever = carry
        rays = torch.where(depths == b, ps.alive.sum(), rays)
        hit = trace_bounce(scene, ps, plain=plain)
        ps, missed = shade_core(cfg, scene, lights, ps, hit, b,
                                b == cfg.max_depth - 1, plain=plain)
        return b + 1, ps, rays, missed_ever | missed

    carry = (torch.full((), start_bounce, dtype=torch.int64, device=device),
             ps, torch.zeros(cfg.max_depth, dtype=torch.int64, device=device),
             torch.zeros_like(ps.alive))
    if while_loop is None:
        for _ in range(start_bounce, cfg.max_depth):
            carry = bounce(carry)
    else:
        carry = while_loop(more, bounce, carry)
    b, ps, rays, missed_ever = carry
    return ps, missed_ever, rays, b - start_bounce
