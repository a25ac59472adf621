"""BRDF math and direction sampling over Vec3 lanes.

The ``_v`` forms of ``spt_tpu.ops.sampling`` that ``shade_core`` calls, in
the same evaluation order:

- Cook-Torrance GGX evaluation (Material.cpp:84-117);
- GGX NDF half-vector sampling (device_programs.cu:183-211);
- GGX VNDF (Heitz 2014) sampling (Material.cpp:119-234);
- cosine hemisphere sampling (device_programs.cu:134-143);
- Schlick Fresnel in its eta-pair and F0-vector forms.
"""

from __future__ import annotations

import torch

from spt_tpu_torch.ops import math3d as m3
from spt_tpu_torch.ops import vec3 as v3

PI = 3.14159265358979323846

safe_sqrt = m3.safe_sqrt


# --- Fresnel -----------------------------------------------------------------

def fresnel_schlick_eta(cos_i: torch.Tensor, eta_i: torch.Tensor,
                        eta_t: torch.Tensor) -> torch.Tensor:
    """R0 from the eta pair (the GPU dielectric branch, device_programs.cu:511-516)."""
    r0 = (eta_t - eta_i) / (eta_t + eta_i)
    r0 = r0 * r0
    m = 1.0 - torch.clamp(cos_i, 0.0, 1.0)
    return r0 + (1.0 - r0) * m * m * m * m * m


def fresnel_schlick_v(cos_vh: torch.Tensor, f0: v3.Vec3) -> v3.Vec3:
    """F0-vector Schlick (device_programs.cu:175-181), Vec3 form."""
    m = 1.0 - torch.clamp(cos_vh, 0.0, 1.0)
    m5 = (m * m) * (m * m) * m
    return f0 + (1.0 - f0) * m5


# --- GGX microfacet ----------------------------------------------------------

def roughness_to_alpha(roughness: torch.Tensor) -> torch.Tensor:
    """Perceptual roughness r in [0.02, 1] -> alpha = r^2 (Material.cpp:96-98)."""
    r = torch.clamp(roughness, 0.02, 1.0)
    return r * r


def d_ggx(cos_nh: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Trowbridge-Reitz NDF (Material.cpp:32-43 / device_programs.cu:155-162)."""
    cos_nh = torch.clamp(cos_nh, min=0.0)
    a2 = alpha * alpha
    denom = cos_nh * cos_nh * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def _g1_schlick(cos_x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return cos_x / (cos_x * (1.0 - k) + k)


def g_smith_cpu(cos_nv: torch.Tensor, cos_nl: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
    """Smith G as Material::geometrySmith (Material.cpp:57-66):
    k derived from r = clamp(sqrt(alpha), 0.02, 1)."""
    r = torch.clamp(torch.sqrt(torch.clamp(alpha, min=0.0)), 0.02, 1.0)
    k = (r + 1.0) * (r + 1.0) / 8.0
    return (_g1_schlick(torch.clamp(cos_nv, min=0.0), k)
            * _g1_schlick(torch.clamp(cos_nl, min=0.0), k))


def g_smith_gpu(cos_nl: torch.Tensor, cos_nv: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
    """Smith G as the GPU smithGGX (device_programs.cu:164-173):
    k = (alpha+1)^2 / 8 — it feeds alpha, not r, as the reference does."""
    a = alpha + 1.0
    k = a * a * 0.125
    return _g1_schlick(cos_nl, k) * _g1_schlick(cos_nv, k)


def evaluate_brdf_v(
    n: v3.Vec3,
    v: v3.Vec3,
    l: v3.Vec3,
    base_color: v3.Vec3,
    metallic: torch.Tensor,
    roughness: torch.Tensor,
    ior: torch.Tensor,
) -> v3.Vec3:
    """Cook-Torrance BRDF * NdotL (Material.cpp:84-117), Vec3 form."""
    h = v3.safe_normalize(v + l)
    cos_nv = torch.clamp(v3.dot(n, v), min=0.0)
    cos_nl = torch.clamp(v3.dot(n, l), min=0.0)
    cos_hv = torch.clamp(v3.dot(h, v), min=0.0)
    cos_nh = torch.clamp(v3.dot(n, h), min=0.0)

    alpha = roughness_to_alpha(roughness)
    d = d_ggx(cos_nh, alpha)
    g = g_smith_cpu(cos_nv, cos_nl, alpha)

    f0_diel = ((ior - 1.0) / (ior + 1.0)) ** 2
    f0 = base_color * metallic + f0_diel * (1.0 - metallic)
    f = fresnel_schlick_v(cos_hv, f0)

    spec_scale = (d * g) / (4.0 * cos_nv * cos_nl + 1e-4)
    specular = f * spec_scale
    kd = 1.0 - f
    diffuse = base_color * diffuse_scale(metallic)
    return (kd * diffuse + specular) * cos_nl


def diffuse_scale(metallic: torch.Tensor) -> torch.Tensor:
    """(1 - metallic) / pi as a true float32 division on every device.

    PI is a 0-dim tensor on metallic's device: PyTorch's CUDA kernel
    multiplies by the reciprocal when the divisor is a Python scalar (or a
    CPU scalar tensor), which departs from the kernels and from
    spt_tpu/ops/sampling.py:247 by up to a few ulp."""
    return (1.0 - metallic) / metallic.new_full((), PI)


# --- Direction sampling ------------------------------------------------------

def cosine_sample_v(n: v3.Vec3, u1: torch.Tensor, u2: torch.Tensor) -> v3.Vec3:
    """Cosine hemisphere around n (device_programs.cu:668-681), Vec3 form."""
    r = safe_sqrt(u1)
    phi = 2.0 * PI * u2
    lx = r * torch.cos(phi)
    ly = r * torch.sin(phi)
    lz = safe_sqrt(1.0 - u1)
    t, b = v3.make_onb(n)
    return v3.safe_normalize(v3.from_onb(t, b, n, lx, ly, lz))


def ggx_sample_half_vector_v(
    u1: torch.Tensor, u2: torch.Tensor, alpha: torch.Tensor, n: v3.Vec3
) -> v3.Vec3:
    """GGX NDF half-vector (device_programs.cu:183-211), Vec3 form."""
    a2 = alpha * alpha
    phi = 2.0 * PI * u1
    denom = 1.0 + (a2 - 1.0) * u2
    cos_t = safe_sqrt((1.0 - u2) / denom)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    lx = sin_t * torch.cos(phi)
    ly = sin_t * torch.sin(phi)
    t, b = v3.make_onb(n)
    h = v3.from_onb(t, b, n, lx, ly, cos_t)
    return v3.normalize_or(h, n)


def ggx_sample_vndf_v(
    u1: torch.Tensor, u2: torch.Tensor, alpha: torch.Tensor,
    n: v3.Vec3, v: v3.Vec3,
) -> v3.Vec3:
    """Heitz-2014 VNDF sample (Material.cpp:145-199), Vec3 form."""
    t, b = v3.make_onb(n)
    vh = v3.safe_normalize(v3.Vec3(v3.dot(v, t), v3.dot(v, b), v3.dot(v, n)))
    vs = v3.safe_normalize(v3.Vec3(alpha * vh.x, alpha * vh.y, vh.z))
    zero, one = torch.zeros_like(vs.x), torch.ones_like(vs.x)
    t1 = v3.safe_normalize(v3.cross(v3.Vec3(zero, zero, one), vs))
    t1 = v3.where(vs.z < 0.9999, t1, v3.Vec3(one, zero, zero))
    t2 = v3.cross(vs, t1)
    r_disk = safe_sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r_disk * torch.cos(phi)
    p2 = r_disk * torch.sin(phi)
    s = 0.5 * (1.0 + vs.z)
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = t1 * p1 + t2 * p2 + vs * p3
    h_local = v3.safe_normalize(
        v3.Vec3(alpha * nh.x, alpha * nh.y, torch.clamp(nh.z, min=0.0))
    )
    return v3.safe_normalize(v3.from_onb(t, b, n, h_local.x, h_local.y, h_local.z))
