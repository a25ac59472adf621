"""Carry the JAX package's state into the port's tensors.

Every function takes an object of the JAX package (a ``DeviceScene``,
``DeviceLights``, ``Environment``, ``CameraRays``, ``PathState`` or
``RenderState``) or anything with the same attributes, reads its leaves
through ``numpy.asarray`` and returns the port's counterpart on `device`.
Nothing here imports JAX: the leaves only have to convert to numpy.  With
it, both packages trace the same scene and the same rays.
"""

from __future__ import annotations

import numpy as np
import torch

from spt_tpu_torch.camera import CameraRays
from spt_tpu_torch.engine.state import RenderState
from spt_tpu_torch.env import Environment, equirect_texels
from spt_tpu_torch.integrators.transport import PathState
from spt_tpu_torch.lights import DeviceLights
from spt_tpu_torch.materials import DeviceMaterials
from spt_tpu_torch.ops.bvh import InstAccel, MeshAccel, cluster_visit_order
from spt_tpu_torch.ops.vec3 import Vec3
from spt_tpu_torch.scene.flatten import DeviceScene, EmitterTable


def _f32(a, device):
    # np.array copies into a contiguous array and keeps 0-d leaves 0-d
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def _i32(a, device):
    return torch.as_tensor(np.array(a, dtype=np.int32), device=device)


def _vec3(v, device) -> Vec3:
    return Vec3(_f32(v.x, device), _f32(v.y, device), _f32(v.z, device))


def accel(src, device) -> MeshAccel:
    """The JAX package's ``MeshAccel``, converted array by array (not
    rebuilt), so both packages trace the same cluster tables.  Its
    128-padded ``tri_stream`` copy (about 53 MB at 104k triangles) is not
    read: the port's stream tier walks ``tri_pack`` and the per-super visit
    orders derived here from ``cl_okey``."""
    ints = ("tri_mat", "cl_okey", "sup_okey")
    arrays = {f: (_i32 if f in ints else _f32)(getattr(src, f), device)
              for f in MeshAccel._fields if f != "cl_order"}
    order = cluster_visit_order(np.asarray(src.cl_okey))
    return MeshAccel(**arrays, cl_order=torch.as_tensor(order, device=device))


def inst_accel(src, device) -> InstAccel:
    """The JAX package's ``InstAccel``, converted array by array."""
    ints = ("blas_okey", "inst_okey")
    return InstAccel(**{f: (_i32 if f in ints else _f32)(getattr(src, f), device)
                        for f in InstAccel._fields})


def textures(src, device) -> torch.Tensor:
    """The JAX package's tiled texture table (n_tex, res^2/1024, 2, 8, 128)
    as the port's (n_tex, res^2, 2): texel (q, r, c) of a tile pair goes to
    row q * 1024 + r * 128 + c."""
    t = np.asarray(src, np.int32)
    return torch.as_tensor(np.ascontiguousarray(
        t.transpose(0, 1, 3, 4, 2).reshape(t.shape[0], -1, 2)), device=device)


def scene(src, device) -> DeviceScene:
    """A ``DeviceScene``, with its cluster accel, instanced TLAS/BLAS,
    texture coordinates and texture table where the JAX scene has them."""
    m = src.materials
    mats = DeviceMaterials(
        base_color=_f32(m.base_color, device),
        metallic=_f32(m.metallic, device),
        roughness=_f32(m.roughness, device),
        ior=_f32(m.ior, device),
        mat_type=_i32(m.mat_type, device),
        emission=_f32(m.emission, device),
        transparency=_f32(m.transparency, device),
        tex_id=_i32(m.tex_id, device),
    )
    em = src.emitters
    emitters = None if em is None else EmitterTable(
        v0=_f32(em.v0, device), e1=_f32(em.e1, device), e2=_f32(em.e2, device),
        le=_f32(em.le, device), area=_f32(em.area, device))
    tri_ns = getattr(src, "tri_ns", None)
    return DeviceScene(
        tri_v0=_f32(src.tri_v0, device),
        tri_e1=_f32(src.tri_e1, device),
        tri_e2=_f32(src.tri_e2, device),
        tri_mat=_i32(src.tri_mat, device),
        sph_center=_f32(src.sph_center, device),
        sph_radius=_f32(src.sph_radius, device),
        sph_mat=_i32(src.sph_mat, device),
        materials=mats,
        emitters=emitters,
        tri_ns=None if tri_ns is None else _f32(tri_ns, device),
        accel=(None if getattr(src, "accel", None) is None
               else accel(src.accel, device)),
        tri_uv=(None if getattr(src, "tri_uv", None) is None
                else _f32(src.tri_uv, device)),
        textures=(None if getattr(src, "textures", None) is None
                  else textures(src.textures, device)),
        inst=(None if getattr(src, "inst", None) is None
              else inst_accel(src.inst, device)),
    )


def lights(src, device) -> DeviceLights:
    return DeviceLights(
        kind=_i32(src.kind, device),
        vec=_f32(src.vec, device),
        color=_f32(src.color, device),
        intensity=_f32(src.intensity, device),
        attenuation=_f32(src.attenuation, device),
    )


def environment(src, device) -> Environment:
    """Only the exact four-tap lookup is ported: the JAX package's opt-in
    snap and packed tables are ignored.  The map is held in the sampler
    kernel's texel layout, as make_hdr_environment holds it."""
    return Environment(
        image=equirect_texels(_f32(src.image, device)),
        enabled=bool(np.asarray(src.enabled)),
        intensity=float(np.asarray(src.intensity, np.float32)),
        max_clamp=float(np.asarray(src.max_clamp, np.float32)),
    )


def camera_rays(src, device) -> CameraRays:
    return CameraRays(*(_f32(getattr(src, f), device)
                        for f in CameraRays._fields))


def path_state(src, device) -> PathState:
    """uint32 RNG words become the port's int64-held words."""
    return PathState(
        origin=_vec3(src.origin, device),
        direction=_vec3(src.direction, device),
        throughput=_vec3(src.throughput, device),
        radiance=_vec3(src.radiance, device),
        rng=torch.as_tensor(np.asarray(src.rng, np.uint32).astype(np.int64),
                            device=device),
        alive=torch.as_tensor(np.array(src.alive, dtype=bool), device=device),
        emission_ok=torch.as_tensor(np.array(src.emission_ok, dtype=bool),
                                    device=device),
    )


def render_state(src, device) -> RenderState:
    return RenderState(
        accum=_f32(src.accum, device),
        sample_count=_f32(src.sample_count, device),
        frame_index=_i32(src.frame_index, device),
    )
