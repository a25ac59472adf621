"""SceneDesc -> DeviceScene, small-scene fields only.

The counterpart of ``spt_tpu.scene.flatten``: instance transforms are baked
into world-space triangles (EmbreeBackend.cpp:60-79), analytic spheres stay
analytic, and emissive triangles form the NEE emitter table.  Material
resolution order matches EmbreeBackend.cpp:51-57: instance override, then
mesh material, then 0.

The port covers scenes of at most ``ACCEL_THRESHOLD`` primitives with no
textures — the scenes the JAX package traces without an acceleration
structure.  Anything else raises NotImplementedError naming the reason, as
``spt_tpu.ops.pallas_bounce.explain_decline`` does for its kernels.  The JAX
package's ``SPT_NS=0`` switch (flat shading for an A/B) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from spt_tpu_torch.materials import DeviceMaterials, build_device_materials
from spt_tpu_torch.scene.desc import NO_MATERIAL, SceneDesc

# Above this many primitives the JAX package builds a cluster accel.
ACCEL_THRESHOLD = 192
# Above this many triangles it may also build the instanced TLAS/BLAS
# (spt_tpu.ops.bvh.MAX_RESIDENT_TRIS); both wait for the mesh path.
_MAX_RESIDENT_TRIS = 12288

# 12-bit packed shading normals (spt_tpu.ops.bvh NS_FIELDS / NS_STEP): every
# path of the JAX package shades with the quantized values, so the port
# stores the same ones.
_NS_FIELDS = ((0, 1), (2, 3), (4, 5), (6, 7), (8, None))
_NS_STEP = np.float32(4.0 / 4094.0)


class EmitterTable(NamedTuple):
    """Emissive-triangle table for next-event estimation (area lights)."""

    v0: torch.Tensor    # (E, 3)
    e1: torch.Tensor    # (E, 3)
    e2: torch.Tensor    # (E, 3)
    le: torch.Tensor    # (E, 3) emitted radiance
    area: torch.Tensor  # (E,)

    @property
    def count(self) -> int:
        return self.v0.shape[0]


class DeviceScene(NamedTuple):
    """World-space scene as SoA tensors on one device."""

    tri_v0: torch.Tensor      # (T, 3) float32
    tri_e1: torch.Tensor      # (T, 3) v1 - v0 (precomputed MT edges)
    tri_e2: torch.Tensor      # (T, 3) v2 - v0
    tri_mat: torch.Tensor     # (T,) int32
    sph_center: torch.Tensor  # (S, 3) float32
    sph_radius: torch.Tensor  # (S,) float32
    sph_mat: torch.Tensor     # (S,) int32
    materials: DeviceMaterials
    # Emissive triangles for NEE; None when the scene has no emitters.
    emitters: Optional[EmitterTable] = None
    # Per-triangle world-space shading normals [n0 | n1-n0 | n2-n0], (T, 9)
    # float32, 12-bit quantized; None when interpolation would be the
    # geometric normal everywhere.
    tri_ns: Optional[torch.Tensor] = None

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]


def _resolve_material(instance, mesh) -> int:
    mid = instance.material_id
    if mid == NO_MATERIAL:
        mid = mesh.material_id
    if mid == NO_MATERIAL:
        mid = 0
    return int(mid)


def _quantize_ns(ns: np.ndarray) -> np.ndarray:
    """Round-trip (T, 9) shading normals through the 12-bit packing
    (spt_tpu.ops.bvh.encode_ns then decode_ns); all-zero rows stay zero."""
    ns = np.asarray(ns, np.float32).reshape(-1, 9)
    q = (1.0 + np.round((np.clip(ns, -2.0, 2.0) + np.float32(2.0))
                        / _NS_STEP)).astype(np.float32)
    planes = np.zeros((ns.shape[0], 5), np.float32)
    for c, (hi, lo) in enumerate(_NS_FIELDS):
        v = q[:, hi] * np.float32(4096.0)
        if lo is not None:
            v = v + q[:, lo]
        planes[:, c] = v
    planes[np.abs(ns).max(axis=1) == 0.0] = 0.0
    out = np.zeros((planes.shape[0], 9), np.float32)
    for c, (hi, lo) in enumerate(_NS_FIELDS):
        h = np.floor(planes[:, c] * np.float32(1.0 / 4096.0)).astype(np.float32)
        out[:, hi] = (h - np.float32(1.0)) * _NS_STEP - np.float32(2.0)
        if lo is not None:
            lq = planes[:, c] - h * np.float32(4096.0)
            out[:, lo] = (lq - np.float32(1.0)) * _NS_STEP - np.float32(2.0)
    out[np.abs(planes).max(axis=1) == 0.0] = 0.0
    return out


def explain_unsupported(desc: SceneDesc) -> Optional[str]:
    """Why the port cannot flatten `desc` yet, or None when it can."""
    reasons = []
    n_tris = sum(desc.meshes[i.mesh_id].triangle_count
                 for i in desc.instances
                 if i.mesh_id < len(desc.meshes)
                 and desc.meshes[i.mesh_id].is_valid())
    n_prims = n_tris + len(desc.spheres)
    if n_prims > ACCEL_THRESHOLD:
        reasons.append(
            f"{n_prims} primitives > {ACCEL_THRESHOLD}: the scene needs the "
            "cluster accel" + (" or the instanced TLAS/BLAS"
                               if n_tris > _MAX_RESIDENT_TRIS else "")
            + " of the mesh path")
    if any(getattr(m, "base_color_texture", None) is not None
           or getattr(m, "metallic_roughness_texture", None) is not None
           for m in desc.materials):
        reasons.append("textured materials need the packed texture table "
                       "of the mesh path")
    return "; ".join(reasons) if reasons else None


def flatten_scene(desc: SceneDesc, device) -> DeviceScene:
    """Bake instance transforms into world-space SoA tensors on `device`."""
    reason = explain_unsupported(desc)
    if reason:
        raise NotImplementedError(f"spt_tpu_torch cannot render this scene "
                                  f"yet: {reason}")
    v0s, v1s, v2s, tri_mats, tri_nss = [], [], [], [], []
    has_ns = False
    for inst in desc.instances:
        if inst.mesh_id >= len(desc.meshes):
            continue
        mesh = desc.meshes[inst.mesh_id]
        if not mesh.is_valid():
            continue
        mat_id = _resolve_material(inst, mesh)
        xf = inst.world_from_object
        pos_h = np.concatenate(
            [mesh.positions, np.ones((mesh.vertex_count, 1), np.float32)], axis=1
        )
        world = (pos_h @ xf.T)[:, :3].astype(np.float32)
        idx = mesh.indices.astype(np.int64)
        v0s.append(world[idx[:, 0]])
        v1s.append(world[idx[:, 1]])
        v2s.append(world[idx[:, 2]])
        tri_mats.append(np.full(idx.shape[0], mat_id, np.int32))
        if mesh.normals is not None and len(mesh.normals) == mesh.vertex_count:
            # normals -> world by the inverse-transpose (EmbreeBackend.cpp:70-79)
            ofw = np.linalg.inv(np.asarray(xf, np.float64))[:3, :3]
            nw = (mesh.normals.astype(np.float64) @ ofw)
            nw /= np.maximum(np.linalg.norm(nw, axis=1, keepdims=True), 1e-20)
            nw = nw.astype(np.float32)
            n0 = nw[idx[:, 0]]
            tri_nss.append(np.concatenate(
                [n0, nw[idx[:, 1]] - n0, nw[idx[:, 2]] - n0], axis=1))
            has_ns = True
        else:
            tri_nss.append(np.zeros((idx.shape[0], 9), np.float32))

    if v0s:
        v0 = np.concatenate(v0s)
        v1 = np.concatenate(v1s)
        v2 = np.concatenate(v2s)
        tri_mat = np.concatenate(tri_mats)
        tri_ns = np.concatenate(tri_nss)
    else:
        v0 = v1 = v2 = np.zeros((0, 3), np.float32)
        tri_mat = np.zeros((0,), np.int32)
        tri_ns = np.zeros((0, 9), np.float32)

    if has_ns and v0.shape[0]:
        # drop the table when interpolation is the geometric normal
        # everywhere (flat meshes such as the ground plane)
        ng = np.cross(v1 - v0, v2 - v0)
        ngl = np.linalg.norm(ng, axis=1, keepdims=True)
        real = ngl[:, 0] > 1e-20
        ngn = ng / np.maximum(ngl, 1e-20)
        varying = np.abs(tri_ns[:, 3:9]).max(axis=1) > 1e-6
        nonzero = np.abs(tri_ns[:, 0:3]).max(axis=1) > 1e-12
        off_geom = np.abs(tri_ns[:, 0:3] - ngn).max(axis=1) > 1e-3
        has_ns = bool((real & nonzero & (varying | off_geom)).any())
    if has_ns:
        tri_ns = _quantize_ns(tri_ns)

    if desc.spheres:
        centers = np.stack([s.center for s in desc.spheres]).astype(np.float32)
        radii = np.array([s.radius for s in desc.spheres], np.float32)
        sph_mat = np.array([s.material_id for s in desc.spheres], np.int32)
    else:
        centers = np.zeros((0, 3), np.float32)
        radii = np.zeros((0,), np.float32)
        sph_mat = np.zeros((0,), np.int32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    emitters = None
    if len(desc.materials) and v0.shape[0]:
        em = np.stack([m.emission for m in desc.materials]).astype(np.float32)
        emissive_mat = (em.max(axis=1) > 0.0)
        tm_clip = np.clip(tri_mat, 0, len(desc.materials) - 1)
        sel = emissive_mat[tm_clip]
        degen = (np.abs(v1 - v0).sum(1) == 0) & (np.abs(v2 - v0).sum(1) == 0)
        sel = sel & ~degen
        if sel.any():
            ev0, ee1, ee2 = v0[sel], (v1 - v0)[sel], (v2 - v0)[sel]
            area = 0.5 * np.linalg.norm(np.cross(ee1, ee2), axis=1)
            emitters = EmitterTable(
                v0=t(ev0), e1=t(ee1), e2=t(ee2),
                le=t(em[tm_clip[sel]]), area=t(area.astype(np.float32)),
            )

    return DeviceScene(
        tri_v0=t(v0),
        tri_e1=t(v1 - v0),
        tri_e2=t(v2 - v0),
        tri_mat=t(tri_mat),
        sph_center=t(centers),
        sph_radius=t(radii),
        sph_mat=t(sph_mat),
        materials=build_device_materials(desc.materials, device),
        emitters=emitters,
        tri_ns=t(tri_ns) if has_ns else None,
    )
