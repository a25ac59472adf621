"""SceneDesc -> DeviceScene.

The counterpart of ``spt_tpu.scene.flatten``: instance transforms are baked
into world-space triangles (EmbreeBackend.cpp:60-79), analytic spheres stay
analytic, and emissive triangles form the NEE emitter table.  Material
resolution order matches EmbreeBackend.cpp:51-57: instance override, then
mesh material, then 0.  Above ``ACCEL_THRESHOLD`` primitives the cluster
accel of ``ops/bvh`` is built, as ``spt_tpu.scene.flatten`` does.

The port covers untextured scenes whose accel stays in the resident tier
(at most ``MAX_RESIDENT_TRIS`` triangles, at most ``MAX_ACCEL_SPHERES``
spheres beside them).  Scenes the JAX package would instance or stream, and
textured ones, raise NotImplementedError naming the reason.  The JAX
package's ``SPT_NS``, ``SPT_CLUSTER`` and ``SPT_CLUSTER_SIZE`` switches are
not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from spt_tpu_torch.materials import DeviceMaterials, build_device_materials
from spt_tpu_torch.ops.bvh import (MAX_RESIDENT_TRIS, MeshAccel,
                                   build_mesh_accel, quantize_ns)
from spt_tpu_torch.scene.desc import NO_MATERIAL, SceneDesc

# Above this many primitives a cluster accel is built.
ACCEL_THRESHOLD = 192
# Analytic spheres beside an accel (spt_tpu.ops.pallas_bounce
# MAX_ACCEL_SPHERES): the tracers test them one by one before the clusters.
MAX_ACCEL_SPHERES = 32


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
    # Cluster accel (ops/bvh) above ACCEL_THRESHOLD primitives, else None.
    accel: Optional[MeshAccel] = None

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


def _valid_instances(desc: SceneDesc):
    return [i for i in desc.instances
            if i.mesh_id < len(desc.meshes)
            and desc.meshes[i.mesh_id].is_valid()]


def explain_unsupported(desc: SceneDesc, cluster_size: int = 64) -> Optional[str]:
    """Why the port cannot flatten `desc` yet, or None when it can."""
    reasons = []
    insts = _valid_instances(desc)
    n_tris = sum(desc.meshes[i.mesh_id].triangle_count for i in insts)
    if n_tris + len(desc.spheres) > ACCEL_THRESHOLD:
        if n_tris > MAX_RESIDENT_TRIS:
            # spt_tpu.scene.flatten._maybe_build_inst: instance when the
            # unique meshes, each cluster-padded, fit the resident budget
            mesh_ids = sorted({i.mesh_id for i in insts})
            cmax = max(-(-desc.meshes[m].triangle_count // cluster_size)
                       for m in mesh_ids)
            tier = ("instanced TLAS/BLAS" if len(insts) >= 2 and
                    len(mesh_ids) * cmax * cluster_size <= MAX_RESIDENT_TRIS
                    else "stream tier")
            reasons.append(
                f"{n_tris} triangles > MAX_RESIDENT_TRIS={MAX_RESIDENT_TRIS}:"
                f" the scene needs the {tier} of the mesh path")
        if n_tris <= ACCEL_THRESHOLD:
            # the accel is built over triangles only
            reasons.append(f"{n_tris + len(desc.spheres)} primitives > "
                           f"{ACCEL_THRESHOLD} with no cluster accel: at "
                           f"most {ACCEL_THRESHOLD} triangles")
        elif len(desc.spheres) > MAX_ACCEL_SPHERES:
            reasons.append(f"{len(desc.spheres)} spheres > MAX_ACCEL_SPHERES="
                           f"{MAX_ACCEL_SPHERES} beside the cluster accel")
    if any(getattr(m, "base_color_texture", None) is not None
           or getattr(m, "metallic_roughness_texture", None) is not None
           for m in desc.materials):
        reasons.append("textured materials need the packed texture table "
                       "of the mesh path")
    return "; ".join(reasons) if reasons else None


def flatten_scene(desc: SceneDesc, device="cuda",
                  cluster_size: int = 64) -> DeviceScene:
    """Bake instance transforms into world-space SoA tensors on `device`,
    plus the cluster accel above ACCEL_THRESHOLD primitives."""
    reason = explain_unsupported(desc, cluster_size)
    if reason:
        raise NotImplementedError(f"spt_tpu_torch cannot render this scene "
                                  f"yet: {reason}")
    v0s, v1s, v2s, tri_mats, tri_uvs, tri_nss = [], [], [], [], [], []
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
        if mesh.texcoords is not None and len(mesh.texcoords) == mesh.vertex_count:
            # [uv0 | uv1-uv0 | uv2-uv0]: only the accel's tri_pack carries
            # them (untextured scenes never read them)
            tc = mesh.texcoords
            uv0 = tc[idx[:, 0]]
            tri_uvs.append(np.concatenate(
                [uv0, tc[idx[:, 1]] - uv0, tc[idx[:, 2]] - uv0], axis=1
            ).astype(np.float32))
        else:
            tri_uvs.append(np.zeros((idx.shape[0], 6), np.float32))
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
        tri_uv = np.concatenate(tri_uvs)
        tri_ns = np.concatenate(tri_nss)
    else:
        v0 = v1 = v2 = np.zeros((0, 3), np.float32)
        tri_mat = np.zeros((0,), np.int32)
        tri_uv = np.zeros((0, 6), np.float32)
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
        tri_ns = quantize_ns(tri_ns)

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

    accel = None
    if v0.shape[0] > ACCEL_THRESHOLD:
        accel = build_mesh_accel(v0, v1 - v0, v2 - v0, tri_mat,
                                 cluster_size=cluster_size, uv=tri_uv,
                                 ns=tri_ns if has_ns else None, device=device)

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
        accel=accel,
    )
