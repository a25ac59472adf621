"""SceneDesc -> DeviceScene.

The counterpart of ``spt_tpu.scene.flatten``: instance transforms are baked
into world-space triangles (EmbreeBackend.cpp:60-79), analytic spheres stay
analytic, and emissive triangles form the NEE emitter table.  Material
resolution order matches EmbreeBackend.cpp:51-57: instance override, then
mesh material, then 0.  Above ``ACCEL_THRESHOLD`` primitives the cluster
accel of ``ops/bvh`` is built over the flattened triangles, as
``spt_tpu.scene.flatten`` does; when those exceed ``MAX_RESIDENT_TRIS`` but
the unique meshes fit it, the instanced TLAS/BLAS pair is built beside it
(``_maybe_build_inst``).  Past ``MAX_RESIDENT_TRIS`` without one, the
stream tier traces the same accel (its supercluster level, K8), up to
``bvh.MAX_STREAM_CLUSTERS`` clusters.  Textured materials get the packed
texture table and the flattened triangles their texture coordinates.

The JAX package's ``SPT_NS``, ``SPT_CLUSTER``, ``SPT_CLUSTER_SIZE`` and
``SPT_INSTANCED`` switches are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from spt_tpu_torch.materials import (DeviceMaterials, build_device_materials,
                                     build_texture_table)
from spt_tpu_torch.ops import bvh
from spt_tpu_torch.ops.bvh import (InstAccel, MeshAccel, build_inst_accel,
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
    # Per-triangle texture coordinates [uv0 | uv1-uv0 | uv2-uv0], (T, 6)
    # float32; None when no material is textured.
    tri_uv: Optional[torch.Tensor] = None
    # Packed texture table (n_tex, res^2, 2) int32
    # (materials.build_texture_table); None when untextured.
    textures: Optional[torch.Tensor] = None
    # Instanced TLAS/BLAS pair (ops/bvh.InstAccel) when the flattened
    # triangles exceed MAX_RESIDENT_TRIS and the unique meshes fit it.
    inst: Optional[InstAccel] = None

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


def _inst_records(desc: SceneDesc):
    """(mesh_id, world_from_object, material override or -1) per valid
    instance, in scene order."""
    return [(i.mesh_id, i.world_from_object,
             int(i.material_id) if i.material_id != NO_MATERIAL else -1)
            for i in _valid_instances(desc)]


def _inst_declines(desc: SceneDesc, inst_records, total_tris: int,
                   cluster_size: int) -> Optional[str]:
    """Why the instanced TLAS/BLAS is not built, or None when it is
    (spt_tpu/scene/flatten.py:300-379): the flattened triangles must exceed
    MAX_RESIDENT_TRIS, with at least two instances, while the unique
    meshes, each padded to the largest one's cluster count, fit it; a
    singular transform or more than 16384 instances declines."""
    if total_tris <= bvh.MAX_RESIDENT_TRIS:
        return "the flattened triangles fit MAX_RESIDENT_TRIS"
    if len(inst_records) < 2:
        return "fewer than two instances"
    mesh_ids = sorted({mid for mid, _, _ in inst_records})
    cmax = max(-(-desc.meshes[mid].triangle_count // cluster_size)
               for mid in mesh_ids)
    if len(mesh_ids) * cmax * cluster_size > bvh.MAX_RESIDENT_TRIS:
        return (f"{len(mesh_ids)} unique meshes x {cmax} clusters of "
                f"{cluster_size} > MAX_RESIDENT_TRIS={bvh.MAX_RESIDENT_TRIS}")
    if len(inst_records) > (1 << 14):
        return f"{len(inst_records)} instances > 16384"
    for _, xf, _ in inst_records:
        if abs(np.linalg.det(np.asarray(xf, np.float64)[:3, :3])) < 1e-12:
            return "a singular instance transform"
    return None


def explain_unsupported(desc: SceneDesc, cluster_size: int = 64) -> Optional[str]:
    """Why the port cannot flatten `desc` yet, or None when it can."""
    reasons = []
    recs = _inst_records(desc)
    n_tris = sum(desc.meshes[mid].triangle_count for mid, _, _ in recs)
    if n_tris + len(desc.spheres) > ACCEL_THRESHOLD:
        clusters = -(-n_tris // cluster_size)
        clusters += -clusters % bvh.SUPER_FAN
        if clusters > bvh.MAX_STREAM_CLUSTERS:
            # the flattened accel is built whatever the tier
            reasons.append(
                f"{n_tris} triangles in {clusters} clusters of {cluster_size}"
                f" > MAX_STREAM_CLUSTERS={bvh.MAX_STREAM_CLUSTERS} (the "
                "16-bit id / 15-bit rank packing of the octant keys)")
        if n_tris <= ACCEL_THRESHOLD:
            # the accel is built over triangles only
            reasons.append(f"{n_tris + len(desc.spheres)} primitives > "
                           f"{ACCEL_THRESHOLD} with no cluster accel: at "
                           f"most {ACCEL_THRESHOLD} triangles")
        elif len(desc.spheres) > MAX_ACCEL_SPHERES:
            reasons.append(f"{len(desc.spheres)} spheres > MAX_ACCEL_SPHERES="
                           f"{MAX_ACCEL_SPHERES} beside the cluster accel")
    return "; ".join(reasons) if reasons else None


def _maybe_build_inst(desc: SceneDesc, inst_records, total_tris: int,
                      cluster_size: int, device) -> Optional[InstAccel]:
    """The TLAS/BLAS pair over the unique meshes in object space, or None
    (spt_tpu/scene/flatten.py:300-379, with the same triviality drop of
    object-space shading normals as the flat path)."""
    if _inst_declines(desc, inst_records, total_tris, cluster_size):
        return None
    mesh_ids = sorted({mid for mid, _, _ in inst_records})
    local = {mid: i for i, mid in enumerate(mesh_ids)}
    meshes = []
    for mid in mesh_ids:
        mesh = desc.meshes[mid]
        pos = mesh.positions
        idx = mesh.indices.astype(np.int64)
        mv0 = pos[idx[:, 0]].astype(np.float32)
        e1 = (pos[idx[:, 1]] - pos[idx[:, 0]]).astype(np.float32)
        e2 = (pos[idx[:, 2]] - pos[idx[:, 0]]).astype(np.float32)
        blas_mat = mesh.material_id if mesh.material_id != NO_MATERIAL else 0
        mat = np.full(idx.shape[0], blas_mat, np.int32)
        uv = ns = None
        if mesh.texcoords is not None and len(mesh.texcoords) == mesh.vertex_count:
            tc = mesh.texcoords
            uv0 = tc[idx[:, 0]]
            uv = np.concatenate(
                [uv0, tc[idx[:, 1]] - uv0, tc[idx[:, 2]] - uv0], axis=1
            ).astype(np.float32)
        if mesh.normals is not None and len(mesh.normals) == mesh.vertex_count:
            # object-space shading normals; the tracer's finish applies the
            # instance's inverse-transpose
            nrm = mesh.normals.astype(np.float64)
            nrm = nrm / np.maximum(
                np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
            nrm = nrm.astype(np.float32)
            n0 = nrm[idx[:, 0]]
            ns = np.concatenate(
                [n0, nrm[idx[:, 1]] - n0, nrm[idx[:, 2]] - n0], axis=1)
            ng = np.cross(e1, e2)
            ngl = np.linalg.norm(ng, axis=1, keepdims=True)
            real = ngl[:, 0] > 1e-20
            ngn = ng / np.maximum(ngl, 1e-20)
            varying = np.abs(ns[:, 3:9]).max(axis=1) > 1e-6
            off = np.abs(ns[:, 0:3] - ngn).max(axis=1) > 1e-3
            if not (real & (varying | off)).any():
                ns = None
        meshes.append((mv0, e1, e2, mat, uv, ns))
    instances = [(local[mid], xf, mat_ov) for mid, xf, mat_ov in inst_records]
    # _inst_declines has ruled out what build_inst_accel refuses
    return build_inst_accel(meshes, instances, cluster_size=cluster_size,
                            device=device)


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
    inst_records = _inst_records(desc)
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
    inst = _maybe_build_inst(desc, inst_records, v0.shape[0], cluster_size,
                             device)
    _, textures = build_texture_table(desc.materials, device=device)

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
        tri_uv=t(tri_uv) if textures is not None else None,
        textures=textures,
        inst=inst,
    )
