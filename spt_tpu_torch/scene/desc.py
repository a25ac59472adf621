"""Host-side scene description (the `scene::SceneDesc` contract).

Mirrors the reference's backend-agnostic POD scene (include/scene/SceneDesc.h):
Material (:13-28), SphereData (:33-41), MeshData (:46-68), InstanceData
(:73-84), the SceneDesc container with add helpers (:89-159), and the
procedural primitives createCubeMesh (:166-190), createGroundPlaneMesh
(:193-222), createSphereMesh (:225-279).

This layer is pure numpy, copied from ``spt_tpu.scene.desc`` — tensors only
appear after :func:`spt_tpu_torch.scene.flatten.flatten_scene`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# Material type tags (include/optix/LaunchParams.h:10-11)
MATERIAL_TYPE_PBR = 0
MATERIAL_TYPE_DIELECTRIC = 1

# Sentinel: "no material override" (EmbreeBackend.cpp:51-57 UINT32_MAX chain)
NO_MATERIAL = 0xFFFFFFFF


@dataclasses.dataclass
class Material:
    """Scene material (SceneDesc.h:13-28 unified with the runtime Material,
    include/Material.h:19-39 — one model, not two, by design).

    `transparency` exists in the reference's SceneDesc but is consumed by
    neither backend (SURVEY.md §5 quirk 7); here the runtime derives
    transparency from ior exactly like Material::getTransparency()
    (Material.h:68-74), and the field is kept for glTF ingestion.
    """

    base_color: np.ndarray = None
    emission: np.ndarray = None
    metallic: float = 0.0
    roughness: float = 0.5
    ior: float = 1.5
    transparency: float = 0.0
    mat_type: int = MATERIAL_TYPE_PBR
    # Optional baseColor texture, (H, W, 3) float32 LINEAR color; multiplies
    # base_color at shade time using the hit's interpolated TEXCOORD_0.
    # Beyond reference parity: its GLTFLoader reads TEXCOORD_0 but neither
    # backend ever samples a texture (GLTFLoader.cpp:219-331).
    base_color_texture: np.ndarray = None
    # Optional glTF metallicRoughness texture, (H, W, 3) float32 LINEAR
    # (G = roughness, B = metallic per the glTF spec); the channel values
    # MULTIPLY the material's roughness/metallic factors at shade time.
    metallic_roughness_texture: np.ndarray = None

    def __post_init__(self):
        if self.base_color is None:
            self.base_color = np.array([0.8, 0.8, 0.8], np.float32)
        if self.base_color_texture is not None:
            arr = np.asarray(self.base_color_texture, np.float32)
            self.base_color_texture = arr.reshape(arr.shape[0], -1, 3)
        if self.metallic_roughness_texture is not None:
            arr = np.asarray(self.metallic_roughness_texture, np.float32)
            self.metallic_roughness_texture = arr.reshape(arr.shape[0], -1, 3)
        if self.emission is None:
            self.emission = np.array([0.0, 0.0, 0.0], np.float32)
        self.base_color = np.asarray(self.base_color, np.float32)
        self.emission = np.asarray(self.emission, np.float32)
        # Clamp as the runtime Material ctor does (Material.h:36-38).
        self.metallic = float(np.clip(self.metallic, 0.0, 1.0))
        self.roughness = float(np.clip(self.roughness, 0.01, 1.0))

    # Derived quantities (Material.h:42-74)
    def is_emissive(self) -> bool:
        return float(np.linalg.norm(self.emission)) > 0.0

    def is_transparent(self) -> bool:
        """metallic < 0.1 and ior > 1.3 (Material.h:62-65)."""
        return self.metallic < 0.1 and self.ior > 1.3

    def get_transparency(self) -> float:
        """clamp((ior-1)/0.7, 0, 0.95) when transparent (Material.h:68-74)."""
        if self.is_transparent():
            return float(np.clip((self.ior - 1.0) / 0.7, 0.0, 0.95))
        return 0.0


@dataclasses.dataclass
class SphereData:
    """Analytic sphere (SceneDesc.h:33-41)."""

    center: np.ndarray
    radius: float = 0.5
    material_id: int = 0

    def __post_init__(self):
        self.center = np.asarray(self.center, np.float32)


@dataclasses.dataclass
class MeshData:
    """Triangle mesh (SceneDesc.h:46-68)."""

    positions: np.ndarray                    # (V, 3) float32
    indices: np.ndarray                      # (T, 3) uint32
    normals: Optional[np.ndarray] = None     # (V, 3) float32
    texcoords: Optional[np.ndarray] = None   # (V, 2) float32
    material_id: int = 0

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, np.uint32).reshape(-1, 3)
        if self.normals is not None:
            self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        if self.texcoords is not None:
            self.texcoords = np.asarray(self.texcoords, np.float32).reshape(-1, 2)

    def is_valid(self) -> bool:
        return self.positions.size > 0 and self.indices.size > 0

    @property
    def triangle_count(self) -> int:
        return int(self.indices.shape[0])

    @property
    def vertex_count(self) -> int:
        return int(self.positions.shape[0])


@dataclasses.dataclass
class InstanceData:
    """Mesh instance with object->world transform (SceneDesc.h:73-84)."""

    mesh_id: int = 0
    world_from_object: np.ndarray = None     # (4, 4) float32
    material_id: int = NO_MATERIAL

    def __post_init__(self):
        if self.world_from_object is None:
            self.world_from_object = np.eye(4, dtype=np.float32)
        self.world_from_object = np.asarray(self.world_from_object, np.float32).reshape(4, 4)


@dataclasses.dataclass
class SceneDesc:
    """Complete scene description + add helpers (SceneDesc.h:89-159)."""

    materials: List[Material] = dataclasses.field(default_factory=list)
    meshes: List[MeshData] = dataclasses.field(default_factory=list)
    instances: List[InstanceData] = dataclasses.field(default_factory=list)
    spheres: List[SphereData] = dataclasses.field(default_factory=list)

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_mesh(self, mesh: MeshData) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_instance(self, mesh_id: int, world_from_object=None, material_id: int = NO_MATERIAL) -> int:
        self.instances.append(InstanceData(mesh_id, world_from_object, material_id))
        return len(self.instances) - 1

    def add_sphere(self, center, radius: float, material_id: int = 0) -> int:
        self.spheres.append(SphereData(center, radius, material_id))
        return len(self.spheres) - 1

    def clear(self) -> None:
        self.materials.clear()
        self.meshes.clear()
        self.instances.clear()
        self.spheres.clear()

    @property
    def total_triangles(self) -> int:
        """World triangle count after instance flattening (exact, unlike the
        reference's rough estimate at SceneDesc.h:142-149)."""
        return sum(
            self.meshes[inst.mesh_id].triangle_count
            for inst in self.instances
            if inst.mesh_id < len(self.meshes)
        )

    @property
    def total_vertices(self) -> int:
        return sum(m.vertex_count for m in self.meshes)


# --- Transform helpers (glm::translate/scale/rotate equivalents) -------------

def translate(m: np.ndarray, v) -> np.ndarray:
    """Column-major GLM translate: result maps p -> m @ (p + v-ish); matches
    glm::translate(m, v) = m @ T(v)."""
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = np.asarray(v, np.float32)
    return (np.asarray(m, np.float32) @ t).astype(np.float32)


def scale(m: np.ndarray, v) -> np.ndarray:
    s = np.eye(4, dtype=np.float32)
    sv = np.asarray(v, np.float32)
    if sv.ndim == 0:
        sv = np.full(3, float(sv), np.float32)
    s[0, 0], s[1, 1], s[2, 2] = sv
    return (np.asarray(m, np.float32) @ s).astype(np.float32)


def rotate(m: np.ndarray, angle_rad: float, axis) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    x, y, z = a
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s, 0],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s, 0],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c), 0],
            [0, 0, 0, 1],
        ],
        np.float32,
    )
    return (np.asarray(m, np.float32) @ r).astype(np.float32)


# --- Procedural primitives ----------------------------------------------------

def create_cube_mesh(material_id: int = 0) -> MeshData:
    """Unit cube, 8 vertices / 12 triangles (SceneDesc.h:166-190)."""
    positions = np.array(
        [
            [-0.5, -0.5, -0.5], [0.5, -0.5, -0.5],
            [0.5, -0.5, 0.5], [-0.5, -0.5, 0.5],
            [-0.5, 0.5, -0.5], [0.5, 0.5, -0.5],
            [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5],
        ],
        np.float32,
    )
    indices = np.array(
        [
            [0, 2, 1], [0, 3, 2],   # bottom
            [4, 5, 6], [4, 6, 7],   # top
            [0, 1, 5], [0, 5, 4],   # front
            [2, 3, 7], [2, 7, 6],   # back
            [3, 0, 4], [3, 4, 7],   # left
            [1, 2, 6], [1, 6, 5],   # right
        ],
        np.uint32,
    )
    return MeshData(positions=positions, indices=indices, material_id=material_id)


def create_ground_plane_mesh(size: float = 10.0, material_id: int = 0) -> MeshData:
    """Large quad at y=0 with up normals (SceneDesc.h:193-222)."""
    half = size * 0.5
    positions = np.array(
        [[-half, 0.0, -half], [half, 0.0, -half], [half, 0.0, half], [-half, 0.0, half]],
        np.float32,
    )
    normals = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1))
    indices = np.array([[0, 2, 1], [0, 3, 2]], np.uint32)
    return MeshData(positions=positions, indices=indices, normals=normals, material_id=material_id)


def create_sphere_mesh(
    stacks: int = 32, slices: int = 64, radius: float = 0.5, material_id: int = 0
) -> MeshData:
    """UV sphere (SceneDesc.h:225-279), vectorized over the lat/long grid."""
    stack = np.arange(stacks + 1, dtype=np.float32)
    slc = np.arange(slices + 1, dtype=np.float32)
    phi = np.pi * stack / stacks                    # (stacks+1,)
    theta = 2.0 * np.pi * slc / slices              # (slices+1,)
    sin_phi, cos_phi = np.sin(phi), np.cos(phi)
    sin_t, cos_t = np.sin(theta), np.cos(theta)

    # Grid ordering matches the reference's nested loops: stack-major.
    x = radius * sin_phi[:, None] * cos_t[None, :]
    y = radius * cos_phi[:, None] * np.ones_like(cos_t)[None, :]
    z = radius * sin_phi[:, None] * sin_t[None, :]
    positions = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    norms = np.linalg.norm(positions, axis=-1, keepdims=True)
    normals = (positions / np.maximum(norms, 1e-12)).astype(np.float32)
    u = (slc / slices)[None, :] * np.ones((stacks + 1, 1), np.float32)
    v = (stack / stacks)[:, None] * np.ones((1, slices + 1), np.float32)
    texcoords = np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float32)

    si = np.arange(stacks, dtype=np.uint32)
    sj = np.arange(slices, dtype=np.uint32)
    first = (si[:, None] * (slices + 1) + sj[None, :]).astype(np.uint32)
    second = first + np.uint32(slices + 1)
    tri1 = np.stack([first, second, first + 1], axis=-1)
    tri2 = np.stack([second, second + 1, first + 1], axis=-1)
    indices = np.concatenate([tri1[..., None, :], tri2[..., None, :]], axis=-2).reshape(-1, 3)
    return MeshData(
        positions=positions,
        indices=indices.astype(np.uint32),
        normals=normals,
        texcoords=texcoords,
        material_id=material_id,
    )
