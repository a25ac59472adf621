"""Scene description (numpy) and its flattening into device tensors."""

from spt_tpu_torch.scene.desc import (
    Material,
    MeshData,
    InstanceData,
    SphereData,
    SceneDesc,
    create_cube_mesh,
    create_ground_plane_mesh,
    create_sphere_mesh,
    MATERIAL_TYPE_PBR,
    MATERIAL_TYPE_DIELECTRIC,
)
from spt_tpu_torch.scene.builder import (
    build_default_scene,
    build_test_triangle_scene,
    build_cornell_box_scene,
    build_chair_grid_scene,
    build_hdr_glass_scene,
    build_unique_grid_scene,
)
from spt_tpu_torch.scene.flatten import DeviceScene, EmitterTable, flatten_scene

__all__ = [
    "Material",
    "MeshData",
    "InstanceData",
    "SphereData",
    "SceneDesc",
    "create_cube_mesh",
    "create_ground_plane_mesh",
    "create_sphere_mesh",
    "MATERIAL_TYPE_PBR",
    "MATERIAL_TYPE_DIELECTRIC",
    "build_default_scene",
    "build_test_triangle_scene",
    "build_cornell_box_scene",
    "build_chair_grid_scene",
    "build_hdr_glass_scene",
    "build_unique_grid_scene",
    "DeviceScene",
    "EmitterTable",
    "flatten_scene",
]
