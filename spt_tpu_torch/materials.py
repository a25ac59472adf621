"""Material presets and the device-side SoA material table.

The counterpart of ``spt_tpu.materials``: the preset library mirrors
Materials::Gold..Light (Material.h:99-148), the default table is
MaterialManager's 9 presets (MaterialManager.cpp:21-52), and a hit's
material is a gather ``table[mat_id]``.  The packed texture table waits for
the mesh path, so every material here is untextured (``tex_id`` -1).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from spt_tpu_torch.ops.vec3 import Vec3

MATERIAL_TYPE_PBR = 0
MATERIAL_TYPE_DIELECTRIC = 1


class DeviceMaterials(NamedTuple):
    """SoA material table (LaunchParams.h:34-43 plus emission/transparency)."""

    base_color: torch.Tensor    # (M, 3) raw albedo; diffuse derived at shade
    metallic: torch.Tensor      # (M,)
    roughness: torch.Tensor     # (M,)
    ior: torch.Tensor           # (M,)
    mat_type: torch.Tensor      # (M,) int32: 0 PBR, 1 DIELECTRIC
    emission: torch.Tensor      # (M, 3)
    transparency: torch.Tensor  # (M,) derived via Material::getTransparency()
    tex_id: torch.Tensor        # (M,) int32, -1: untextured

    @property
    def count(self) -> int:
        return self.base_color.shape[0]


def build_device_materials(materials: Sequence["Material"], device) -> DeviceMaterials:
    """Material list -> SoA table on `device` (MaterialManager.cpp:13-19,
    with derived transparency baked in)."""
    if len(materials) == 0:
        materials = [_material_cls()()]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return DeviceMaterials(
        base_color=f32(np.stack([m.base_color for m in materials])),
        metallic=f32([m.metallic for m in materials]),
        roughness=f32([m.roughness for m in materials]),
        ior=f32([m.ior for m in materials]),
        mat_type=i32([m.mat_type for m in materials]),
        emission=f32(np.stack([m.emission for m in materials])),
        transparency=f32([m.get_transparency() for m in materials]),
        tex_id=i32(np.full(len(materials), -1)),
    )


class LaneMaterials(NamedTuple):
    """Per-lane material parameters in Vec3/lane layout."""

    base_color: Vec3
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    mat_type: torch.Tensor
    emission: Vec3
    transparency: torch.Tensor
    tex_id: torch.Tensor


def gather_v(table: DeviceMaterials, mat_id: torch.Tensor) -> LaneMaterials:
    """Per-lane material fetch, Vec3 layout (clamped ids,
    device_programs.cu:341-345)."""
    mid = torch.clamp(mat_id, 0, table.count - 1).long()
    bc = table.base_color[mid]
    em = table.emission[mid]
    return LaneMaterials(
        base_color=Vec3(bc[..., 0], bc[..., 1], bc[..., 2]),
        metallic=table.metallic[mid],
        roughness=table.roughness[mid],
        ior=table.ior[mid],
        mat_type=table.mat_type[mid],
        emission=Vec3(em[..., 0], em[..., 1], em[..., 2]),
        transparency=table.transparency[mid],
        tex_id=table.tex_id[mid],
    )


# --- Preset library (Material.h:99-148) ---------------------------------------

def _material_cls():
    # scene.desc imports nothing from here, but keeping the import lazy keeps
    # the module graph the same shape as the JAX package's
    from spt_tpu_torch.scene.desc import Material

    return Material


def gold() -> "Material":
    return _material_cls()([1.0, 0.71, 0.29], metallic=1.0, roughness=0.05)


def silver() -> "Material":
    return _material_cls()([0.95, 0.93, 0.88], metallic=1.0, roughness=0.02)


def copper() -> "Material":
    return _material_cls()([0.95, 0.64, 0.54], metallic=1.0, roughness=0.08)


def iron() -> "Material":
    return _material_cls()([0.56, 0.57, 0.58], metallic=1.0, roughness=0.3)


def plastic() -> "Material":
    return _material_cls()([0.8, 0.2, 0.2], metallic=0.0, roughness=0.4, ior=1.2)


def rubber() -> "Material":
    return _material_cls()([0.3, 0.3, 0.3], metallic=0.0, roughness=0.8, ior=1.1)


def glass() -> "Material":
    return _material_cls()([1.0, 1.0, 1.0], metallic=0.0, roughness=0.0, ior=1.5,
                           mat_type=MATERIAL_TYPE_DIELECTRIC)


def clear_glass() -> "Material":
    return _material_cls()([0.95, 0.98, 1.0], metallic=0.0, roughness=0.02,
                           ior=1.5, mat_type=MATERIAL_TYPE_DIELECTRIC)


def wood() -> "Material":
    return _material_cls()([0.4, 0.25, 0.1], metallic=0.0, roughness=0.7, ior=1.0)


def concrete() -> "Material":
    return _material_cls()([0.6, 0.6, 0.6], metallic=0.0, roughness=0.9, ior=1.0)


def light(color=(1.0, 1.0, 1.0), intensity: float = 5.0) -> "Material":
    return _material_cls()([0.0, 0.0, 0.0], metallic=0.0, roughness=1.0,
                           emission=np.asarray(color, np.float32) * intensity)


def default_materials() -> List["Material"]:
    """The 9-entry default table (MaterialManager.cpp:21-52):
    gold, silver, copper, iron, glass(DIELECTRIC), plastic, rubber, wood,
    concrete."""
    return [gold(), silver(), copper(), iron(), glass(),
            plastic(), rubber(), wood(), concrete()]
