"""Material presets and the device-side SoA material table.

The counterpart of ``spt_tpu.materials``: the preset library mirrors
Materials::Gold..Light (Material.h:99-148), the default table is
MaterialManager's 9 presets (MaterialManager.cpp:21-52), and a hit's
material is a gather ``table[mat_id]``.  Textured materials index the
scene's packed texture table (``build_texture_table``) through ``tex_id``.

The JAX package tiles that table as (n_tex, res^2/1024, 2, 8, 128) for its
TPU kernel; the port keeps one texel per row, (n_tex, res^2, 2) int32 —
plane 0 the packed baseColor, plane 1 the packed (roughness, metallic)
multipliers, texel (ty, tx) at row ty * res + tx — so a bilinear tap is one
8-byte load.  The values are bit-identical to the JAX table's at the same
flat index.  The JAX package's ``SPT_TEX_BUDGET`` override is not ported:
the budget is ``TEX_BUDGET_BYTES``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from spt_tpu_torch.ops.vec3 import Vec3

MATERIAL_TYPE_PBR = 0
MATERIAL_TYPE_DIELECTRIC = 1

# Bytes the packed table may take (both int32 planes of every texture):
# 4 textures at 256^2, 16 at 128^2, 64 at 64^2 (spt_tpu/materials.py:59-88).
TEX_BUDGET_BYTES = 2 << 20


def choose_tex_res(n_tex: int) -> int:
    """Largest square resolution in {256, 128, 64} whose packed table fits
    TEX_BUDGET_BYTES; 64 is the floor (spt_tpu.materials.choose_tex_res)."""
    for res in (256, 128):
        if n_tex * 2 * res * res * 4 <= TEX_BUDGET_BYTES:
            return res
    return 64


def tex_res_of(textures) -> int:
    """Per-scene texture resolution from the table's shape (n_tex, res^2, 2)."""
    return int(round(np.sqrt(textures.shape[1])))


def _resample_texture(img: np.ndarray, res: int) -> np.ndarray:
    """(H, W, C) -> (res, res, C): area-average when downsampling, point
    sample where a cell gets no source texel (spt_tpu/materials.py:97-120)."""
    img = np.asarray(img, np.float32)
    h, w, ch = img.shape
    yi = np.minimum((np.arange(res) + 0.5) / res * h, h - 1).astype(np.int64)
    xi = np.minimum((np.arange(res) + 0.5) / res * w, w - 1).astype(np.int64)
    point = img[yi][:, xi]
    if h <= res and w <= res:
        return point.astype(np.float32)
    if h % res == 0 and w % res == 0:
        return img.reshape(res, h // res, res, w // res, ch).mean(
            (1, 3)).astype(np.float32)
    by = np.minimum(np.arange(h) * res // h, res - 1)
    bx = np.minimum(np.arange(w) * res // w, res - 1)
    acc = np.zeros((res, res, ch), np.float64)
    cnt = np.zeros((res, res, 1), np.float64)
    np.add.at(acc, (by[:, None], bx[None, :]), img)
    np.add.at(cnt, (by[:, None], bx[None, :]), 1.0)
    return np.where(cnt > 0, acc / np.maximum(cnt, 1.0),
                    point).astype(np.float32)


def _pack_color(rgb: np.ndarray) -> np.ndarray:
    """(.., 3) [0,1] floats -> packed uint32, 10 bits a channel,
    sqrt-encoded (decoded by squaring)."""
    q = np.round(np.sqrt(np.clip(rgb, 0.0, 1.0)) * 1023.0).astype(np.uint32)
    return (q[..., 0] << 20) | (q[..., 1] << 10) | q[..., 2]


def _pack_mr(mr: np.ndarray) -> np.ndarray:
    """(.., 2) [0,1] (roughness, metallic) multipliers -> packed uint32, 16
    bits each; the neutral fill (1, 1) is 0xFFFFFFFF."""
    q = np.round(np.clip(mr, 0.0, 1.0) * 65535.0).astype(np.uint32)
    return (q[..., 0] << 16) | q[..., 1]


def texture_ids(materials: Sequence["Material"]) -> np.ndarray:
    """(M,) int32: each textured material's row in the texture table, -1
    for the others (at least one entry, as build_device_materials pads an
    empty list)."""
    tex_id = np.full(max(len(materials), 1), -1, np.int32)
    n = 0
    for i, m in enumerate(materials):
        if (getattr(m, "base_color_texture", None) is not None
                or getattr(m, "metallic_roughness_texture", None) is not None):
            tex_id[i] = n
            n += 1
    return tex_id


def build_texture_table(materials: Sequence["Material"], res: int = None,
                        device="cpu"):
    """(tex_id (M,) int32 numpy, textures (n_tex, res^2, 2) int32 tensor on
    `device` | None), as spt_tpu.materials.build_texture_table: plane 1
    packs the glTF metallicRoughness texture's (G = roughness, B =
    metallic), or the neutral (1, 1) when the material has none."""
    tex_id = texture_ids(materials)
    textured = [m for i, m in enumerate(materials) if tex_id[i] >= 0]
    if res is None:
        res = choose_tex_res(len(textured))
    planes = []
    for m in textured:
        img = getattr(m, "base_color_texture", None)
        mr = getattr(m, "metallic_roughness_texture", None)
        if img is not None:
            color = _pack_color(_resample_texture(img, res))
        else:
            color = np.full((res, res), _pack_color(np.ones(3, np.float32)),
                            np.uint32)
        if mr is not None:
            packed_mr = _pack_mr(_resample_texture(mr, res)[..., [1, 2]])
        else:
            packed_mr = np.full((res, res), np.uint32(0xFFFFFFFF))
        planes.append(np.stack([color.reshape(-1), packed_mr.reshape(-1)], 1))
    if not planes:
        return tex_id, None
    packed = np.ascontiguousarray(np.stack(planes).view(np.int32))
    return tex_id, torch.as_tensor(packed, device=device)


def unpack_color(p: torch.Tensor):
    """Packed int32 plane -> (r, g, b) float32 (inverse of _pack_color)."""
    r = ((p >> 20) & 1023).to(torch.float32) * (1.0 / 1023.0)
    g = ((p >> 10) & 1023).to(torch.float32) * (1.0 / 1023.0)
    b = (p & 1023).to(torch.float32) * (1.0 / 1023.0)
    return r * r, g * g, b * b


def unpack_mr(p: torch.Tensor):
    """Packed int32 plane -> (roughness_mult, metallic_mult) float32."""
    rough = ((p >> 16) & 0xFFFF).to(torch.float32) * (1.0 / 65535.0)
    metal = (p & 0xFFFF).to(torch.float32) * (1.0 / 65535.0)
    return rough, metal


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
        tex_id=i32(texture_ids(materials)),
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
