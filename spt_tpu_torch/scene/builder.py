"""Canonical scenes (copied from ``spt_tpu.scene.builder``).

- :func:`build_default_scene` — the reference's default scene
  (SceneBuilder.cpp:9-123): 9 materials, 8 analytic spheres in rows, one glass
  cube instance (scale 1.5 at (0, 1, 2)).  The material table uses the
  MaterialManager presets (MaterialManager.cpp:21-52) since those — not
  SceneBuilder's shadowed list — are what both reference backends shade with
  (SURVEY.md §5 quirk 7).
- :func:`build_test_triangle_scene` — the bring-up fixture
  (SceneBuilder.cpp:126-159): 1 triangle mesh, 2 instances (identity +
  translate/scale), 1 sphere.
- :func:`build_cornell_box_scene` — the emissive multi-bounce benchmark scene
  (BASELINE.md config #2); not in the reference, which has no emissive scene
  despite supporting emission.
- :func:`build_hdr_glass_scene` — the HDR-environment showcase.

The chair-grid builders of the JAX package need the glTF loader and wait
for the mesh path.
"""

from __future__ import annotations

import numpy as np

from spt_tpu_torch import materials as mats
from spt_tpu_torch.scene.desc import (
    Material,
    MeshData,
    SceneDesc,
    create_cube_mesh,
    create_ground_plane_mesh,
    translate,
    scale,
)


def build_default_scene() -> SceneDesc:
    scene = SceneDesc()
    for m in mats.default_materials():
        scene.add_material(m)

    cube_mesh_id = scene.add_mesh(create_cube_mesh(material_id=0))

    # Metal spheres — front row (SceneBuilder.cpp:98-103)
    scene.add_sphere([-3.0, 1.0, 0.0], 1.0, 0)   # gold
    scene.add_sphere([-1.0, 1.0, 0.0], 1.0, 1)   # silver
    scene.add_sphere([1.0, 1.0, 0.0], 1.0, 2)    # copper
    scene.add_sphere([3.0, 1.0, 0.0], 1.0, 3)    # iron
    # Dielectric + mixed — back rows (SceneBuilder.cpp:104-109)
    scene.add_sphere([-2.0, 1.0, -2.0], 1.0, 5)  # plastic
    scene.add_sphere([0.0, 1.0, -2.0], 1.0, 6)   # rubber
    scene.add_sphere([2.0, 1.0, -2.0], 1.0, 7)   # wood
    scene.add_sphere([0.0, 1.0, -4.0], 1.0, 8)   # concrete

    # Glass cube: translate(0,1,2) then scale(1.5) (SceneBuilder.cpp:116-118)
    xf = scale(translate(np.eye(4, dtype=np.float32), [0.0, 1.0, 2.0]), 1.5)
    scene.add_instance(cube_mesh_id, xf, material_id=4)
    return scene


def build_hdr_glass_scene() -> SceneDesc:
    """HDR-environment showcase: ground plane, one glass and one gold sphere
    (BASELINE.md config #4 — HDR env + directional light with glass).
    Pair with env.synthetic_equirect (the reference's default skybox asset is
    absent from its repo, PathTracer.cpp:24)."""
    scene = SceneDesc()
    white = scene.add_material(Material([0.8, 0.8, 0.8], roughness=0.9, ior=1.0))
    glass = scene.add_material(mats.glass())
    gold = scene.add_material(mats.gold())
    mid = scene.add_mesh(create_ground_plane_mesh(20.0, white))
    scene.add_instance(mid)
    scene.add_sphere([-1.2, 1.0, 0.0], 1.0, glass)
    scene.add_sphere([1.2, 1.0, 0.0], 1.0, gold)
    return scene


def build_test_triangle_scene() -> SceneDesc:
    scene = SceneDesc()
    scene.add_material(Material([0.8, 0.3, 0.3]))

    tri = MeshData(
        positions=np.array(
            [[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.5, 0.0]], np.float32
        ),
        indices=np.array([[0, 1, 2]], np.uint32),
        material_id=0,
    )
    mesh_id = scene.add_mesh(tri)

    # Identity instance + translated/scaled instance (transform validation).
    scene.add_instance(mesh_id, np.eye(4, dtype=np.float32), material_id=0)
    xf = scale(translate(np.eye(4, dtype=np.float32), [2.0, 0.0, -1.0]), 0.5)
    scene.add_instance(mesh_id, xf, material_id=0)

    # One analytic sphere (sphere-path validation, SceneBuilder.cpp:154-156).
    scene.add_sphere([-2.0, 0.5, -1.0], 0.5, 0)
    return scene


def build_cornell_box_scene(light_intensity: float = 15.0) -> SceneDesc:
    """Cornell-style box: white walls, red/green side walls, emissive ceiling
    quad, one metal and one glass sphere.  Exercises emission + multi-bounce
    + RR (BASELINE.md config #2)."""
    scene = SceneDesc()
    white = scene.add_material(Material([0.73, 0.73, 0.73], roughness=0.9, ior=1.0))
    red = scene.add_material(Material([0.65, 0.05, 0.05], roughness=0.9, ior=1.0))
    green = scene.add_material(Material([0.12, 0.45, 0.15], roughness=0.9, ior=1.0))
    lamp = scene.add_material(mats.light((1.0, 0.9, 0.75), light_intensity))
    mirror = scene.add_material(mats.silver())
    glass = scene.add_material(mats.glass())

    def quad(p0, p1, p2, p3, mat):
        mesh = MeshData(
            positions=np.array([p0, p1, p2, p3], np.float32),
            indices=np.array([[0, 1, 2], [0, 2, 3]], np.uint32),
            material_id=mat,
        )
        mid = scene.add_mesh(mesh)
        scene.add_instance(mid, np.eye(4, dtype=np.float32), material_id=mat)

    s = 2.75  # half box size
    # floor / ceiling / back / left(red) / right(green)
    quad([-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s], white)
    quad([-s, 2 * s, -s], [-s, 2 * s, s], [s, 2 * s, s], [s, 2 * s, -s], white)
    quad([-s, 0, -s], [-s, 2 * s, -s], [s, 2 * s, -s], [s, 0, -s], white)
    quad([-s, 0, -s], [-s, 0, s], [-s, 2 * s, s], [-s, 2 * s, -s], red)
    quad([s, 0, -s], [s, 2 * s, -s], [s, 2 * s, s], [s, 0, s], green)
    # ceiling light (slightly below ceiling, facing down)
    l = 0.9
    quad([-l, 2 * s - 0.01, -l], [l, 2 * s - 0.01, -l],
         [l, 2 * s - 0.01, l], [-l, 2 * s - 0.01, l], lamp)
    # spheres
    scene.add_sphere([-1.1, 0.9, -0.9], 0.9, mirror)
    scene.add_sphere([1.1, 0.9, 0.6], 0.9, glass)
    return scene

