"""A configuration's scene as plain numpy arrays, and its conversion to the
port's public scene API.

A configuration file (``portbench/configs/<name>.json``) holds its scene as
data: materials, meshes (positions and indices), instances with their 4x4
world-from-object transforms, spheres, directional lights, the camera and
the render settings.  ``scene_data`` turns that into numpy arrays; the harness
hands the same arrays to the port (``port_scene``, ``port_lights``,
``port_camera``) and to the plain reference (``portbench.reference``), which
works out everything the port derives from them on its own.

Nothing here imports the port at module level: ``port_*`` import it when
called.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Material(NamedTuple):
    base_color: np.ndarray          # (3,) float32
    emission: np.ndarray            # (3,) float32
    metallic: float                 # clamped to [0, 1]
    roughness: float                # clamped to [0.01, 1]
    ior: float
    dielectric: bool


class Mesh(NamedTuple):
    positions: np.ndarray           # (V, 3) float32
    indices: np.ndarray             # (T, 3) int64
    material: int


class Instance(NamedTuple):
    mesh: int
    world_from_object: np.ndarray   # (4, 4) float32
    material: Optional[int]         # override, None for the mesh's own


class SceneData(NamedTuple):
    materials: list
    meshes: list
    instances: list
    sphere_center: np.ndarray       # (S, 3) float32
    sphere_radius: np.ndarray       # (S,) float32
    sphere_material: np.ndarray     # (S,) int64
    lights: list                    # dicts: kind, direction, colour, ...
    environment: str
    camera: dict                    # position, target, fov_degrees
    render: dict                    # width, height, spp, max_depth, ...


def _material(spec: dict) -> Material:
    return Material(
        base_color=np.asarray(spec.get("base_color", [0.8, 0.8, 0.8]),
                              np.float32),
        emission=np.asarray(spec.get("emission", [0.0, 0.0, 0.0]),
                            np.float32),
        metallic=float(np.clip(spec.get("metallic", 0.0), 0.0, 1.0)),
        roughness=float(np.clip(spec.get("roughness", 0.5), 0.01, 1.0)),
        ior=float(spec.get("ior", 1.5)),
        dielectric=bool(spec.get("dielectric", False)))


def _mesh(spec: dict) -> Mesh:
    return Mesh(np.asarray(spec["positions"], np.float32).reshape(-1, 3),
                np.asarray(spec["indices"], np.int64).reshape(-1, 3),
                int(spec.get("material", 0)))


def scene_data(config: dict) -> SceneData:
    """The configuration's scene as arrays (see the module docstring)."""
    spheres = config.get("spheres", [])
    return SceneData(
        materials=[_material(m) for m in config["materials"]],
        meshes=[_mesh(m) for m in config.get("meshes", [])],
        instances=[Instance(int(i["mesh"]),
                            np.asarray(i["world_from_object"], np.float32),
                            i.get("material"))
                   for i in config.get("instances", [])],
        sphere_center=np.asarray([s["center"] for s in spheres],
                                 np.float32).reshape(-1, 3),
        sphere_radius=np.asarray([s["radius"] for s in spheres], np.float32),
        sphere_material=np.asarray([s["material"] for s in spheres],
                                   np.int64),
        lights=list(config.get("lights", [])),
        environment=config.get("environment", "procedural_sky"),
        camera=dict(config["camera"]),
        render=dict(config["render"]),
    )


def camera_yaw_pitch(camera: dict):
    """(position float64 (3,), yaw, pitch in degrees) of a camera given by
    position and target (Camera.cpp:19-27)."""
    pos = np.asarray(camera["position"], np.float64)
    d = np.asarray(camera["target"], np.float64) - pos
    d = d / np.linalg.norm(d)
    yaw = float(np.degrees(np.arctan2(d[2], d[0])))
    pitch = float(np.degrees(np.arcsin(np.clip(d[1], -1.0, 1.0))))
    return pos, yaw, pitch


# --- the port's side --------------------------------------------------------

def port_scene(data: SceneData):
    """The port's SceneDesc of `data`, through its public scene API."""
    from spt_tpu_torch.scene import desc as pdesc

    d = pdesc.SceneDesc()
    for m in data.materials:
        d.add_material(pdesc.Material(
            base_color=m.base_color, emission=m.emission, metallic=m.metallic,
            roughness=m.roughness, ior=m.ior,
            mat_type=(pdesc.MATERIAL_TYPE_DIELECTRIC if m.dielectric
                      else pdesc.MATERIAL_TYPE_PBR)))
    for m in data.meshes:
        d.add_mesh(pdesc.MeshData(positions=m.positions,
                                  indices=m.indices.astype(np.uint32),
                                  material_id=m.material))
    for inst in data.instances:
        d.add_instance(inst.mesh, inst.world_from_object,
                       material_id=(pdesc.NO_MATERIAL if inst.material is None
                                    else int(inst.material)))
    for c, r, mid in zip(data.sphere_center, data.sphere_radius,
                         data.sphere_material):
        d.add_sphere(c, float(r), int(mid))
    return d


def port_lights(data: SceneData, device):
    from spt_tpu_torch.lights import LightManager

    lm = LightManager()
    for lt in data.lights:
        if lt["kind"] == "directional":
            lm.add_directional_light(lt["direction"], lt["color"],
                                     lt["intensity"])
        else:
            raise ValueError(f"unknown light kind {lt['kind']!r}")
    return lm.device(device)


def port_camera(data: SceneData, width: int, height: int):
    from spt_tpu_torch.camera import Camera

    cam = data.camera
    return Camera(position=tuple(cam["position"]), target=tuple(cam["target"]),
                  fov_degrees=float(cam["fov_degrees"]),
                  aspect_ratio=width / height)
