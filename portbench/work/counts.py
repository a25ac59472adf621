"""Operations and bytes of a frame, counted from its inputs.

Operations are float32 arithmetic (add, subtract, multiply, divide, square
root, reciprocal square root, sine, cosine); compares, selects and integer
RNG hashing are not counted.  Each count below is derived from the
algorithm, not from a kernel:

``TRI_TEST`` = 46, a ray against a triangle (Moller-Trumbore with the
triangle held as v0, e1 = v1 - v0, e2 = v2 - v0):
  h = d x e2 (6 mul, 3 sub: 9); a = e1 . h (3 mul, 2 add: 5); 1 / a (1);
  s = o - v0 (3); u = inv (s . h) (5 + 1: 6); q = s x e1 (9);
  v = inv (d . q) (6); t = inv (e2 . q) (6); u + v (1).
``SPHERE_TEST`` = 20, a ray against a sphere:
  oc = o - c (3); b = oc . d (5); c = oc . oc - r r (5 + 1 + 1: 7);
  b b - c (2); sqrt (1); t0, t1 = -b -+ sqrt (2).
``SHADE_HIT`` = 88 and ``SHADE_LIGHT`` = 118, a surface hit, at least:
  the hit point o + d t (6); the normal normalised and faced against the
  ray (9 + 5: 14); the view direction normalised (9); the cheapest
  scatter, the dielectric's (eta 1, cos 5, Schlick 10, refract 20,
  reflect and normalise 17, origin 6: 59); and for each analytic light:
  n . l (5), the offset shadow origin (7), Cook-Torrance GGX x NdotL
  (half vector 12, four dots 20, alpha 2, D 7, G 11, F0 7, F 13, the
  specular scale 5, specular 3, kd 3, diffuse 5, sum x NdotL 9: 97),
  throughput x BRDF x radiance added to the path (9).
``PRIMARY`` = 29, a camera ray: jitter to the film (4), film to [-1, 1]
  (4), the direction (12) normalised (9).
``ACCUMULATE`` = 6, a pixel a frame: the frame's radiance times spp added
  to the sums (3 mul, 3 add); a frame of spp > 1 adds 3 (spp - 1) + 3 for
  the mean of its samples.

Which rays meet which primitives: a scene of at most 192 primitives has no
acceleration structure by the algorithm's rule (intersect.py's
UNROLL_LIMIT), so every closest-hit ray and every shadow ray is tested
against every primitive.  An unblocked shadow ray needs every test, and
most are unblocked in the sunlit scenes; a blocked one could stop at its
blocker.  Rays are ``rays.count_rays``'s, a lower bound.  Surface hits are
the lanes alive at the next bounce (a lower bound: a lane that hits at the
last bounce, or ends by roulette, is not counted); misses are not counted.

Bytes: each input read once and each output written once, a frame: the
accumulation sums of every pixel read and written (12 + 12 bytes) with its
sample count and frame index (8 + 8), the triangle table (v0, e1, e2 and a
material id: 40 bytes a triangle), the spheres (centre, radius, material:
20), the materials (base colour, emission, metallic, roughness, ior, type,
transparency, texture id: 44), the lights (kind, vector, colour,
intensity, attenuation: 44) and the camera (14 floats: 56).

A scene past 192 primitives is traced through an acceleration structure
whose walk the counts do not model yet: ``frame_work`` returns None.
"""

from __future__ import annotations

import numpy as np

from portbench.work.rays import count_rays

TRI_TEST = 46
SPHERE_TEST = 20
SHADE_HIT = 88
SHADE_LIGHT = 118
PRIMARY = 29
ACCUMULATE = 6
BRUTE_FORCE_MAX = 192

BYTES_PIXEL = 12 + 12
BYTES_STATE = 8 + 8
BYTES_TRI = 40
BYTES_SPHERE = 20
BYTES_MATERIAL = 44
BYTES_LIGHT = 44
BYTES_CAMERA = 56


def world_triangles(scene) -> int:
    return sum(len(scene.meshes[i.mesh].indices) for i in scene.instances)


def frame_work(scene, render: dict, rays_per_bounce, n_shadow: int):
    """{"flops", "bytes"} of one frame whose summed rays a bounce are
    `rays_per_bounce`, or None for a scene past ``BRUTE_FORCE_MAX``
    primitives (module docstring)."""
    tris = world_triangles(scene)
    spheres = len(scene.sphere_radius)
    if tris + spheres > BRUTE_FORCE_MAX:
        return None
    rays = np.asarray(rays_per_bounce, np.int64).reshape(-1)
    traced = count_rays(rays, n_shadow)
    hits = int(rays[1:].sum()) if rays.size > 1 else 0
    pixels = int(render["width"]) * int(render["height"])
    spp = int(render.get("spp", 1))
    flops = (traced * (tris * TRI_TEST + spheres * SPHERE_TEST)
             + hits * (SHADE_HIT + len(scene.lights) * SHADE_LIGHT)
             + pixels * spp * PRIMARY
             + pixels * (ACCUMULATE + (3 * (spp - 1) + 3 if spp > 1 else 0)))
    nbytes = (pixels * BYTES_PIXEL + BYTES_STATE + tris * BYTES_TRI
              + spheres * BYTES_SPHERE
              + len(scene.materials) * BYTES_MATERIAL
              + len(scene.lights) * BYTES_LIGHT + BYTES_CAMERA)
    return {"flops": float(flops), "bytes": float(nbytes)}


def least_seconds(work: dict, peak: dict) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(work["flops"] / peak["fp32_flops_per_s"],
               work["bytes"] / peak["hbm_bytes_per_s"])
