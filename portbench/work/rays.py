"""Rays traced, by the JAX package's ``bench.py`` convention (bench.py:
31-62, copied from ``spt_tpu_torch/bench.py`` ``count_rays`` and
``shadow_rays_per_surface_lane``), so that a count of the port means what
a count of the JAX package means."""

from __future__ import annotations

import numpy as np


def shadow_rays_per_surface_lane(scene, render: dict) -> int:
    """Occlusion rays a surface-hit lane traces a bounce: one an analytic
    light, and one for next-event estimation when the scene has emissive
    materials and NEE is on.  `scene` is a ``portbench.scenes.SceneData``."""
    if not render.get("shadow_rays", True):
        return 0
    nee = render.get("nee", True) and any(
        float(np.max(m.emission)) > 0.0 for m in scene.materials) and any(
        scene.meshes)
    return len(scene.lights) + int(nee)


def count_rays(rays_per_bounce, n_shadow: int) -> int:
    """Live lanes summed over the bounces, plus `n_shadow` shadow rays for
    every lane alive at bounce b > 0 (it hit a surface at bounce b - 1).
    Lanes that end are taken to have missed, so the count is a lower
    bound."""
    rays = np.asarray(rays_per_bounce, np.int64).reshape(-1)
    total = int(rays.sum())
    if n_shadow > 0 and rays.size > 1:
        total += int(rays[1:].sum()) * n_shadow
    return total
