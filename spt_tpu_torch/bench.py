"""Ray counting with the JAX package's bench.py convention (bench.py:31-62).

Copied, not imported, so that a Mrays/s figure of the port means what the
JAX package's figure means.
"""

from __future__ import annotations

import numpy as np


def shadow_rays_per_surface_lane(renderer) -> int:
    """Occlusion rays traced per surface-hit lane per bounce: one per active
    analytic light (KIND_NONE padding rows trace nothing) plus one for NEE
    when the scene has emitters."""
    cfg = renderer.cfg
    if not cfg.shadow_rays:
        return 0
    kinds = renderer.lights.kind.cpu().numpy().reshape(-1)
    n_lights = int((kinds != 0).sum())
    nee = int(cfg.nee and renderer.scene.emitters is not None)
    return n_lights + nee


def count_rays(stats, n_shadow: int) -> int:
    """Rays traced: per-bounce live lanes + shadow rays.  Live lanes at
    bounce b > 0 all hit a surface at bounce b-1 and traced `n_shadow`
    occlusion rays there; terminated lanes are assumed to have missed, so
    the count is a lower bound."""
    rays = np.asarray(stats.rays_per_bounce.cpu(), np.int64)
    primary_and_bounce = int(rays.sum())
    if n_shadow > 0 and rays.size > 1:
        shadow = int(rays[1:].sum()) * n_shadow
    else:
        shadow = 0
    return primary_and_bounce + shadow
