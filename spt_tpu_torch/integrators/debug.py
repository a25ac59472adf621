"""Debug render modes: the reference's bring-up views.

The counterpart of ``spt_tpu.integrators.debug``.  The reference keeps a
legacy raygen for debugging (__raygen__rg, device_programs.cu:695-849) with
two modes in LaunchParams (debug_mode, LaunchParams.h:76-78):

- "geomtype": triangles red, spheres green (device_programs.cu:837-846);
- "hitmiss": hit white, miss black (cu:727-731);

plus "normal" (the Ng visualization the GPU paints at max depth,
cu:424-439), "depth" (a 1/(1+t) ramp) and "matid" (a material-id palette,
MaterialManager.cpp:105-133).  One closest-hit trace of the primary rays
through ``intersect_v``: on a mesh scene on the card, the standalone
tracer kernel of its tier.
"""

from __future__ import annotations

import torch

from spt_tpu_torch.camera import CameraRays
from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.integrators import transport
from spt_tpu_torch.ops import intersect as isect
from spt_tpu_torch.ops import vec3 as v3
from spt_tpu_torch.scene.flatten import DeviceScene

MODES = ("geomtype", "hitmiss", "normal", "depth", "matid")

# MaterialManager::getColorFromGeometryID-style palette (MaterialManager.cpp:
# 105-133): distinct colors cycling by id.
_PALETTE = (
    (1.0, 0.2, 0.2), (0.2, 1.0, 0.2), (0.2, 0.2, 1.0),
    (1.0, 1.0, 0.2), (1.0, 0.2, 1.0), (0.2, 1.0, 1.0),
    (1.0, 0.6, 0.2), (0.6, 0.2, 1.0), (0.7, 0.7, 0.7),
)


def render_debug(
    cfg: RenderConfig,
    scene: DeviceScene,
    camera: CameraRays,
    mode: str = "geomtype",
) -> torch.Tensor:
    """Single primary-ray debug image -> (H, W, 3) in [0, 1], on the
    camera's device."""
    if mode not in MODES:
        raise ValueError(f"debug mode {mode!r} not in {MODES}")
    ps = transport.gen_primary(cfg.replace(jitter=False), camera, 0)
    hit = isect.intersect_v(scene, ps.origin, ps.direction, tmin=0.0)
    n = ps.num_paths
    device = ps.rng.device
    hitm = hit.hit_mask.to(torch.float32)

    if mode == "hitmiss":
        img = torch.stack([hitm, hitm, hitm], -1)
    elif mode == "geomtype":
        r = (hit.kind == isect.KIND_TRIANGLE).to(torch.float32)
        g = (hit.kind == isect.KIND_SPHERE).to(torch.float32)
        img = torch.stack([r, g, torch.zeros_like(r)], -1)
    elif mode == "normal":
        up = v3.Vec3.full((0.0, 1.0, 0.0), (n,), device)
        nvis = (v3.normalize_or(hit.normal, up) + 1.0) * 0.5
        img = nvis.to_array() * hitm[:, None]
    elif mode == "depth":
        t = torch.where(hit.hit_mask, hit.t, float("inf"))
        c = 1.0 / (1.0 + t)
        img = torch.stack([c, c, c], -1)
    else:  # matid
        palette = torch.tensor(_PALETTE, dtype=torch.float32, device=device)
        col = palette[torch.remainder(hit.mat_id.long(), len(_PALETTE))]
        img = col * hitm[:, None]
    return torch.clamp(img, 0.0, 1.0).reshape(cfg.height, cfg.width, 3)
