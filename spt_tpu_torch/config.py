"""Render configuration — the same frozen dataclass as ``spt_tpu.config``.

Fields and defaults match field for field, so one config maps 1:1 between
the JAX package and this port.  ``ray_sort``, ``ray_sort_stages``,
``condense`` and ``condense_width`` drive the sorted mesh frame
(integrators/wavefront.py) on scenes with a cluster accel, as in the JAX
package; they regroup lanes and leave the image unchanged to float
tolerance.  ``swizzle`` is accepted and has no effect: the port keeps
pixels in row-major lane order (RNG is seeded per pixel).  Every
``integrator`` is ported: "masked", "compact" and "regen"
(integrators/wavefront.py) and "megakernel" (integrators/megakernel.py).

The reference scatters its knobs across compile-time constants: image size and
tile size (GLRenderer.h:34-36), spp=4 / max_depth=6 (main.cpp:108-109), GPU
maxDepth=6 (OptixBackend.cpp:1603), exposure/gamma 2.2 (OptixBackend.cpp:
1566-1567), environment intensity 0.8 / clamp 5.0 (EnvironmentManager.h:12-13),
and the default HDR path (PathTracer.cpp:24).  Here they are lifted into one
frozen dataclass, as SURVEY.md §5 prescribes.

Quirk decisions (SURVEY.md §5 "behavioral quirks"):

- quirk 1: we accumulate linear HDR and tonemap once at resolve (the GPU /
  README-intended model, device_programs.cu:854-899); the CPU per-sample
  ACES quirk is reproducible via ``tonemap="aces_per_sample"`` only in tests.
- quirk 2/3: Russian roulette after bounce 2 (wf_pt_cpu.cpp:233-242) and
  shadow rays for direct lighting (Light.cpp:16-40) are both ON — the
  wavefront design the reference planned (wf_types.h:51-63) but never shipped
  on GPU.
- quirk 5: max-depth termination contributes black by default; the GPU's
  normal-visualization debug paint (device_programs.cu:424-439) is available
  as ``depth_term_normal_vis=True`` for A/B parity runs.
- quirk 6: indirect metal uses GGX NDF half-vector sampling with the GPU
  throughput update (device_programs.cu:545-666); ``metal_mirror=True``
  reproduces the CPU megakernel's perfect-mirror fallback
  (PathTracer.cpp:170-176).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All static knobs for one render. Hashable -> usable as a jit static arg."""

    # Image (GLRenderer.h:34-35: 800x600 fixed window)
    width: int = 800
    height: int = 600

    # Sampling (main.cpp:108-109: 4 spp, depth 6)
    spp: int = 1                 # samples per pixel per frame (progressive)
    max_depth: int = 6

    # Subpixel jitter for progressive anti-aliasing. The reference GPU shoots
    # through pixel centers (device_programs.cu:220-234, +0.5); the CPU
    # wavefront driver jitters per frame (GLRenderer.cpp:386-398). Default on.
    jitter: bool = True

    # Russian roulette: applied for diffuse bounces with index > rr_after
    # (wf_pt_cpu.cpp:233: "if (bounce > 2)").  Set rr_after >= max_depth to
    # disable (the GPU wavefront has no RR).
    rr_after: int = 2

    # Display transform at resolve (device_programs.cu:869-888)
    exposure: float = 2.2
    gamma: float = 2.2
    tonemap: str = "reinhard"    # "reinhard" | "aces" | "none"

    # Environment (EnvironmentManager.h:12-13)
    env_intensity: float = 0.8
    env_clamp: float = 5.0

    # Quirk toggles (see module docstring)
    depth_term_normal_vis: bool = False
    metal_mirror: bool = False
    # Indirect metal sampler: True = Heitz VNDF (Material::evaluateSample,
    # Material.cpp:119-234 — implemented by the reference but never called;
    # SURVEY.md §5 quirk 6 prescribes adopting it).  False = the GPU's plain
    # NDF half-vector sampling (device_programs.cu:545-666).
    metal_vndf: bool = True
    # GPU shade skips direct light on tagged dielectrics
    # (device_programs.cu:462 "matType != MATERIAL_TYPE_DIELECTRIC")
    direct_light_dielectric: bool = False
    # Quirk 7 (SURVEY.md §5): the CPU megakernel weights its dielectric
    # branches by the ior-derived transparency factor
    # (PathTracer.cpp:177-209 with Material::getTransparency(),
    # Material.h:62-73): reflection x (1 - transparency), refraction x
    # transparency, total-internal-reflection x 1.  The GPU's tagged
    # dielectric is a pure delta BSDF (throughput unchanged,
    # device_programs.cu:498-543) and is the default here; True reproduces
    # the CPU weighting for A/B, consuming DeviceMaterials.transparency.
    cpu_transparency: bool = False
    # Trace shadow rays for direct lighting (CPU semantics, Light.cpp:16-40).
    shadow_rays: bool = True

    # Next-event estimation toward emissive triangles (area lights): the
    # shadow-ray wavefront the reference planned (wf_types.h:51-63) extended
    # to emitters.  Active only when the scene has an emitter table; paths
    # then count hit emission only on camera/dielectric continuations to
    # avoid double counting.
    nee: bool = True

    # Intersection epsilons. Scale-aware offset eps * max(1, |p|_inf)
    # (PathTracer.cpp:101-111); dielectric continuation offsets along the new
    # direction by ray_offset_dir (device_programs.cu:530 "1e-3f").
    hit_eps: float = 1e-4
    ray_offset_dir: float = 1e-3

    # Anti-firefly clamp on the metal GGX throughput update
    # (device_programs.cu:648 "fminf(scale, 50.0f)")
    firefly_clamp: float = 50.0

    # Wavefront lane scheduling (see integrators/wavefront.py for the
    # measured trade-offs on TPU):
    #   "masked"  — all lanes every bounce, dead lanes masked (the default;
    #               fastest on TPU, where lanes are free and gathers are not).
    #   "compact" — cumsum-compacted queues (the GPU-folklore strategy; kept
    #               as a measured negative result, 9x slower at 1080p).
    #   "regen"   — per-lane path regeneration [Novák et al. 2010]: a lane
    #               restarts with its pixel's next sample the moment its path
    #               dies, folding the whole spp budget into one depth loop.
    integrator: str = "masked"

    # Block-swizzle the lane -> pixel mapping so each kernel tile is a
    # compact image rect instead of a full-width strip: live paths and ray
    # targets cluster spatially, so compact tiles let the fused kernel's
    # whole-tile early-out and the mesh tracer's per-subtile cluster culling
    # actually fire (a 512x384 subtile goes from a 512x2 strip crossing the
    # whole image to a 128x8 rect).  Pure index arithmetic; the image is
    # bitwise identical.  On when the lane count tiles.
    swizzle: bool = True

    # Sort bounce rays by direction octant (+ origin morton) after the
    # primary bounce on mesh scenes, so the cluster tracer's subtile-level
    # culling sees coherent lanes and dead lanes pack into whole-dead
    # subtiles (ops/ray_sort).  Only engages when the scene has a cluster
    # accel and the lane count supports chunked sorting.
    ray_sort: bool = True

    # How many early bounces get their own coherence sort (each sort goes
    # stale after one bounce: fresh diffuse directions decorrelate from the
    # octant key and dying lanes scatter).  Clamped to max_depth - 1.
    # Default 3 since round 5: the round-3 tuning picked 2 pre-rounds /
    # pre-condense, but re-swept on the round-5 kernels a third sort pays
    # on BOTH mesh scenes (8-frame harness: chair 33.0 -> 30.7 ms,
    # bigmesh 55.3 -> 52.8; a fourth is flat at 52.7) — by bounce 2 the
    # condensed array is ~6x narrower, so the sort costs ~nothing while
    # the bounce-2..3 trace still runs on freshly-coherent tiles.
    ray_sort_stages: int = 3

    # Condense the sorted mesh frame after the primary bounce: chunked
    # sorting packs live lanes to the head of EVERY sort chunk (and the
    # row-dealt chunking balances survivor counts across chunks), so when
    # every live lane sits within the first `wc` positions of its chunk
    # (checked at runtime), the chunk heads are gathered into a narrow
    # array and re-sorted ACROSS chunks — all post-primary bounces then
    # run on globally octant-sorted, minimally-many tiles.  Falls back to
    # the full-width path via lax.cond when the bound does not hold.
    # condense_width = 0 sizes the head automatically (~2x headroom over
    # the expected per-chunk survivor share, wavefront._condense_plan);
    # > 0 overrides the per-chunk head width.  A/B at depth 4 on the
    # chair: 36.4 ms/frame without the condense, 19.0 with.
    condense: bool = True
    condense_width: int = 0

    # Compute dtype for shading math. Intersection always runs fp32.
    dtype: str = "float32"

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Reference-parity preset: what OptixBackend::render hardcodes
# (OptixBackend.cpp:1566-1567,1603; no jitter, no RR, no shadow rays).
GPU_PARITY = RenderConfig(
    jitter=False,
    rr_after=10**6,
    shadow_rays=False,
    depth_term_normal_vis=True,
    metal_vndf=False,
)
