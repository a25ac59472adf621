"""Wavefront integrator: the depth loop in few kernel launches.

The counterpart of ``spt_tpu.integrators.wavefront``: ``integrator``
"masked" (the default), "compact" and "regen".  A masked sample is
gen_primary, then the depth loop, then the deferred environment term: a
lane dies at most once by missing and keeps its direction and throughput
frozen, so one environment evaluation after the loop replaces one per
bounce.

- Small scenes and mesh scenes whose lane count cannot be sorted: the whole
  loop in ``cuda_bounce.fused_frame``.
- Mesh scenes (a cluster accel: resident, instanced or stream) at a
  sortable lane count (``_ray_sort_ok``, after the JAX package's dead-lane
  padding): ``_fused_mesh_sorted_frame`` — fused_bounce, chunked coherence sorts,
  condense, fused_frame from bounce ``ray_sort_stages``, un-condense,
  unsort.  Sorting only regroups lanes; the image matches the unsorted
  frame to float tolerance.

The compact path (``_wavefront_compact``) bounces every lane once through
``cuda_bounce.fused_bounce``, then packs the live lanes into a queue
(``ops/compaction``) and bounces them in fixed-width chunks through
``transport.trace_bounce`` + ``shade``, the environment applied every bounce.

Every stage is the kernel for a CUDA tensor and its plain PyTorch version
for a CPU tensor; a CUDA run the kernels cannot take raises.  The JAX
package's block swizzle of the lane -> pixel mapping is not ported (RNG is
seeded per pixel, so the image does not depend on lane order), nor its
``SPT_SORT_ABLATE`` and ``SPT_CONDENSE_CHUNK`` hooks.
"""

from __future__ import annotations

import collections
import warnings
from typing import NamedTuple, Tuple

import torch

from spt_tpu_torch.camera import CameraRays
from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.env import Environment, environment_color_v
from spt_tpu_torch.integrators import transport
from spt_tpu_torch.lights import DeviceLights
from spt_tpu_torch.ops import cuda_bounce, ray_sort
from spt_tpu_torch.ops.compaction import (compact_gather, compact_indices,
                                          scatter_back)
from spt_tpu_torch.ops import vec3 as v3
from spt_tpu_torch.ops.vec3 import Vec3
from spt_tpu_torch.scene.flatten import DeviceScene

# Samples the sorted mesh frame finished, by branch ("full_width" or
# "condensed"), so a run can show which one it took.
SORTED_SAMPLES = collections.Counter()

# The condensed sorts' chunk cap (wavefront.py:290's default).
CONDENSE_CHUNK = 32768
# Lanes a row-deal moves together (one 128-lane row).
_DEAL = 128
# Below this many lanes the compact integrator takes the masked path
# (wavefront.py:205).
COMPACT_MIN_LANES = 16384


class WavefrontStats(NamedTuple):
    """Per-bounce telemetry (the frame-0 `rays N -> hits M -> next N'` log,
    OptixBackend.cpp:1690-1695), as device tensors."""

    rays_per_bounce: torch.Tensor   # (max_depth,) int64 — live rays traced
    bounces_run: torch.Tensor       # () int64 — bounces with any live ray


def _queue_width(n: int) -> int:
    """Chunk width of the compact bounce loop (wavefront.py:73-78): about a
    quarter of the lanes, at least 8192, rounded up to a multiple of 1024."""
    w = min(max(8192, n // 4), n)
    return ((w + 1023) // 1024) * 1024 if w >= 1024 else w


def _tile_rows(rows: int) -> int:
    """pallas_bounce._tile_rows: the largest multiple-of-8 divisor of rows
    up to 64, rows itself when it is at most 64, else 0."""
    for cand in range(min(64, rows) // 8 * 8, 0, -8):
        if rows % cand == 0:
            return cand
    return rows if rows <= 64 else 0


def sort_padding(n: int) -> int:
    """Dead lanes the JAX package pads the fused path with
    (wavefront.py:651-655): none when n tiles into (rows, 128) kernel
    blocks, else up to a multiple of 8192."""
    if n % 128 == 0 and _tile_rows(n // 128) > 0:
        return 0
    return -n % (64 * 128)


def _ray_sort_ok(cfg: RenderConfig, scene: DeviceScene, n: int) -> bool:
    """Sort bounce rays: mesh scenes only, a chunkable lane count and at
    least one bounce after the primary (wavefront.py:262-270)."""
    return (cfg.ray_sort and cfg.ray_sort_stages > 0
            and scene.accel is not None and cfg.max_depth > 1
            and ray_sort.chunk_size(n) > 0)


def _condense_plan(cfg: RenderConfig, n: int, chunk: int):
    """(wc, m, mp, sort_chunk) for the post-primary condense, or None
    (wavefront.py:273-317): wc lanes gathered from the head of each chunk,
    m = n_chunks * wc condensed lanes, mp = m padded to a power of two, and
    the condensed sorts' chunk."""
    if not cfg.condense:
        return None
    n_chunks = n // chunk
    if cfg.condense_width > 0:
        wc = min(cfg.condense_width, chunk // 2)
    else:
        wc = min(max(1024, (49152 // n_chunks) // 128 * 128), chunk // 2)
    if wc < 1024 or wc % 128:
        return None
    m = n_chunks * wc
    mp = 1 << (m - 1).bit_length()
    if mp >= n:
        return None
    sort_chunk = min(mp, CONDENSE_CHUNK)
    if mp % sort_chunk or (mp // 128) % 8:
        return None
    return wc, m, mp, sort_chunk


def _pack_flags(ps, missed_ever) -> torch.Tensor:
    return (ps.alive.to(torch.int32) | (ps.emission_ok.to(torch.int32) << 1)
            | (missed_ever.to(torch.int32) << 2))


def _zeros3(like: torch.Tensor) -> Vec3:
    z = torch.zeros_like(like)
    return Vec3(z, z, z)


def _fused_mesh_sorted_frame(cfg: RenderConfig, scene: DeviceScene,
                             env: Environment, lights: DeviceLights, ps):
    """The depth loop with coherence sorts between bounces
    (wavefront.py:320-624):

        fused_bounce(0)                      # full width, pixel order
        -> row-deal -> sort                  # full width, chunk-local
        -> condense                          # gather chunk heads, narrow sort
        -> fused_bounce(1) -> sort -> ... -> fused_frame(start_bounce=S)
        -> un-condense -> scatter -> unsort -> un-interleave

    Primary misses are settled in pixel order before the first sort, so
    every lane that is dead from then on owes nothing.  The condensed branch
    runs when every live lane sits within the first wc lanes of its chunk
    after the first sort; deciding that reads one flag back to the host per
    sample (the JAX package's lax.cond runs on the device).  Returns
    ((N,) radiance Vec3 with the environment term applied, rays
    (max_depth,) int64)."""
    n = ps.num_paths
    chunk = ray_sort.chunk_size(n)
    live0 = ps.alive.sum()
    stages = min(cfg.ray_sort_stages, cfg.max_depth - 1)
    a = scene.accel
    lo = a.cluster_lo.min(0).values
    inv_extent = 1.0 / torch.clamp(a.cluster_hi.max(0).values - lo, min=1e-9)

    ps, missed0 = cuda_bounce.fused_bounce(cfg, scene, lights, ps, 0,
                                           cfg.max_depth == 1)
    env0 = environment_color_v(env, ps.direction, need=missed0)
    rad0 = ps.radiance + v3.where(missed0, ps.throughput * env0,
                                  _zeros3(ps.radiance.x))

    # row-dealt chunking: 128-lane rows go round-robin to the sort chunks,
    # so every chunk receives about the same number of survivors
    n_chunks = n // chunk
    g = chunk // _DEAL

    def interleave(x):
        return x.reshape(g, n_chunks, _DEAL).transpose(0, 1).reshape(n)

    def uninterleave(x):
        return x.reshape(n_chunks, g, _DEAL).transpose(0, 1).reshape(n)

    flags0 = interleave(_pack_flags(ps, torch.zeros_like(missed0)))
    o, d, thr = (Vec3(*(interleave(c) for c in v))
                 for v in (ps.origin, ps.direction, ps.throughput))
    ps = transport.PathState(
        origin=o, direction=d, throughput=thr, radiance=_zeros3(o.x),
        rng=interleave(ps.rng), alive=(flags0 & 1) != 0,
        emission_ok=(flags0 & 2) != 0)
    missed_ever = (flags0 & 4) != 0
    orig_lane = torch.arange(n, dtype=torch.int64, device=live0.device)

    def sort_state(ps, missed_ever, lane, chunk_, carry_rad):
        """One coherence sort of the path state and `lane`; the first
        sort's radiance is all zero and is not carried."""
        key = ray_sort.sort_key(ps.direction, ps.origin, ps.alive, lo,
                                inv_extent)
        _, out = ray_sort.sort_by_key(key, [
            lane, *ps.origin, *ps.direction, *ps.throughput,
            *(ps.radiance if carry_rad else ()), ps.rng,
            _pack_flags(ps, missed_ever)], chunk_)
        lane, o, d, thr = out[0], Vec3(*out[1:4]), Vec3(*out[4:7]), Vec3(*out[7:10])
        rad = Vec3(*out[10:13]) if carry_rad else _zeros3(o.x)
        rng, flags = out[-2], out[-1]
        return transport.PathState(
            origin=o, direction=d, throughput=thr, radiance=rad, rng=rng,
            alive=(flags & 1) != 0, emission_ok=(flags & 2) != 0,
        ), (flags & 4) != 0, lane

    ps, missed_ever, orig_lane = sort_state(ps, missed_ever, orig_lane, chunk,
                                            carry_rad=False)

    def rest_of_frame(ps, missed_ever, lane, chunk_):
        """Bounces 1..S-1 with a re-sort after each, then fused_frame, at
        whatever width `ps` has.  Returns (radiance with the deferred env
        applied, lane, rays with entry 0 left zero)."""
        rays_tail = []
        for b in range(1, stages):
            rays_tail.append(ps.alive.sum())
            ps, missed = cuda_bounce.fused_bounce(cfg, scene, lights, ps, b,
                                                  b == cfg.max_depth - 1)
            missed_ever = missed_ever | missed
            ps, missed_ever, lane = sort_state(ps, missed_ever, lane, chunk_,
                                               carry_rad=True)
        rays_tail.append(ps.alive.sum())
        radiance, direction, throughput, missed, rays_f = (
            cuda_bounce.fused_frame(cfg, scene, lights, ps,
                                    start_bounce=stages))
        missed_ever = missed_ever | missed
        env_c = environment_color_v(env, direction, need=missed_ever)
        radiance = radiance + v3.where(missed_ever, throughput * env_c,
                                       _zeros3(radiance.x))
        rays = torch.stack([torch.zeros_like(rays_f[0])] + rays_tail
                           + [rays_f[b] for b in range(stages + 1,
                                                       cfg.max_depth)])
        return radiance, lane, rays

    plan = _condense_plan(cfg, n, chunk)
    safe = False
    if plan is not None:
        wc, m, mp, sort_chunk = plan
        pos = torch.arange(n, device=live0.device) % chunk
        # gather-safety: every live lane within the first wc of its chunk
        safe = bool(torch.where(ps.alive, pos, -1).max() < wc)
    if not safe:
        SORTED_SAMPLES["full_width"] += 1
        radiance, orig_lane, rays_rest = rest_of_frame(ps, missed_ever,
                                                       orig_lane, chunk)
    else:
        SORTED_SAMPLES["condensed"] += 1

        def head(x):
            h = x.reshape(n_chunks, chunk)[:, :wc].reshape(m)
            return torch.nn.functional.pad(h, (0, mp - m)) if mp > m else h

        flags_h = head(_pack_flags(ps, missed_ever))
        o_h = Vec3(*(head(c) for c in ps.origin))
        d_h = Vec3(*(head(c) for c in ps.direction))
        key = ray_sort.sort_key(d_h, o_h, (flags_h & 1) != 0, lo, inv_extent)
        # cl_lane (the condensed array's own lane ids) rides every condensed
        # sort; the un-condense restores gather order, so `orig_lane` never
        # sees the cross-chunk moves
        cl_lane, out = ray_sort.sort_by_key(key, [
            *o_h, *d_h, *(head(c) for c in ps.throughput), head(ps.rng),
            flags_h], sort_chunk)
        o, d, thr = Vec3(*out[0:3]), Vec3(*out[3:6]), Vec3(*out[6:9])
        ps_c = transport.PathState(
            origin=o, direction=d, throughput=thr, radiance=_zeros3(o.x),
            rng=out[9], alive=(out[10] & 1) != 0,
            emission_ok=(out[10] & 2) != 0)
        radiance_c, cl_lane, rays_rest = rest_of_frame(
            ps_c, (out[10] & 4) != 0, cl_lane, sort_chunk)
        back = ray_sort.unsort_by_lane(cl_lane, list(radiance_c), sort_chunk)

        def scatter(vals):
            # lanes outside the heads are dead with their env term settled
            full = torch.zeros((n_chunks, chunk), dtype=vals.dtype,
                               device=vals.device)
            full[:, :wc] = vals[:m].reshape(n_chunks, wc)
            return full.reshape(n)

        radiance = Vec3(*(scatter(c) for c in back))

    out = ray_sort.unsort_by_lane(orig_lane, list(radiance), chunk)
    radiance = rad0 + Vec3(*(uninterleave(c) for c in out))
    rays = torch.cat([live0.reshape(1), rays_rest[1:]])
    return radiance, rays


def _wavefront_masked(cfg: RenderConfig, scene: DeviceScene, env: Environment,
                      lights: DeviceLights, ps: transport.PathState):
    """The depth loop of one sample plus the deferred env term
    (wavefront.py:627-682 with fused=True)."""
    n = ps.num_paths
    n_pad = sort_padding(n)
    if _ray_sort_ok(cfg, scene, n + n_pad):
        if n_pad:
            def pad(t):
                return torch.nn.functional.pad(t, (0, n_pad))

            ps = transport.PathState(
                origin=Vec3(*map(pad, ps.origin)),
                direction=Vec3(*map(pad, ps.direction)),
                throughput=Vec3(*map(pad, ps.throughput)),
                radiance=Vec3(*map(pad, ps.radiance)),
                rng=pad(ps.rng), alive=pad(ps.alive),
                emission_ok=pad(ps.emission_ok))
        radiance, rays = _fused_mesh_sorted_frame(cfg, scene, env, lights, ps)
        radiance = Vec3(*(c[:n] for c in radiance))
    else:
        radiance, direction, throughput, missed_ever, rays = (
            cuda_bounce.fused_frame(cfg, scene, lights, ps))
        env_c = environment_color_v(env, direction, need=missed_ever)
        radiance = radiance + v3.where(missed_ever, throughput * env_c,
                                       _zeros3(radiance.x))
    bounces = (rays > 0).sum()
    return radiance.to_array(), WavefrontStats(rays_per_bounce=rays,
                                               bounces_run=bounces)


def _bounce(cfg: RenderConfig, scene: DeviceScene, env: Environment,
            lights: DeviceLights, ps, bounce: int, is_last: bool,
            fused: bool = False):
    """One full bounce with the environment term applied to the lanes that
    missed (wavefront.py:150-158): through fused_bounce (K3) when `fused`,
    else through trace_bounce + shade (the standalone tracers on a mesh
    scene on the card)."""
    if not fused:
        hit = transport.trace_bounce(scene, ps)
        return transport.shade(cfg, scene, env, lights, ps, hit, bounce,
                               is_last)
    new_ps, missed = cuda_bounce.fused_bounce(cfg, scene, lights, ps, bounce,
                                              is_last)
    env_c = environment_color_v(env, ps.direction, need=missed)
    radiance = new_ps.radiance + v3.where(missed, ps.throughput * env_c,
                                          _zeros3(ps.radiance.x))
    return new_ps._replace(radiance=radiance)


def _wavefront_compact(cfg: RenderConfig, scene: DeviceScene,
                       env: Environment, lights: DeviceLights, ps):
    """The compacted depth loop of one sample (wavefront.py:205-259).

    Bounce 0 runs over every lane through fused_bounce (K3: the small form
    on small scenes, the mesh forms on mesh scenes).  Each later bounce
    packs the live lanes into a queue by an exclusive scan and bounces them
    in chunks of ``_queue_width(N)`` lanes, fused=False as the JAX
    package's chunks do.  The queue is padded to a whole number of chunks
    with entries that point past the last lane: they gather a masked-dead
    lane and scatter into a scratch lane, so no chunk slides backwards and
    bounces a lane twice.  The JAX package keeps the live count and the
    chunk count on the device (lax.while_loop / fori_loop); here the live
    count is read to the host once per bounce, which decides both whether
    the loop goes on and how many chunks to launch.

    Returns ((N, 3) radiance, stats); rays_per_bounce equals the masked
    path's."""
    n = ps.num_paths
    device = ps.rng.device
    rays = torch.zeros(cfg.max_depth, dtype=torch.int64, device=device)
    rays[0] = n
    ps = _bounce(cfg, scene, env, lights, ps, 0, cfg.max_depth == 1,
                 fused=True)
    w = _queue_width(n)
    pad = torch.full(((n + w - 1) // w * w - n,), n, dtype=torch.int64,
                     device=device)
    lane = torch.arange(w, device=device)
    bounce = 1
    while bounce < cfg.max_depth:
        queue, count = compact_indices(ps.alive)
        live = int(count)       # the one host read of the bounce
        if live == 0:
            break
        rays[bounce] = count
        queue = torch.cat([queue, pad])
        is_last = bounce == cfg.max_depth - 1
        for start in range(0, live, w):
            idx = queue[start:start + w]
            valid = (start + lane) < live
            sub = compact_gather(ps, idx)
            sub = sub._replace(alive=sub.alive & valid)
            sub = _bounce(cfg, scene, env, lights, sub, bounce, is_last)
            ps = scatter_back(sub, idx, ps, live - start)
        bounce += 1
    return ps.radiance.to_array(), WavefrontStats(
        rays_per_bounce=rays,
        bounces_run=torch.tensor(bounce, dtype=torch.int64, device=device))


def wavefront_sample(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index,
    sample_index: int = 0,
    compact: bool = False,
) -> Tuple[torch.Tensor, WavefrontStats]:
    """One sample per pixel -> ((N, 3) radiance, stats).  `compact` takes
    the compacted loop, except below COMPACT_MIN_LANES lanes or at depth 1,
    where the masked path runs (wavefront.py:205)."""
    ps = transport.gen_primary(cfg, camera, frame_index, sample_index)
    if (compact and cfg.max_depth > 1
            and ps.num_paths >= COMPACT_MIN_LANES):
        return _wavefront_compact(cfg, scene, env, lights, ps)
    return _wavefront_masked(cfg, scene, env, lights, ps)


def render_wavefront(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index=0,
    compact: bool = False,
) -> Tuple[torch.Tensor, WavefrontStats]:
    """cfg.spp samples -> ((H, W, 3) linear radiance, summed stats).

    Lane scheduling comes from cfg.integrator ("masked" | "compact" |
    "regen"); the `compact` argument is an explicit override for A/B runs,
    as in the JAX package."""
    if cfg.integrator == "regen":
        return render_wavefront_regen(cfg, scene, env, lights, camera,
                                      frame_index)
    if cfg.integrator not in ("masked", "compact"):
        raise ValueError(
            f"integrator={cfg.integrator!r} is not a wavefront integrator "
            "('masked', 'compact' or 'regen'); the megakernel renders "
            "through integrators.megakernel")
    compact = compact or cfg.integrator == "compact"
    device = camera.position.device
    acc = torch.zeros((cfg.num_pixels, 3), dtype=torch.float32, device=device)
    rays = torch.zeros(cfg.max_depth, dtype=torch.int64, device=device)
    bounces = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(cfg.spp):
        rad, stats = wavefront_sample(cfg, scene, env, lights, camera,
                                      frame_index, s, compact=compact)
        acc = acc + rad
        rays = rays + stats.rays_per_bounce
        bounces = torch.maximum(bounces, stats.bounces_run)
    img = (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return img, WavefrontStats(rays_per_bounce=rays, bounces_run=bounces)


def render_wavefront_regen(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index=0,
) -> Tuple[torch.Tensor, WavefrontStats]:
    """Path regeneration (wavefront.py:805-909): the whole cfg.spp budget in
    one loop.  The moment a lane's path ends, its radiance is retired into
    the lane's accumulator and the lane restarts with its pixel's next
    sample; the sample set and its RNG streams are those of
    render_wavefront.  Every iteration traces through
    ``transport.trace_bounce`` and ``transport.shade`` — on a mesh scene
    the standalone cluster or instanced tracer (``ops/cuda_trace``), with
    no fused kernels and no coherence sorts.  One host read per iteration decides
    whether any lane is left."""
    if scene.accel is not None or scene.inst is not None:
        warnings.warn(
            "integrator 'regen' traces mesh scenes without the fused kernels "
            "or the coherence sorts: expect several times the 'masked' "
            "integrator's frame time on this scene", stacklevel=2)
    n = cfg.num_pixels
    device = camera.position.device
    sample_idx = torch.zeros(n, dtype=torch.int64, device=device)
    ps = transport.primary_lanes(cfg, camera, frame_index, sample_idx,
                                 cfg.spp > 1)
    accum = _zeros3(ps.radiance.x)
    bounce = torch.zeros(n, dtype=torch.int64, device=device)
    rays = torch.zeros(cfg.max_depth, dtype=torch.int64, device=device)
    depths = torch.arange(cfg.max_depth, device=device)
    it = 0
    while it < cfg.spp * cfg.max_depth and bool(ps.alive.any()):
        was_alive = ps.alive
        rays = rays + ((bounce[None, :] == depths[:, None])
                       & was_alive[None, :]).sum(1)
        hit = transport.trace_bounce(scene, ps)
        ps = transport.shade(cfg, scene, env, lights, ps, hit, bounce=bounce,
                             is_last=bounce >= cfg.max_depth - 1)
        bounce = torch.where(was_alive, bounce + 1, bounce)
        died = was_alive & ~ps.alive
        accum = accum + v3.where(died, ps.radiance, _zeros3(accum.x))
        sample_next = sample_idx + died.to(torch.int64)
        respawn = died & (sample_next < cfg.spp)
        fresh = transport.primary_lanes(cfg, camera, frame_index, sample_next,
                                        cfg.spp > 1)
        ps = transport.PathState(
            origin=v3.where(respawn, fresh.origin, ps.origin),
            direction=v3.where(respawn, fresh.direction, ps.direction),
            throughput=v3.where(respawn, fresh.throughput, ps.throughput),
            radiance=v3.where(respawn, fresh.radiance, ps.radiance),
            rng=torch.where(respawn, fresh.rng, ps.rng),
            alive=ps.alive | respawn,
            emission_ok=ps.emission_ok | respawn,
        )
        bounce = torch.where(respawn, 0, bounce)
        sample_idx = sample_next
        it += 1
    img = accum.to_array() / cfg.spp
    return img.reshape(cfg.height, cfg.width, 3), WavefrontStats(
        rays_per_bounce=rays,
        bounces_run=torch.tensor(it, dtype=torch.int64, device=device))
