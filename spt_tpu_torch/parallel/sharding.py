"""Multi-device scaling: image-space data parallelism over a device mesh.

The counterpart of ``spt_tpu.parallel.sharding``, on ``torch.distributed``
with one process per rank, as ``torchrun`` launches them (NCCL between
cards, gloo between CPU processes):

- one mesh axis "px", a 1-D ``DeviceMesh`` over the process group;
- each rank owns a horizontal band of rows of the image and that band's
  full path state: ``height / world`` rows each, or where
  ``RenderConfig.band_edges`` is set, the bands it names.  The sharded
  Renderer sets them from a probe of the frame's work (``probe_edges``):
  each rank renders a share of the frame's strips of rows one eager frame,
  one all_gather gives every rank the rays each strip traced, and
  ``balanced_edges`` cuts the image where each band holds about 1/world of
  them; on the card each rank then times its band's frame and the cut is
  refined by the gathered times (``refine_edges``), so no band waits at
  the stats' all_reduce for one that holds the scene while another holds
  sky;
- scene, materials, lights and env are replicated (broadcast from rank 0
  once, ``replicate``);
- no collective inside the frame loop: paths never leave their band.  A
  k-frame step ends with one SUM all_reduce of the (max_depth,) ray counts
  and one MAX all_reduce of ``bounces_run``; the image is gathered only
  when the host asks for it (``gather_pixels``);
- on the card a band's k frames are k replays of its captured band step
  (``renderer._captured_step_dyn``; masked, compact or regen bands), the
  counterpart of the JAX package's traced-k fori_loop inside shard_map;
  the two all_reduces follow the replays, outside the graph.

Lanes carry global pixel indices (``transport.gen_primary``'s row0/rows
band), so every band's RNG streams and rays are those of the unsharded
frame.  The per-shard body ``shard_frames`` takes its (rank, world)
explicitly and holds no collective, so any band can also run on its own in
one process.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.engine import state as state_mod
from spt_tpu_torch.engine.renderer import (StaticStep, _captured_step_dyn,
                                           captures, frame_chain,
                                           tree_tensors)
from spt_tpu_torch.integrators import wavefront
from spt_tpu_torch.integrators.wavefront import WavefrontStats
from spt_tpu_torch.ops import ray_sort
from spt_tpu_torch.utils import timing

AXIS = "px"
# The probe cuts the image into strips of at most about this many a rank
STRIPS_PER_RANK = 32
# and of at least this many lanes: a strip of a few warps' paths says
# little of its work from one frame, and a band that small fills no card
MIN_STRIP_LANES = 2048
# On the card the cut is refined by the bands' measured device time: at
# most this many cuts are timed, each band over this many frames
REFINE_ROUNDS = 4
REFINE_FRAMES = 8
# clock cycles of the spin the timed frames queue behind (~5 ms)
_SPIN_CYCLES = 10_000_000


def make_mesh(device_type: Optional[str] = None):
    """1-D DeviceMesh with axis "px" over every rank of the initialized
    default process group.  `device_type` is "cuda" unless the caller asks
    for "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "pixel-band sharding needs a process group: launch with torchrun "
            "(torchrun --nproc-per-node N -m spt_tpu_torch.cli ...) or call "
            "torch.distributed.init_process_group first")
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass device_type="
                           "'cpu' for a gloo group of CPU processes)")
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(AXIS,))


def band(cfg: RenderConfig, rank: int, world: int) -> Tuple[int, int]:
    """(row0, rows) of rank's band of the image: between
    ``cfg.band_edges[rank]`` and ``[rank + 1]`` where they are set, else
    ``height / world`` rows from ``rank * height / world``."""
    edges = cfg.band_edges
    if edges is not None:
        if (len(edges) != world + 1 or edges[0] != 0
                or edges[-1] != cfg.height
                or any(b <= a for a, b in zip(edges, edges[1:]))):
            raise ValueError(f"band edges {edges} do not cut {cfg.height} "
                             f"rows into {world} bands")
        return edges[rank], edges[rank + 1] - edges[rank]
    if cfg.height % world:
        raise ValueError(f"image height {cfg.height} must divide the mesh "
                         f"size {world}")
    rows = cfg.height // world
    return rank * rows, rows


def strip_rows(cfg: RenderConfig, world: int) -> int:
    """The probe's strip, in rows: the least divisor of the equal band's
    ``height / world`` rows that makes at most about STRIPS_PER_RANK strips
    a rank of at least MIN_STRIP_LANES lanes each (the equal band itself
    where none does).  So the equal bands lie on strip edges: 9 rows at
    1920x1080 over 4 ranks, 120 strips."""
    rows = cfg.height // world
    least = max(-(-cfg.height // (STRIPS_PER_RANK * world)),
                -(-MIN_STRIP_LANES // cfg.width), 1)
    return next((g for g in range(least, rows) if rows % g == 0), rows)


def _lane_route(cfg: RenderConfig, scene, lights, n: int) -> tuple:
    """What a band of `n` lanes decides from its lane count
    (``wavefront.wavefront_sample``, ``_wavefront_masked``): whether the
    compact integrator runs its queue, and on the sorted mesh frame the
    sort chunk and whether the frame may condense.  A whole-frame, a small
    masked or a regen band needs only whole rows."""
    if cfg.integrator == "regen":
        return ()
    if (cfg.integrator == "compact" and cfg.max_depth > 1
            and n >= wavefront.COMPACT_MIN_LANES):
        return ("compact",)
    n += wavefront.sort_padding(n)
    if (wavefront._fused_ok(cfg, scene, lights)
            and wavefront._ray_sort_ok(cfg, scene, n)):
        chunk = ray_sort.chunk_size(n)
        return ("sorted", chunk,
                wavefront._condense_plan(cfg, n, chunk) is not None)
    return ("masked",)


def band_keeps_route(cfg: RenderConfig, scene, lights,
                     world: int) -> Callable[[int], bool]:
    """keeps(rows): whether a band of `rows` rows makes the lane-count
    decisions of the equal band (``_lane_route``), so that balancing moves
    rows between bands and never moves a band to another route."""
    equal = _lane_route(cfg, scene, lights, cfg.num_pixels // world)
    return lambda rows: _lane_route(cfg, scene, lights,
                                    rows * cfg.width) == equal


def balanced_edges(counts: Sequence[int], world: int, granule: int,
                   keeps: Optional[Callable[[int], bool]] = None
                   ) -> Tuple[int, ...]:
    """world + 1 row edges of contiguous bands over the strips of `granule`
    rows whose work is `counts` (strip by strip, top down), cut at strip
    edges where the largest band's work is least (exact over integers,
    by dynamic programming over the prefix sums).  Every band holds at
    least one strip, and `keeps(rows)`, when given, of every band.  Where
    the strips split into equal bands and no cut beats their largest
    band, the equal bands: uniform work gives exactly ``band``'s equal
    split.  Among equal cuts the one whose last band is closest to the
    largest before it, so the spare work is spread."""
    counts = [int(c) for c in counts]
    s = len(counts)
    if world < 1 or s < world:
        raise ValueError(f"{s} strips do not make {world} bands")
    prefix = [0, *itertools.accumulate(counts)]
    ok = [False] + [keeps is None or keeps(k * granule)
                    for k in range(1, s + 1)]
    # most[b][j]: the least largest band of b bands over strips [0, j)
    most = [[None] * (s + 1) for _ in range(world + 1)]
    cut = [[0] * (s + 1) for _ in range(world + 1)]
    most[0][0] = 0
    for b in range(1, world + 1):
        for j in range(b, s - (world - b) + 1):
            best = None
            for i in range(b - 1, j):
                before = most[b - 1][i]
                if before is None or not ok[j - i]:
                    continue
                load = prefix[j] - prefix[i]
                key = (max(before, load), abs(before - load))
                if best is None or key < best:
                    best, cut[b][j] = key, i
            most[b][j] = None if best is None else best[0]
    if s % world == 0:
        per = s // world
        equal = max(prefix[(r + 1) * per] - prefix[r * per]
                    for r in range(world))
        if most[world][s] is None or equal <= most[world][s]:
            return tuple(r * per * granule for r in range(world + 1))
    if most[world][s] is None:
        raise ValueError(f"no {world} bands of {s} strips keep the route")
    edges, j = [s], s
    for b in range(world, 0, -1):
        j = cut[b][j]
        edges.append(j)
    return tuple(e * granule for e in reversed(edges))


def _rank_world(mesh) -> Tuple[int, int]:
    return mesh.get_local_rank(AXIS), mesh.size()


def band_lanes(pixels, rank: int, world: int,
               cfg: Optional[RenderConfig] = None):
    """Rank's band of a whole frame's per-pixel rows (a tensor or array of
    H*W rows): the rows of ``band(cfg, rank, world)`` where `cfg` is
    given, else rows [r * n / world, (r + 1) * n / world)."""
    if cfg is not None:
        row0, rows = band(cfg, rank, world)
        return pixels[row0 * cfg.width:(row0 + rows) * cfg.width]
    n = pixels.shape[0]
    if n % world:
        raise ValueError(f"{n} pixels do not split into {world} bands")
    lanes = n // world
    return pixels[rank * lanes:(rank + 1) * lanes]


def shard_pixels(mesh, state: state_mod.RenderState,
                 cfg: Optional[RenderConfig] = None) -> state_mod.RenderState:
    """This rank's band of a full-frame state (``band_lanes``, the bands of
    `cfg` where it is given): its rows of ``accum``, with ``sample_count``
    and ``frame_index`` replicated."""
    return state._replace(
        accum=band_lanes(state.accum, *_rank_world(mesh), cfg).clone())


def replicate(mesh, tree):
    """Broadcast every tensor of a scene, env, lights or camera tree from the
    mesh's rank 0 in place, so that every replica is rank 0's even where a
    host build could differ between processes.  Returns `tree`."""
    group = mesh.get_group(AXIS)
    src = dist.get_global_rank(group, 0)
    for t in tree_tensors(tree):
        if t.numel() == 0:
            continue
        # as bytes: every dtype (bool, uint32 ...) on either backend
        buf = t.contiguous()
        dist.broadcast(buf.reshape(-1).view(torch.uint8), src=src,
                       group=group)
        if buf.data_ptr() != t.data_ptr():
            t.copy_(buf)
    return tree


def _all_gather(out: torch.Tensor, part: torch.Tensor, group) -> None:
    # all_gather_into_tensor is named all_gather_single from torch 2.13
    fn = (getattr(dist, "all_gather_single", None)
          or dist.all_gather_into_tensor)
    fn(out, part, group=group)


def gather_pixels(mesh, accum: torch.Tensor) -> torch.Tensor:
    """Every rank's `accum`, all of one length, in rank order on every rank
    (one all_gather_into_tensor)."""
    _, world = _rank_world(mesh)
    part = accum.contiguous()
    out = part.new_empty((world * part.shape[0], *part.shape[1:]))
    _all_gather(out, part, mesh.get_group(AXIS))
    return out


def gather_bands(mesh, accum: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """The full (H*W, 3) accumulation on every rank from each rank's band
    of `cfg`: each band padded to the largest, ``gather_pixels``, then the
    bands' rows in order."""
    _, world = _rank_world(mesh)
    lanes = [band(cfg, r, world)[1] * cfg.width for r in range(world)]
    most = max(lanes)
    if accum.shape[0] < most:
        accum = torch.nn.functional.pad(accum,
                                        (0, 0, 0, most - accum.shape[0]))
    full = gather_pixels(mesh, accum)
    if min(lanes) == most:
        return full
    return torch.cat([full[r * most:r * most + n]
                      for r, n in enumerate(lanes)])


def strip_work(cfg: RenderConfig, scene, env, lights, camera,
               frame_index: torch.Tensor, strips: Sequence[int],
               granule: int, n_shadow: int) -> torch.Tensor:
    """(len(strips),) int64 on the device: the rays each strip of `granule`
    rows (strip s is rows [s * granule, (s + 1) * granule)) traced in one
    eager frame of its own at `frame_index` (``frame_chain`` on a state of
    its own): its ``rays_per_bounce`` summed, plus `n_shadow` shadow rays
    for each ray past the primary."""
    device = frame_index.device
    work = torch.zeros(len(strips), dtype=torch.int64, device=device)
    for k, s in enumerate(strips):
        st = state_mod.init_state(granule * cfg.width, device)._replace(
            frame_index=frame_index.clone())
        _, stats = frame_chain(cfg, scene, env, lights, camera, st, 1,
                               s * granule, granule)
        rays = stats.rays_per_bounce
        work[k] = rays.sum() + rays[1:].sum() * n_shadow
    return work


def band_shares(counts: Sequence[int], edges: Sequence[int],
                granule: int) -> Tuple[float, ...]:
    """Each band's share of the strips' work."""
    total = sum(counts)
    return tuple(sum(counts[a // granule:b // granule]) / total
                 for a, b in zip(edges, edges[1:]))


def rescale_costs(costs: Sequence[int], edges: Sequence[int],
                  times: Sequence[int], granule: int) -> list:
    """The strips' costs with each band's scaled to sum to its measured
    time (integers: a strip's cost times the band's time over the band's
    cost, rounded down, at least 1), so a region whose rays cost more
    than the probe counted weighs more at the next cut."""
    out = []
    for a, b, t in zip(edges, edges[1:], times):
        part = costs[a // granule:b // granule]
        total = sum(part)
        out += [max(c * int(t) // total, 1) for c in part]
    return out


def refine_edges(costs: Sequence[int], edges: Tuple[int, ...], world: int,
                 granule: int, keeps: Optional[Callable[[int], bool]],
                 measure: Callable[[Tuple[int, ...]], Sequence[int]]):
    """Refine a cut by the bands' measured times -> (the cut whose slowest
    band measured least, its bands' times).  ``measure(edges)`` gives each
    band's time (integers); each round rescales the strips' costs to the
    times (``rescale_costs``) and cuts again, for at most REFINE_ROUNDS
    cuts, ending early at a cut already measured."""
    measured = {}
    best = edges
    for _ in range(REFINE_ROUNDS):
        times = [int(t) for t in measure(edges)]
        measured[edges] = times
        if max(times) < max(measured[best]):
            best = edges
        costs = rescale_costs(costs, edges, times, granule)
        edges = balanced_edges(costs, world, granule, keeps)
        if edges in measured:
            break
    return best, measured[best]


def band_device_ns(cfg: RenderConfig, scene, env, lights, camera,
                   frame_index: torch.Tensor, row0: int, rows: int) -> int:
    """Device ns a frame of the band takes on the card as the captured step
    runs it: ``StaticStep.frame`` on a state of its own, REFINE_FRAMES
    frames after one, queued behind a spin kernel so the CUDA events
    around them bracket the device's time and not the host's enqueue."""
    device = frame_index.device
    step = StaticStep(cfg, scene, env, lights, device, row0, rows)
    step.load(camera, state_mod.init_state(rows * cfg.width, device)._replace(
        frame_index=frame_index.clone()))
    step.frame()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SPIN_CYCLES)
    start.record()
    for _ in range(REFINE_FRAMES):
        step.frame()
    end.record()
    end.synchronize()
    return int(start.elapsed_time(end) * 1e6) // REFINE_FRAMES


class BandProbe(NamedTuple):
    edges: Tuple[int, ...]          # world + 1 row edges
    work_share: Optional[Tuple[float, ...]]   # each band's share of the rays
    device_ms: Optional[Tuple[float, ...]]    # each band's timed frame


def probe_edges(cfg: RenderConfig, scene, env, lights, camera,
                frame_index: torch.Tensor, mesh, n_shadow: int,
                band_ns: Optional[Callable[[int, int], int]] = None
                ) -> BandProbe:
    """The bands of `cfg` sized by the frame's work.  The image is cut into
    strips of ``strip_rows`` rows; rank r probes strips r, r + world, ...
    (``strip_work``), and one all_gather of the int64 counts gives every
    rank the same vector, from which every rank cuts the same edges
    (``balanced_edges``, each band keeping its route's lane-count
    decisions).  On the card the cut is then refined by the bands' device
    time (``refine_edges``): each rank times its own band
    (``band_ns(row0, rows)``, by default ``band_device_ns``) and one
    all_gather of the times gives every rank the same times, so every rank
    keeps the same cut: a count weighs every ray alike, where a ray's time
    depends on what it hits (on the default 1080p frame the rows of the
    glass cube and the spheres took about twice their share of the rays
    in time, so the counted cut left the slowest of four bands within 4 %
    of the equal cut's).  Where the image makes one strip a rank (or the
    world is one rank) the bands are the equal ones, unprobed."""
    rank, world = _rank_world(mesh)
    granule = strip_rows(cfg, world)
    strips = cfg.height // granule
    if strips == world or world == 1:
        return BandProbe(tuple(r * cfg.height // world
                               for r in range(world + 1)), None, None)
    device = frame_index.device
    group = mesh.get_group(AXIS)
    per = -(-strips // world)
    work = torch.zeros(per, dtype=torch.int64, device=device)
    mine = range(rank, strips, world)
    work[:len(mine)] = strip_work(cfg, scene, env, lights, camera,
                                  frame_index, mine, granule, n_shadow)
    every = torch.empty(per * world, dtype=torch.int64, device=device)
    _all_gather(every, work, group)
    # every[r * per + k] is strip r + k * world
    counts = every.view(world, per).t().reshape(-1)[:strips].tolist()
    keeps = band_keeps_route(cfg, scene, lights, world)
    edges = balanced_edges(counts, world, granule, keeps)
    if band_ns is None and captures(cfg, device):
        band_ns = functools.partial(band_device_ns, cfg, scene, env, lights,
                                    camera, frame_index)
    device_ms = None
    if band_ns is not None:
        def measure(cut):
            row0 = cut[rank]
            mine = torch.tensor([band_ns(row0, cut[rank + 1] - row0)],
                                dtype=torch.int64, device=device)
            times = torch.empty(world, dtype=torch.int64, device=device)
            _all_gather(times, mine, group)
            return times.tolist()

        edges, times = refine_edges(counts, edges, world, granule, keeps,
                                    measure)
        device_ms = tuple(t / 1e6 for t in times)
    return BandProbe(edges, band_shares(counts, edges, granule), device_ms)


def barrier(mesh, device) -> None:
    """Wait until every rank of the mesh arrives (an all_reduce of one
    element, a form both backends take)."""
    dist.all_reduce(torch.zeros(1, device=device),
                    group=mesh.get_group(AXIS))


def shard_frames(cfg: RenderConfig, scene, env, lights, camera,
                 rstate: state_mod.RenderState, k: int, rank: int,
                 world: int):
    """The per-shard body: `k` progressive frames of rank's band folded into
    its band state -> (band state, the band's summed stats).  It holds no
    collective: the counterpart of _sharded_step_k without its psum/pmax."""
    row0, rows = band(cfg, rank, world)
    return frame_chain(cfg, scene, env, lights, camera, rstate, k, row0,
                       rows)


def sharded_frame_step_dyn(cfg: RenderConfig, mesh):
    """step(scene, env, lights, camera, rstate, k) -> (rstate, stats): k
    frames of this rank's band, then one SUM all_reduce of rays_per_bounce
    and one MAX all_reduce of bounces_run over the mesh, so the stats are
    the whole frame's.  On the card it replays the band's captured step k
    times (made at the first call, and again when it is given another
    scene, env or lights); the state it returns is that step's buffers,
    updated in place.  On the CPU it runs shard_frames.  While a
    torch.profiler records, the all_reduces are the span "reduce", with a
    device stamp before and after them."""
    rank, world = _rank_world(mesh)
    row0, rows = band(cfg, rank, world)
    group = mesh.get_group(AXIS)
    captured = {}

    def step(scene, env, lights, camera, rstate, k):
        if captures(cfg, rstate.accum.device):
            key = (id(scene), id(env), id(lights))
            if key not in captured:
                captured.clear()
                # the objects ride along, so their ids stay theirs
                captured[key] = (_captured_step_dyn(
                    cfg, scene, env, lights, rstate.accum.device, row0,
                    rows), (scene, env, lights))
            st, stats = captured[key][0](camera, rstate, k)
        else:
            st, stats = shard_frames(cfg, scene, env, lights, camera, rstate,
                                     k, rank, world)
        device = rstate.accum.device
        timing.stamp("reduce", device)
        with timing.span("reduce"):
            # the chain's stats are its own tensors: reduced in place
            dist.all_reduce(stats.rays_per_bounce, op=dist.ReduceOp.SUM,
                            group=group)
            dist.all_reduce(stats.bounces_run.reshape(1),
                            op=dist.ReduceOp.MAX, group=group)
        timing.stamp("end", device)
        return st, stats

    return step


def sharded_frame_step(cfg: RenderConfig, mesh):
    """step(scene, env, lights, camera, rstate) -> (rstate, stats): one
    frame of sharded_frame_step_dyn."""
    step_k = sharded_frame_step_dyn(cfg, mesh)

    def step(scene, env, lights, camera, rstate):
        return step_k(scene, env, lights, camera, rstate, 1)

    return step
