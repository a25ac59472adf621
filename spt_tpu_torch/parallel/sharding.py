"""Multi-device scaling: image-space data parallelism over a device mesh.

The counterpart of ``spt_tpu.parallel.sharding``, on ``torch.distributed``
with one process per rank, as ``torchrun`` launches them (NCCL between
cards, gloo between CPU processes):

- one mesh axis "px", a 1-D ``DeviceMesh`` over the process group;
- each rank owns a horizontal band of ``height / world`` rows of the image
  and that band's full path state;
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

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.engine import state as state_mod
from spt_tpu_torch.engine.renderer import (_captured_step_dyn, captures,
                                           frame_chain, tree_tensors)
from spt_tpu_torch.integrators.wavefront import WavefrontStats
from spt_tpu_torch.utils import timing

AXIS = "px"


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
    """(row0, rows) of rank's band of the image."""
    if cfg.height % world:
        raise ValueError(f"image height {cfg.height} must divide the mesh "
                         f"size {world}")
    rows = cfg.height // world
    return rank * rows, rows


def _rank_world(mesh) -> Tuple[int, int]:
    return mesh.get_local_rank(AXIS), mesh.size()


def band_lanes(pixels, rank: int, world: int):
    """Rank's band of a whole frame's per-pixel rows (a tensor or array of
    H*W rows): rank r holds rows [r * n / world, (r + 1) * n / world)."""
    n = pixels.shape[0]
    if n % world:
        raise ValueError(f"{n} pixels do not split into {world} bands")
    lanes = n // world
    return pixels[rank * lanes:(rank + 1) * lanes]


def shard_pixels(mesh, state: state_mod.RenderState) -> state_mod.RenderState:
    """This rank's band of a full-frame state: its rows of ``accum``, with
    ``sample_count`` and ``frame_index`` replicated."""
    return state._replace(
        accum=band_lanes(state.accum, *_rank_world(mesh)).clone())


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


def gather_pixels(mesh, accum: torch.Tensor) -> torch.Tensor:
    """The full (H*W, 3) accumulation on every rank, from each rank's band
    (one list all_gather)."""
    _, world = _rank_world(mesh)
    parts = [torch.empty_like(accum) for _ in range(world)]
    dist.all_gather(parts, accum.contiguous(), group=mesh.get_group(AXIS))
    return torch.cat(parts)


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
