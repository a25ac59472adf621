"""Rank functions for tests/test_torch_sharding.py.

Each runs on one rank of a gloo world that
``spt_tpu_torch.parallel.launch.spawn`` starts, on the CPU, and returns
numpy arrays to the test.  This module imports no JAX (nor anything of the
JAX package), so the spawned ranks start fast and stay JAX-free.
"""

import os
import types

import numpy as np
import torch
import torch.distributed as dist

from spt_tpu_torch import interop
from spt_tpu_torch.camera import Camera, default_camera
from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.engine import state as state_mod
from spt_tpu_torch.engine.renderer import Renderer
from spt_tpu_torch.env import make_procedural_environment
from spt_tpu_torch.lights import default_lights
from spt_tpu_torch.parallel import (make_mesh, shard_pixels,
                                    sharded_frame_step)
from spt_tpu_torch.parallel.sharding import gather_pixels, replicate
from spt_tpu_torch.scene import SceneDesc, build_default_scene, flatten_scene
from spt_tpu_torch.scene.desc import Material, MeshData

CPU = torch.device("cpu")
CFG = RenderConfig(width=32, height=32, spp=1, max_depth=4)


def accel_scene():
    """tests/test_sharding.py:116-129's random mesh: 400 triangles over 200
    vertices, enough for a cluster accel."""
    rng = np.random.default_rng(11)
    nv = 200
    sc = SceneDesc()
    sc.add_material(Material(base_color=(0.7, 0.5, 0.3)))
    mid = sc.add_mesh(MeshData(
        positions=rng.uniform(-1.5, 1.5, (nv, 3)).astype(np.float32),
        indices=rng.integers(0, nv, (400, 3)).astype(np.uint32)))
    sc.add_instance(mid)
    cam = Camera(position=(0, 0, 5.0), target=(0, 0, 0), fov_degrees=50.0,
                 aspect_ratio=1.0)
    return sc, CFG.replace(max_depth=3), cam


def _renderer(cfg=CFG, **kw):
    return Renderer(build_default_scene(), cfg,
                    camera=default_camera(cfg.width, cfg.height),
                    device=CPU, **kw)


def _step_frames(frames):
    """sharded_frame_step by hand, as tests/test_sharding.py drives it:
    the first frame's whole-frame accum and each frame's global stats."""
    mesh = make_mesh("cpu")
    step = sharded_frame_step(CFG, mesh)
    scene = replicate(mesh, flatten_scene(build_default_scene(), CPU))
    env = replicate(mesh, make_procedural_environment(CPU))
    lights = replicate(mesh, default_lights(CPU))
    cam = replicate(mesh, default_camera(CFG.width, CFG.height).rays(CPU))
    st = shard_pixels(mesh, state_mod.init_state(CFG.num_pixels, CPU))
    rays, first = [], None
    for i in range(frames):
        st, stats = step(scene, env, lights, cam, st)
        rays.append(stats.rays_per_bounce.numpy())
        if i == 0:
            first = gather_pixels(mesh, st.accum).numpy()
    return dict(first=first, rays=np.stack(rays),
                final=gather_pixels(mesh, st.accum).numpy(),
                sample_count=float(st.sample_count),
                frame_index=int(st.frame_index), band_lanes=st.num_pixels)


def every_case(rank, world, out_dir, jax_state):
    """Every gloo-world case of the test file on one rank, in one world:
    the hand-driven step, the Renderer (auto-sharded, chained against
    per-frame, an accel scene, an odd height, the megakernel conflict, a
    checkpoint round trip, a JAX state resumed band by band, resize) and,
    in a world of 2, the CLI.  `jax_state` holds the numpy leaves of a JAX
    RenderState of the whole frame."""
    res = {"step": _step_frames(3)}

    r = _renderer()
    res["mesh_size"] = r.mesh.size() if r.mesh is not None else None
    r.render_frames(3)
    per = _renderer()
    for _ in range(3):
        per.render_frame(check_camera=False)
    res["chain"] = dict(image=r.image(), hdr=r.hdr_image(),
                        rays=r.last_stats.rays_per_bounce.numpy(),
                        bounces=int(r.last_stats.bounces_run),
                        samples=r.accumulated_samples)
    res["per_frame"] = dict(image=per.image(), hdr=per.hdr_image())

    desc, cfg, cam = accel_scene()
    a = Renderer(desc, cfg, camera=cam, device=CPU)
    a.render_frame(check_camera=False)
    res["accel"] = dict(sharded=a.mesh is not None,
                        has_accel=a.scene.accel is not None,
                        hdr=a.hdr_image(),
                        rays=a.last_stats.rays_per_bounce.numpy())

    odd = _renderer(CFG.replace(width=16, height=15))
    odd.render_frame(check_camera=False)
    res["odd"] = dict(sharded=odd.mesh is not None, hdr=odd.hdr_image())

    try:
        _renderer(CFG.replace(integrator="megakernel"), multi_device=True)
        res["megakernel_error"] = None
    except ValueError as e:
        res["megakernel_error"] = str(e)

    path = os.path.join(out_dir, "ck.npz")
    c = _renderer()
    c.render_frames(2)
    c.save_checkpoint(path)
    c2 = _renderer()
    c2.load_checkpoint(path)
    with np.load(path) as ck:
        saved = ck["accum"].copy()
    c.render_frames(1)
    c2.render_frames(1)
    res["checkpoint"] = dict(saved=saved, hdr=c.hdr_image(),
                             resumed=c2.hdr_image(),
                             samples=c2.accumulated_samples)

    j = _renderer()
    j.state = interop.render_state(types.SimpleNamespace(**jax_state), CPU,
                                   rank, world)
    j.render_frames(1)
    res["from_jax"] = dict(hdr=j.hdr_image(), samples=j.accumulated_samples)

    z = _renderer()
    z.render_frame(check_camera=False)
    z.resize(32, 16)
    kept = z.mesh is not None
    z.render_frame(check_camera=False)
    tiled = z.hdr_image()
    z.resize(32, 31)
    z.render_frame(check_camera=False)
    res["resize"] = dict(kept=kept, tiled=tiled, dropped=z.mesh is None,
                         hdr=z.hdr_image(),
                         rays=z.last_stats.rays_per_bounce.numpy())

    if world == 2:
        from spt_tpu_torch import cli

        png = os.path.join(out_dir, "cli.png")
        res["cli_rc"] = cli.main(["--width", "32", "--height", "32", "--spp",
                                  "1", "--depth", "4", "--frames", "2", "-o",
                                  png], device="cpu")
    return res


# tall frame under a camera raised so the scene fills the lowest third and
# the top half is sky: the probe cuts it unevenly
SKY_CFG = RenderConfig(width=64, height=128, spp=1, max_depth=4)
SKY_CAMERA = dict(position=(0.0, 3.0, 8.0), target=(0.0, 4.0, 0.0),
                  fov_degrees=60.0, aspect_ratio=0.5)


def _accum_bits(t):
    return t.contiguous().view(torch.int32).numpy()


def balanced_case(rank, world):
    """The work-balanced bands on one rank: a sharded Renderer of
    SKY_CFG and one unsharded Renderer of it in this process (one thread,
    as the ranks run), two frames each; the band of ``sharding.band`` on
    the Renderer's cfg against the rows of the rank's accumulation;
    interop.render_state with the cfg; and a sorted mesh scene whose bands
    keep their sort chunk."""
    from spt_tpu_torch.parallel import sharding
    from spt_tpu_torch.ops import ray_sort
    from spt_tpu_torch.integrators import wavefront

    res = {}
    cam = Camera(**SKY_CAMERA)
    r = Renderer(build_default_scene(), SKY_CFG, camera=cam, device=CPU)
    one = Renderer(build_default_scene(), SKY_CFG, camera=Camera(**SKY_CAMERA),
                   device=CPU, multi_device=False)
    res["edges"] = r.band_edges
    res["cfg_edges"] = r.cfg.band_edges
    res["share"] = r.band_work_share
    # the probe left the state as a fresh one
    res["fresh"] = (r.last_stats is None and not r.state.accum.any().item()
                    and float(r.state.sample_count) == 0.0
                    and int(r.state.frame_index) == 0)
    # the probe's refinement, its band times from a stand-in clock: the
    # top 64 rows cost three times the others, whatever their rays
    def band_ns(row0, rows):
        return sum(3000 if y < 64 else 1000
                   for y in range(row0, row0 + rows))

    probe = sharding.probe_edges(SKY_CFG, r.scene, r.env, r.lights,
                                 cam.rays(CPU), r.state.frame_index, r.mesh,
                                 1, band_ns=band_ns)
    res["timed"] = dict(edges=probe.edges, device_ms=probe.device_ms,
                        want_ms=tuple(band_ns(a, b - a) / 1e6 for a, b in
                                      zip(probe.edges, probe.edges[1:])))
    r.render_frames(2)
    one.render_frames(2)
    res["image"], res["hdr"] = r.image(), r.hdr_image()
    res["one_image"], res["one_hdr"] = one.image(), one.hdr_image()
    res["rays"] = r.last_stats.rays_per_bounce.numpy()
    res["one_rays"] = one.last_stats.rays_per_bounce.numpy()
    row0, rows = sharding.band(r.cfg, rank, world)
    w = SKY_CFG.width
    res["band"] = (row0, rows)
    res["accum_lanes"] = r.state.num_pixels
    res["accum_is_band"] = bool((_accum_bits(r.state.accum) == _accum_bits(
        one.state.accum[row0 * w:(row0 + rows) * w])).all())
    whole = types.SimpleNamespace(accum=one.state.accum.numpy(),
                                  sample_count=one.state.sample_count.numpy(),
                                  frame_index=one.state.frame_index.numpy())
    carried = interop.render_state(whole, CPU, rank, world, r.cfg)
    res["carried_is_band"] = bool((_accum_bits(carried.accum)
                                   == _accum_bits(r.state.accum)).all())
    # resumed from the carried band: the third frame as the unsharded one's
    r.state = carried
    r.render_frames(1)
    one.render_frames(1)
    res["resumed_hdr"], res["one_resumed_hdr"] = r.hdr_image(), one.hdr_image()

    desc, cfg, _ = accel_scene()
    cfg = cfg.replace(width=128, height=160)
    mcam = dict(position=(0, 0, 5.0), target=(0, 1.6, 0), fov_degrees=50.0,
                aspect_ratio=128 / 160)
    m = Renderer(desc, cfg, camera=Camera(**mcam), device=CPU)
    m1 = Renderer(desc, cfg, camera=Camera(**mcam), device=CPU,
                  multi_device=False)

    def chunk(lanes):
        return ray_sort.chunk_size(lanes + wavefront.sort_padding(lanes))

    mrows = sharding.band(m.cfg, rank, world)[1]
    res["mesh"] = dict(edges=m.band_edges, lanes=m.state.num_pixels,
                       chunk=chunk(mrows * cfg.width),
                       equal_chunk=chunk(cfg.num_pixels // world))
    m.render_frame(check_camera=False)
    m1.render_frame(check_camera=False)
    res["mesh"].update(hdr=m.hdr_image(), one_hdr=m1.hdr_image(),
                       rays=m.last_stats.rays_per_bounce.numpy(),
                       one_rays=m1.last_stats.rays_per_bounce.numpy())
    return res


def fail_on_rank_one(rank, world):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.all_reduce(torch.zeros(1))
