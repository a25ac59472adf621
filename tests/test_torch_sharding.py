"""Pixel-band sharding of spt_tpu_torch against the unsharded render and
against spt_tpu's sharding (the counterpart of tests/test_sharding.py).

A band of rows carries global pixel indices, so its primary rays and RNG
words are the whole frame's rows bit for bit.  Bands rendered on their own
and put together match the unsharded render with tests/test_sharding.py's
gate: rays per bounce exact, images within rtol 1e-3 / atol 5e-4 (on the
CPU PyTorch's vectorized transcendentals may round a lane apart from its
scalar tail, and a band moves which lanes fall in the tail).  Against the
JAX package the gate is the port's: relative RMSE < 1 %, rays per bounce
within rtol 5e-3 (tests/test_torch_renderer.py).

The process-group tests spawn gloo worlds of 2 and 4 CPU ranks through
``spt_tpu_torch.parallel.launch.spawn`` (every case of one world in one
spawn, ``torch_sharding_ranks.every_case``) and hold them to the
single-process port and to JAX's sharded step on 4 of conftest's 8 virtual
devices.  Frames are 32x32 d4, as in tests/test_sharding.py.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch_sharding_ranks as ranks  # noqa: E402
from spt_tpu_torch import cli, interop  # noqa: E402
from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.engine.image import read_png  # noqa: E402
from spt_tpu_torch.engine.renderer import Renderer  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.ops import ray_sort as trs  # noqa: E402
from spt_tpu_torch.parallel import launch, sharding  # noqa: E402

CPU = torch.device("cpu")
CFG = ranks.CFG
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here, not at the top: the card
    test below runs where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    from spt_tpu import camera, config, env, lights, parallel, scene
    from spt_tpu.engine import state
    from spt_tpu.integrators import transport, wavefront
    from spt_tpu.ops import pallas_bounce, ray_sort
    from spt_tpu.parallel import sharding as jsharding
    from spt_tpu.scene import desc

    return types.SimpleNamespace(
        jax=jax, camera=camera, config=config, env=env, lights=lights,
        scene=scene, state=state, tr=transport, wf=wavefront,
        pb=pallas_bounce, rs=ray_sort, parallel=parallel, sharding=jsharding,
        desc=desc)


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


# --- the scenes, built once by the JAX package and carried into the port ----

def _jax_accel_desc(J):
    # tests/test_sharding.py:116-129, the same random mesh as
    # torch_sharding_ranks.accel_scene
    rng = np.random.default_rng(11)
    nv = 200
    sc = J.scene.SceneDesc()
    sc.add_material(J.desc.Material(base_color=(0.7, 0.5, 0.3)))
    mid = sc.add_mesh(J.desc.MeshData(
        positions=rng.uniform(-1.5, 1.5, (nv, 3)).astype(np.float32),
        indices=rng.integers(0, nv, (400, 3)).astype(np.uint32)))
    sc.add_instance(mid)
    return sc


def _inputs(J, name, width=CFG.width, height=CFG.height):
    """(jax cfg, jax args, port cfg, port args) of one frame: the JAX
    scene, env, lights and camera rays, and the port's conversions of them
    (interop), so both trace the same tables."""
    depth = 3 if name.startswith("accel") else CFG.max_depth
    kw = dict(width=width, height=height, spp=1, max_depth=depth)
    jcfg, tcfg = J.config.RenderConfig(**kw), CFG.replace(**kw)
    if name.startswith("accel"):
        desc = _jax_accel_desc(J)
        cam = J.camera.Camera(position=(0, 0, 5.0), target=(0, 0, 0),
                              fov_degrees=50.0, aspect_ratio=width / height)
    else:
        desc = J.scene.build_default_scene()
        cam = J.camera.default_camera(width, height)
    jargs = (J.scene.flatten_scene(desc), J.env.make_procedural_environment(),
             J.lights.default_lights(), cam.rays())
    targs = (interop.scene(jargs[0], CPU), interop.environment(jargs[1], CPU),
             interop.lights(jargs[2], CPU), interop.camera_rays(jargs[3], CPU))
    return jcfg, jargs, tcfg, targs


# --- bands in one process -----------------------------------------------------

@pytest.mark.parametrize("row0,rows", [(0, 8), (8, 8), (12, 20), (31, 1)])
def test_gen_primary_band_is_the_frames_rows(row0, rows):
    cfg = CFG.replace(spp=2)
    rays = tcamera.default_camera(32, 32).rays(CPU)
    lanes = slice(row0 * 32, (row0 + rows) * 32)
    for jitter in (True, False):
        c = cfg.replace(jitter=jitter)
        full = ttr.gen_primary(c, rays, 7, 1)
        part = ttr.gen_primary(c, rays, 7, 1, row0, rows)
        assert part.num_paths == 32 * rows
        for f in ("origin", "direction", "throughput", "radiance"):
            for a, b in zip(getattr(part, f), getattr(full, f)):
                assert torch.equal(_bits(a), _bits(b[lanes])), f
        for f in ("rng", "alive", "emission_ok"):
            assert torch.equal(getattr(part, f), getattr(full, f)[lanes]), f


def test_gen_primary_band_matches_jax(J):
    jcfg = J.config.RenderConfig(width=32, height=32, spp=2)
    cam = J.camera.default_camera(32, 32).rays()
    want = J.tr.gen_primary(jcfg, cam, 5, 1, 12, 8)
    got = ttr.gen_primary(CFG.replace(spp=2), interop.camera_rays(cam, CPU),
                          5, 1, 12, 8)
    np.testing.assert_array_equal(
        got.rng.numpy(), np.asarray(want.rng, np.uint32).astype(np.int64))
    for a, b in zip(got.direction, want.direction):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("n", [518400, 1036800, 49152, 98304, 4096, 256])
def test_band_lane_counts_decide_as_jax(J, n):
    # the band's lane count (1080p over 4 and 2, the mesh config over 4 and
    # 2, the CPU tests' bands) makes the JAX package's decisions:
    # padding, sort chunk, condense plan and compact queue width
    cfg = CFG
    tileable = n % 128 == 0 and J.pb._tile_rows(n // 128) > 0
    pad = twf.sort_padding(n)
    assert pad == (0 if tileable else -n % (64 * 128))
    chunk = trs.chunk_size(n + pad)
    assert chunk == J.rs.chunk_size(n + pad)
    if chunk:
        assert twf._condense_plan(cfg, n + pad, chunk) == J.wf._condense_plan(
            J.config.RenderConfig(), n + pad, chunk)
    assert twf._queue_width(n) == J.wf._queue_width(n)


def _band_render(tcfg, targs, world):
    parts, rays = [], 0
    for rank in range(world):
        row0, rows = sharding.band(tcfg, rank, world)
        img, stats = twf.render_wavefront(tcfg, *targs, 3, row0=row0,
                                          rows=rows)
        assert img.shape == (rows, tcfg.width, 3)
        parts.append(img)
        rays = rays + stats.rays_per_bounce
    return torch.cat(parts), rays


@pytest.mark.parametrize("scene,integrator", [
    ("default", "masked"), ("default", "compact"), ("default", "regen"),
    ("accel", "masked"), ("accel", "compact"), ("accel", "regen"),
    ("accel_sorted", "masked")])
def test_bands_put_together_are_the_unsharded_render(J, scene, integrator,
                                                     monkeypatch):
    # 4 bands of 8 rows (accel_sorted: 2 bands of a 128x64 frame, whose
    # 4096-lane bands go through the sorted frame in chunks of 2048 and the
    # whole frame in chunks of 4096); compact runs its queue loop at these
    # sizes too
    monkeypatch.setattr(twf, "COMPACT_MIN_LANES", 0)
    if scene == "accel_sorted":
        _, _, tcfg, targs = _inputs(J, scene, 128, 64)
        world = 2
        assert trs.chunk_size(4096) == 2048 and trs.chunk_size(8192) == 4096
    else:
        _, _, tcfg, targs = _inputs(J, scene)
        world = 4
    tcfg = tcfg.replace(integrator=integrator)
    want, want_stats = twf.render_wavefront(tcfg, *targs, 3)
    got, rays = _band_render(tcfg, targs, world)
    np.testing.assert_array_equal(rays.numpy(),
                                  want_stats.rays_per_bounce.numpy())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=5e-4)


@pytest.mark.parametrize("scene", ["default", "accel"])
def test_middle_band_matches_jax(J, scene):
    jcfg, jargs, tcfg, targs = _inputs(J, scene)
    want, jstats = J.wf.render_wavefront(jcfg, *jargs, 2, row0=8, rows=8)
    got, tstats = twf.render_wavefront(tcfg, *targs, 2, row0=8, rows=8)
    assert got.shape == (8, 32, 3)
    assert _rel_rmse(got.numpy(), np.asarray(want)) < 0.01
    np.testing.assert_allclose(tstats.rays_per_bounce.numpy(),
                               np.asarray(jstats.rays_per_bounce), rtol=5e-3)


# --- without a process group ----------------------------------------------------

def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torchrun.*init_process_group"):
        sharding.make_mesh("cpu")


def test_render_state_carries_a_rank_band(J):
    st = J.state.init_state(CFG.num_pixels)
    st = st._replace(accum=st.accum + np.arange(CFG.num_pixels * 3,
                                                dtype=np.float32).reshape(-1, 3))
    whole = interop.render_state(st, CPU)
    for rank in range(4):
        part = interop.render_state(st, CPU, rank, 4)
        assert torch.equal(part.accum, whole.accum[rank * 256:(rank + 1) * 256])
        assert float(part.sample_count) == 0.0 and int(part.frame_index) == 0


def test_package_root_exports_lazily():
    # every name of spt_tpu/__init__.py's list resolves to the port's own
    # object; importing the package loads no kernel library
    code = (
        "import sys, spt_tpu_torch as s\n"
        "assert not [m for m in sys.modules if m.startswith("
        "('spt_tpu_torch.ops.cuda', 'spt_tpu_torch.engine', 'jax', "
        "'spt_tpu.'))]\n"
        "import spt_tpu as j\n"
        "names = [n for n in j.__all__ if n not in ('GPU_PARITY',)]\n"
        "assert set(names) <= set(s.__all__), set(names) - set(s.__all__)\n"
        "for n in names:\n"
        "    assert getattr(s, n).__module__.startswith('spt_tpu_torch.'), n\n"
        "from spt_tpu_torch.ops import cuda_lib\n"
        "assert cuda_lib._LIB is None\n"
        "print('ok', len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "15"]


# --- gloo worlds ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded(J):
    """JAX's sharded step over 4 of the 8 virtual devices, three frames:
    the first frame's image and rays, the state after two and after
    three."""
    assert J.jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    jcfg = J.config.RenderConfig(width=32, height=32, spp=1, max_depth=4)
    mesh = J.parallel.make_mesh(J.jax.devices()[:4])
    step = J.parallel.sharded_frame_step(jcfg, mesh)
    args = tuple(J.sharding.replicate(mesh, a) for a in (
        J.scene.flatten_scene(J.scene.build_default_scene()),
        J.env.make_procedural_environment(), J.lights.default_lights(),
        J.camera.default_camera(32, 32).rays()))
    st = J.parallel.shard_pixels(mesh, J.state.init_state(jcfg.num_pixels))
    out = {}
    for i in range(3):
        st, stats = step(*args, st)
        if i == 0:
            out["first"] = np.asarray(st.accum)
            out["rays"] = np.asarray(stats.rays_per_bounce)
        if i == 1:
            out["after_two"] = {f: np.asarray(getattr(st, f))
                                for f in st._fields}
    out["after_three"] = np.asarray(st.accum)
    return out


@pytest.fixture(scope="module")
def world(request, jax_sharded, tmp_path_factory):
    """Every case of torch_sharding_ranks.every_case on a gloo world of
    `request.param` ranks, spawned once per world size -> (rank 0's
    results, the directory the world wrote in, every rank's results)."""
    out_dir = str(tmp_path_factory.mktemp(f"world{request.param}"))
    res = launch.spawn(ranks.every_case, request.param,
                       (out_dir, jax_sharded["after_two"]), timeout=180)
    return res[0].value, out_dir, [r.value for r in res]


def _single(cfg=CFG, frames=1):
    """The single-process port Renderer after `frames` frames."""
    r = Renderer(tscene.build_default_scene(), cfg,
                 camera=tcamera.default_camera(cfg.width, cfg.height),
                 device=CPU, multi_device=False)
    r.render_frames(frames)
    return r


WORLDS = pytest.mark.parametrize("world", [2, 4], indirect=True)


@WORLDS
def test_step_matches_single_process(world):
    res, _, _ = world
    want = _single()
    np.testing.assert_array_equal(res["step"]["rays"][0],
                                  want.last_stats.rays_per_bounce.numpy())
    np.testing.assert_allclose(res["step"]["first"], want.state.accum.numpy(),
                               rtol=1e-3, atol=5e-4)


@WORLDS
def test_step_counts_every_pixel_each_frame(world):
    res, _, everyone = world
    step = res["step"]
    assert (step["rays"][:, 0] == CFG.num_pixels).all()
    assert step["sample_count"] == 3.0 and step["frame_index"] == 3
    # every rank holds its band and reports the global stats
    assert step["band_lanes"] * len(everyone) == CFG.num_pixels
    for other in everyone[1:]:
        np.testing.assert_array_equal(other["step"]["rays"], step["rays"])
        np.testing.assert_array_equal(other["step"]["final"], step["final"])


@WORLDS
def test_step_progressive(world):
    res, _, _ = world
    img = res["step"]["final"]
    assert np.isfinite(img).all() and img.max() > 0
    np.testing.assert_allclose(img, _single(frames=3).state.accum.numpy(),
                               rtol=1e-3, atol=5e-4)


@WORLDS
def test_renderer_shards_automatically(world):
    res, _, everyone = world
    assert res["mesh_size"] == len(everyone)
    chain = res["chain"]
    assert chain["samples"] == 3.0
    one = _single(frames=3)
    np.testing.assert_allclose(chain["image"], one.image(), rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_array_equal(chain["rays"],
                                  one.last_stats.rays_per_bounce.numpy())
    assert chain["bounces"] == int(one.last_stats.bounces_run)


@WORLDS
def test_render_frames_equals_per_frame_rendering(world):
    res, _, _ = world
    np.testing.assert_array_equal(res["chain"]["hdr"], res["per_frame"]["hdr"])
    np.testing.assert_array_equal(res["chain"]["image"],
                                  res["per_frame"]["image"])
    assert res["chain"]["rays"][0] == 3 * CFG.num_pixels


@WORLDS
def test_accel_scene_sharded(world):
    res, _, _ = world
    acc = res["accel"]
    assert acc["sharded"] and acc["has_accel"]
    desc, cfg, cam = ranks.accel_scene()
    one = Renderer(desc, cfg, camera=cam, device=CPU, multi_device=False)
    one.render_frame(check_camera=False)
    np.testing.assert_array_equal(acc["rays"],
                                  one.last_stats.rays_per_bounce.numpy())
    np.testing.assert_allclose(acc["hdr"], one.hdr_image(), rtol=1e-3,
                               atol=2e-3)


@WORLDS
def test_odd_height_stays_unsharded(world):
    res, _, _ = world
    assert not res["odd"]["sharded"]
    np.testing.assert_array_equal(
        res["odd"]["hdr"], _single(CFG.replace(width=16, height=15)).hdr_image())


@WORLDS
def test_megakernel_on_a_mesh_raises(world):
    res, _, _ = world
    assert "megakernel" in res["megakernel_error"]
    assert "single-device" in res["megakernel_error"]


@WORLDS
def test_checkpoint_round_trip(world):
    res, out_dir, _ = world
    ck = res["checkpoint"]
    # rank 0 wrote the whole frame; a second sharded renderer resumed it
    np.testing.assert_allclose(ck["saved"], _single(frames=2).state.accum
                               .numpy(), rtol=1e-3, atol=5e-4)
    np.testing.assert_array_equal(ck["resumed"], ck["hdr"])
    assert ck["samples"] == 3.0
    assert os.path.exists(os.path.join(out_dir, "ck.npz"))


@WORLDS
def test_jax_state_resumes_on_the_mesh(world, jax_sharded):
    # JAX's state after two sharded frames, carried band by band into the
    # port's sharded renderer (interop.render_state(rank, world)), which
    # renders the third frame
    res, _, _ = world
    want = jax_sharded["after_three"].reshape(32, 32, 3) / 3.0
    assert res["from_jax"]["samples"] == 3.0
    assert _rel_rmse(res["from_jax"]["hdr"], want) < 0.01


@WORLDS
def test_resize_keeps_or_drops_the_mesh(world):
    res, _, _ = world
    z = res["resize"]
    assert z["kept"] and z["dropped"]
    one = _single()
    one.resize(32, 16)
    one.render_frame(check_camera=False)
    np.testing.assert_allclose(z["tiled"], one.hdr_image(), rtol=1e-3,
                               atol=5e-4)
    one.resize(32, 31)
    one.render_frame(check_camera=False)
    assert z["hdr"].shape == (31, 32, 3)
    np.testing.assert_array_equal(z["hdr"], one.hdr_image())
    np.testing.assert_array_equal(z["rays"],
                                  one.last_stats.rays_per_bounce.numpy())


@pytest.mark.parametrize("world", [4], indirect=True)
def test_matches_jax_sharded_step_on_4_devices(world, jax_sharded):
    res, _, _ = world
    np.testing.assert_allclose(res["step"]["rays"][0], jax_sharded["rays"],
                               rtol=5e-3)
    assert _rel_rmse(res["step"]["first"], jax_sharded["first"]) < 0.01


@pytest.mark.parametrize("world", [2], indirect=True)
def test_cli_in_a_world_of_two_writes_one_png(world, tmp_path):
    res, out_dir, everyone = world
    assert [r["cli_rc"] for r in everyone] == [0, 0]
    pngs = [f for f in os.listdir(out_dir) if f.endswith(".png")]
    assert pngs == ["cli.png"]
    single = str(tmp_path / "single.png")
    assert cli.main(["--width", "32", "--height", "32", "--spp", "1",
                     "--depth", "4", "--frames", "2", "-o", single],
                    device="cpu") == 0
    np.testing.assert_allclose(read_png(os.path.join(out_dir, "cli.png")),
                               read_png(single), atol=1 / 255 + 1e-6)


# --- bands sized by the frame's work ---------------------------------------

@pytest.mark.parametrize("counts,world,granule,keeps,want", [
    # uniform work: exactly the equal bands
    ([7] * 12, 4, 9, None, (0, 27, 54, 81, 108)),
    ([7] * 8, 2, 16, None, (0, 64, 128)),
    # sky on top: the top band takes more rows
    ([1, 1, 1, 1, 10, 10, 10, 10], 2, 8, None, (0, 48, 64)),
    ([1] * 6 + [5, 9, 9, 5], 2, 4, None, (0, 32, 40)),
    # a route that takes bands of an even number of strips alone
    ([1, 1, 1, 1, 10, 10, 10, 10], 2, 8, lambda rows: rows % 16 == 0,
     (0, 48, 64)),
    ([1, 1, 1, 10, 10, 10], 2, 8, lambda rows: rows % 16 == 0,
     (0, 32, 48)),
    # no cut beats the equal bands: they stay
    ([9, 1, 1, 9], 2, 5, None, (0, 10, 20)),
    # one band a strip
    ([3, 1, 4, 1], 4, 2, None, (0, 2, 4, 6, 8)),
    # a world of one
    ([3, 1, 4, 1, 5], 1, 6, None, (0, 30)),
], ids=["uniform4", "uniform2", "top_heavy", "middle", "even_strips",
        "even_strips_odd", "equal_best", "a_strip_each", "world1"])
def test_balanced_edges(counts, world, granule, keeps, want):
    got = sharding.balanced_edges(counts, world, granule, keeps)
    assert got == want
    # the edges cover [0, height] on strip edges, each band a strip or more
    assert len(got) == world + 1
    assert got[0] == 0 and got[-1] == len(counts) * granule
    assert all(e % granule == 0 for e in got)
    assert all(b - a >= granule for a, b in zip(got, got[1:]))
    if keeps is not None:
        assert all(keeps(b - a) for a, b in zip(got, got[1:]))

    def largest(edges):
        return max(sum(counts[a // granule:b // granule])
                   for a, b in zip(edges, edges[1:]))

    if len(counts) % world == 0:
        per = len(counts) // world * granule
        assert largest(got) <= largest(tuple(range(0, per * world + 1, per)))


def test_rescale_costs_gives_each_band_its_time():
    got = sharding.rescale_costs([1, 1, 2, 2, 3], (0, 4, 10), [10, 70], 2)
    assert got == [5, 5, 20, 20, 30]
    # a band's costs never fall to zero
    assert sharding.rescale_costs([1, 1000], (0, 1, 2), [1, 5], 1) == [1, 5]


def test_refine_edges_follows_the_measured_time():
    # rays cost three times as much in strips 8-11 as the count says; each
    # band also pays a fixed 50 a frame
    counts = [10] * 8 + [40] * 4 + [20] * 4
    true = [c * (3 if 8 <= i < 12 else 1) for i, c in enumerate(counts)]
    calls = []

    def measure(edges):
        calls.append(edges)
        return [50 + sum(true[a:b]) for a, b in zip(edges, edges[1:])]

    counted = sharding.balanced_edges(counts, 4, 1)
    best, times = sharding.refine_edges(counts, counted, 4, 1, None, measure)
    assert calls[0] == counted and len(calls) <= sharding.REFINE_ROUNDS
    assert times == measure(best)
    assert max(times) < max(measure(counted))
    # what no cut of the true costs beats, give or take a strip
    ideal = sharding.balanced_edges(true, 4, 1)
    assert max(times) <= max(measure(ideal)) + 120


def test_refine_edges_keeps_a_cut_that_measures_even():
    counts = [5] * 8
    calls = []

    def measure(edges):
        calls.append(edges)
        return [100] * 4

    best, times = sharding.refine_edges(counts, (0, 2, 4, 6, 8), 4, 1, None,
                                        measure)
    assert best == (0, 2, 4, 6, 8) and times == [100] * 4
    assert calls == [(0, 2, 4, 6, 8)]


@pytest.mark.parametrize("width,height,world,want", [
    (1920, 1080, 4, 9), (1920, 1080, 2, 18), (512, 384, 4, 4),
    (64, 128, 2, 32), (32, 32, 2, 16), (32, 16, 2, 8)])
def test_strip_rows_divide_the_equal_band(width, height, world, want):
    cfg = CFG.replace(width=width, height=height)
    g = sharding.strip_rows(cfg, world)
    assert g == want and (height // world) % g == 0


def test_band_follows_the_edges():
    cfg = CFG.replace(band_edges=(0, 20, 26, 32))
    assert [sharding.band(cfg, r, 3) for r in range(3)] == [
        (0, 20), (20, 6), (26, 6)]
    lanes = torch.arange(CFG.num_pixels)
    assert torch.equal(sharding.band_lanes(lanes, 1, 3, cfg),
                       lanes[20 * 32:26 * 32])
    for bad in ((0, 20, 32), (0, 20, 20, 32), (0, 20, 26, 31)):
        with pytest.raises(ValueError, match="band edges"):
            sharding.band(CFG.replace(band_edges=bad), 0, 3)


@pytest.fixture(scope="module")
def balanced():
    """torch_sharding_ranks.balanced_case on a gloo world of 2 -> every
    rank's results."""
    return [r.value for r in launch.spawn(ranks.balanced_case, 2,
                                          timeout=240)]


def test_balanced_bands_are_uneven_and_agree(balanced):
    edges = balanced[0]["edges"]
    assert edges != (0, 64, 128) and edges[0] == 0 and edges[-1] == 128
    g = sharding.strip_rows(ranks.SKY_CFG, 2)
    assert all(e % g == 0 for e in edges)
    # the sky band holds more rows
    assert edges[1] > 64
    for res in balanced:
        assert res["edges"] == edges and res["cfg_edges"] == edges
        assert res["share"] == balanced[0]["share"]
        assert res["fresh"]
    share = balanced[0]["share"]
    assert abs(sum(share) - 1.0) < 1e-12 and max(share) < 0.6


def test_balanced_bands_render_the_unsharded_frame(balanced):
    for res in balanced:
        for key in ("image", "hdr", "resumed_hdr"):
            assert res[key].shape == res["one_" + key].shape
            np.testing.assert_array_equal(res[key], res["one_" + key])
        np.testing.assert_array_equal(res["rays"], res["one_rays"])


def test_probe_refines_by_the_gathered_band_times(balanced):
    # every rank keeps the same refined cut, timed by the stand-in clock
    timed = balanced[0]["timed"]
    assert timed["device_ms"] == timed["want_ms"]
    assert timed["edges"] != balanced[0]["edges"]
    for res in balanced:
        assert res["timed"] == timed
    # the stand-in's costly top rows go to a band of their own
    assert timed["edges"] == (0, 32, 128)
    assert timed["device_ms"] == (0.096, 0.16)


def test_band_names_each_ranks_accumulation(balanced):
    edges = balanced[0]["edges"]
    for rank, res in enumerate(balanced):
        row0, rows = res["band"]
        assert (row0, row0 + rows) == edges[rank:rank + 2]
        assert res["accum_lanes"] == rows * ranks.SKY_CFG.width
        assert res["accum_is_band"]


def test_render_state_honours_the_edges(balanced):
    assert all(res["carried_is_band"] for res in balanced)


def test_sorted_mesh_bands_keep_their_chunk(balanced):
    mesh = [res["mesh"] for res in balanced]
    assert mesh[0]["edges"] != (0, 80, 160)
    for rank, m in enumerate(mesh):
        assert m["edges"] == mesh[0]["edges"]
        assert m["chunk"] == m["equal_chunk"] == 2048
        a, b = m["edges"][rank:rank + 2]
        assert m["lanes"] == (b - a) * 128
        np.testing.assert_array_equal(m["rays"], m["one_rays"])
        np.testing.assert_allclose(m["hdr"], m["one_hdr"], rtol=1e-3,
                                   atol=5e-4)


def test_a_failing_rank_fails_the_world():
    # rank 1 raises while rank 0 waits for it in a collective: the launcher
    # reports rank 1's error and stops rank 0 instead of hanging
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*"
                       "rank 1 gives up"):
        launch.spawn(ranks.fail_on_rank_one, 2, timeout=60)


# --- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bands run the fused_frame "
                    "kernel, which has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [2, 4])
def test_bands_on_card_are_the_frame_bit_for_bit(cuda_device, bands):
    # every band of a small frame through K1 small on the card, put together
    # and held to the unsharded frame bit for bit, rays exact
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.env import make_procedural_environment
    from spt_tpu_torch.lights import default_lights
    from spt_tpu_torch.scene import build_default_scene, flatten_scene

    cfg = CFG.replace(width=256, height=192, max_depth=6)
    args = (flatten_scene(build_default_scene(), cuda_device),
            make_procedural_environment(cuda_device),
            default_lights(cuda_device),
            tcamera.default_camera(256, 192).rays(cuda_device))
    full, fstats = sharding.shard_frames(
        cfg, *args, state_mod.init_state(cfg.num_pixels, cuda_device), 2,
        0, 1)
    parts, rays = [], 0
    for rank in range(bands):
        st, stats = sharding.shard_frames(
            cfg, *args, state_mod.init_state(cfg.num_pixels // bands,
                                             cuda_device), 2, rank, bands)
        parts.append(st.accum)
        rays = rays + stats.rays_per_bounce
    assert torch.equal(torch.cat(parts).view(torch.int32),
                       full.accum.view(torch.int32))
    assert torch.equal(rays, fstats.rays_per_bounce)


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [2, 4])
def test_balanced_bands_on_card_are_the_frame_bit_for_bit(cuda_device,
                                                          bands):
    # the bands the sharded Renderer's probe cuts (the probe run whole in
    # this process) through K1 small on the card, put together and held to
    # the unsharded frame bit for bit, rays exact; the camera raised so
    # the top two thirds are sky
    from spt_tpu_torch.engine import state as state_mod
    from spt_tpu_torch.env import make_procedural_environment
    from spt_tpu_torch.lights import default_lights
    from spt_tpu_torch.scene import build_default_scene, flatten_scene

    cfg = CFG.replace(width=256, height=192, max_depth=6)
    cam = tcamera.Camera(**{**ranks.SKY_CAMERA, "aspect_ratio": 256 / 192})
    args = (flatten_scene(build_default_scene(), cuda_device),
            make_procedural_environment(cuda_device),
            default_lights(cuda_device), cam.rays(cuda_device))
    g = sharding.strip_rows(cfg, bands)
    counts = sharding.strip_work(
        cfg, *args, torch.zeros((), dtype=torch.int32, device=cuda_device),
        range(cfg.height // g), g, 1).tolist()
    edges = sharding.balanced_edges(counts, bands, g)
    assert edges != tuple(range(0, 193, 192 // bands))
    bcfg = cfg.replace(band_edges=edges)
    full, fstats = sharding.shard_frames(
        cfg, *args, state_mod.init_state(cfg.num_pixels, cuda_device), 2,
        0, 1)
    parts, rays = [], 0
    for rank in range(bands):
        rows = sharding.band(bcfg, rank, bands)[1]
        st, stats = sharding.shard_frames(
            bcfg, *args, state_mod.init_state(rows * cfg.width, cuda_device),
            2, rank, bands)
        parts.append(st.accum)
        rays = rays + stats.rays_per_bounce
    assert torch.equal(torch.cat(parts).view(torch.int32),
                       full.accum.view(torch.int32))
    assert torch.equal(rays, fstats.rays_per_bounce)
