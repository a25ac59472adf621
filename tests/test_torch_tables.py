"""Scenes whose tables pass a block's shared memory render where the JAX
package renders them: the fused kernels (K1, K3) and the standalone
tracers (K4, K7, K8) then read their tables from global memory
(``cuda_bounce.tables_in_global``, ``cuda_trace.tables_in_global``), through
kernels of the same code, and nothing raises.

On the CPU (the kernels' plain versions; the placement decided and handed
over):
- the default scene with 1 200 point lights (``chip_smoke.light_row``):
  both packages' ``explain_decline`` take it and the route stays fused;
  masked (8 x 8) and compact (128 x 128, COMPACT_MIN_LANES) render; the
  masked image within 1 % relative RMSE of the numpy oracle
  ``tests/reference_cpu.py`` on the same pixels (the JAX package unrolls its
  light loop in Python, so a JAX render of this scene takes minutes to
  compile);
- 1 080 lights fit a block's 48 KiB and 1 100 do not: the placement flips
  at the byte count ``shared_bytes`` computes, the route fused in both;
- ``chip_smoke.wide_grid_scene``, 4 096 instances: masked and regen render,
  each within 1 % of the JAX package's image through ``pallas_inst`` in
  interpret mode (the route of
  ``test_torch_inst.py::test_grid_renderer_matches_jax``);
- the standalone tracers' placement from their table bytes (thousands of
  instances, or of spheres beside a mesh), and the kernels' inputs carrying
  the placement, forced either way by the private keyword.

On the card (``cuda`` marker; skipped without one): every global form of
K1, K3, K4, K7 and K8 bit for bit with its plain version and with the
shared form forced onto a scene that fits both, and the captured frames of
the overflowing scenes bit for bit with ``frame_chain``, and every captured
integrator under 1 080 or 1 200 lights at 128 x 128 (compact at depths 3 and
4, regen, the megakernel, the unfused route on ``chip_smoke.sphere_field``)
and compact at 1920 x 1080 depth 6 (compact at depth 3 failed while the
light loop shaded one light at a time, ROADMAP.md section 3, fault 3).
    python -m pytest --noconftest tests/test_torch_tables.py -m cuda
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import chip_smoke  # noqa: E402
import reference_cpu as ref  # noqa: E402
from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import lights as tlights  # noqa: E402
from spt_tpu_torch import materials as tmaterials  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.engine.renderer import Renderer, frame_chain  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.ops import cuda_bounce, cuda_lib, cuda_trace  # noqa: E402
from spt_tpu_torch.ops import intersect as tisect  # noqa: E402
from spt_tpu_torch.ops.vec3 import Vec3  # noqa: E402
from spt_tpu_torch.scene import desc as tdesc  # noqa: E402

CPU = torch.device("cpu")
# The default scene's row of point lights (the many-lights scene of
# chip_smoke.py phase 28 (a)).
ROW = dict(start=(-6.0, 3.0, 1.0), step=(0.01, 0.0, 0.0), intensity=0.01)


def _row(manager, n):
    return chip_smoke.light_row(manager(), n, **ROW)


@pytest.fixture(scope="module")
def J():
    """The JAX package (the card's machine has none: its tests skip)."""
    pytest.importorskip("jax")
    from spt_tpu import camera, config, lights, materials, scene
    from spt_tpu.engine.renderer import Renderer as JRenderer
    from spt_tpu.ops import intersect, pallas_bounce
    from spt_tpu.scene import desc

    return types.SimpleNamespace(camera=camera, config=config, lights=lights,
                                 materials=materials, scene=scene, desc=desc,
                                 Renderer=JRenderer, intersect=intersect,
                                 pb=pallas_bounce)


def _lit(n, w, h, integrator="masked", depth=2, device=CPU):
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=depth,
                               integrator=integrator)
    return Renderer(tscene.build_default_scene(), cfg,
                    lights=_row(tlights.LightManager, n).device(device),
                    camera=tcamera.default_camera(w, h), device=device)


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


# --- the default scene with 1 200 point lights ---------------------------------------

def test_many_lights_take_the_fused_route_in_both_packages(J):
    js = J.scene.flatten_scene(J.scene.build_default_scene())
    assert J.pb.explain_decline(js, _row(J.lights.LightManager, 1200).device(),
                                64, pad_ok=True) is None
    r = _lit(1200, 8, 8)
    assert cuda_bounce.explain_decline(r.cfg, r.scene, r.lights) is None
    assert cuda_bounce.tables_in_global(r.cfg, r.scene, r.lights)
    assert twf._fused_ok(r.cfg, r.scene, r.lights)


def test_many_lights_masked_matches_the_oracle(J):
    # the fused route's plain version on the CPU against the scalar oracle
    # (which follows the JAX transport ray by ray) on the same 64 pixels
    r = _lit(1200, 8, 8)
    r.render_frames(1)
    got = r.hdr_image()
    assert got.shape == (8, 8, 3) and np.isfinite(got).all() and got.any()
    assert int(r.last_stats.rays_per_bounce[0]) == 64
    js = J.scene.flatten_scene(J.scene.build_default_scene())
    cfg = J.config.RenderConfig(width=8, height=8, spp=1, max_depth=2)
    want = ref.render_image(cfg, ref.NpScene(js), ref.lights_from_device(
        _row(J.lights.LightManager, 1200).device()),
        J.camera.default_camera(8, 8), frame=0)
    assert _rel_rmse(got, want) < 0.01


def test_many_lights_compact_renders():
    # 128 x 128 lanes, COMPACT_MIN_LANES: bounce 0 through fused_bounce's
    # plain version, then a chunk of the live queue
    r = _lit(1200, 128, 128, integrator="compact")
    assert 128 * 128 >= twf.COMPACT_MIN_LANES
    r.render_frames(1)
    img = r.hdr_image()
    assert np.isfinite(img).all() and r.state.accum.any()
    rays = r.last_stats.rays_per_bounce
    assert int(rays[0]) == 128 * 128 and 0 < int(rays[1]) < 128 * 128


@pytest.mark.parametrize("n, nbytes, in_global", [(1080, 48812, False),
                                                  (1100, 49692, True)])
def test_placement_flips_at_the_shared_bytes_count(n, nbytes, in_global):
    # depth 6, the default: the histogram of bounces run takes 7 words
    r = _lit(n, 8, 8, depth=6)
    assert cuda_bounce.shared_bytes(r.cfg, r.scene, r.lights) == nbytes
    assert cuda_bounce.tables_in_global(r.cfg, r.scene, r.lights) == in_global
    assert (nbytes > cuda_bounce.MAX_TABLE_BYTES) == in_global
    assert twf._fused_ok(r.cfg, r.scene, r.lights)
    ps = ttr.gen_primary(r.cfg, r.camera.rays(CPU), 1)
    _, args, _ = cuda_bounce._kernel_inputs(r.cfg, r.scene, r.lights, ps,
                                            "fused_frame")
    assert args[-1] == int(in_global)
    # the global placement keeps in shared memory only the histogram
    assert cuda_bounce.shared_bytes(r.cfg, r.scene, r.lights,
                                    in_global=True) == 4 * (r.cfg.max_depth + 1)


def test_kernel_inputs_take_a_forced_placement():
    for n, decided in ((1, 0), (1200, 1)):
        r = _lit(n, 8, 8)
        ps = ttr.gen_primary(r.cfg, r.camera.rays(CPU), 1)
        for forced, want in ((None, decided), (True, 1), (False, 0)):
            _, args, _ = cuda_bounce._kernel_inputs(
                r.cfg, r.scene, r.lights, ps, "fused_bounce", forced)
            assert args[-1] == want


# --- 4 096 instances --------------------------------------------------------------

@pytest.fixture
def jx(J, monkeypatch):
    """The JAX package with pallas_call in interpret mode, its traces routed
    to pallas_inst as on its chip (test_torch_inst.py's jx and
    test_grid_renderer_matches_jax)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(J.pb.pl, "pallas_call", patched)
    monkeypatch.setattr(J.intersect, "_pallas_ok",
                        lambda scene, n: scene.accel is not None
                        and n % 128 == 0)
    return J


def _grid(w, h, depth, device=CPU, **kw):
    desc, cam = chip_smoke.wide_grid_scene(tscene, tmaterials, tdesc)
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=depth,
                               **kw)
    return Renderer(desc, cfg, camera=tcamera.Camera(aspect_ratio=w / h,
                                                     **cam), device=device)


def test_wide_grid_tables_pass_shared_memory():
    r = _grid(16, 8, 2)
    ia = r.scene.inst
    assert ia is not None and ia.num_instances == 64 * 64
    assert cuda_bounce._accel_mode(r.scene) == "instanced"
    assert cuda_bounce.explain_decline(r.cfg, r.scene, r.lights) is None
    assert cuda_bounce.tables_in_global(r.cfg, r.scene, r.lights)
    tables, _, dims = cuda_trace._inst_inputs(ia, r.scene)
    assert cuda_trace.shared_bytes(tables, dims[0]) > cuda_lib.MAX_SHARED_BYTES
    assert cuda_trace.tables_in_global(tables, dims[0])
    # 256 instances fit
    desc, _ = chip_smoke.wide_grid_scene(tscene, tmaterials, tdesc, side=16,
                                         stacks=8, slices=12)
    small = tscene.flatten_scene(desc, CPU)
    assert small.inst is not None and small.inst.num_instances == 256
    tables, _, dims = cuda_trace._inst_inputs(small.inst, small)
    assert not cuda_trace.tables_in_global(tables, dims[0])


def test_wide_grid_matches_jax(jx):
    # masked and regen on the CPU (the fused route's and the standalone
    # tracer's plain versions) against the JAX package's masked frame
    w, h, depth = 32, 24, 2
    jd, cam = chip_smoke.wide_grid_scene(jx.scene, jx.materials, jx.desc)
    pose = dict(cam, aspect_ratio=w / h)
    j = jx.Renderer(jd, jx.config.RenderConfig(width=w, height=h, spp=1,
                                               max_depth=depth),
                    camera=jx.camera.Camera(**pose), multi_device=False)
    assert j.scene.inst is not None
    j.render_frames(1)
    want = j.hdr_image()
    for integrator in ("masked", "regen"):
        t = _grid(w, h, depth, integrator=integrator)
        t.render_frames(1)
        got = t.hdr_image()
        assert got.shape == (h, w, 3) and np.isfinite(got).all()
        assert _rel_rmse(got, want) < 0.01, integrator
        assert int(t.last_stats.rays_per_bounce[0]) == w * h


def test_standalone_tracers_place_their_tables_by_bytes():
    # K4 with 12 000 spheres beside the mesh scene: 240 000 B of spheres
    desc, _ = chip_smoke.mesh_scene(tscene, tmaterials, tdesc, 8, 12)
    scene = tscene.flatten_scene(desc, CPU)
    tables, _, dims = cuda_trace._resident_inputs(scene.accel, scene)
    assert not cuda_trace.tables_in_global(tables, dims[0])
    chip_smoke.add_sphere_ring(desc, (0.0, 0.5, 0.0), 1.3, n=12000, r=0.01)
    scene = tscene.flatten_scene(desc, CPU)
    tables, _, dims = cuda_trace._resident_inputs(scene.accel, scene)
    assert cuda_trace.tables_in_global(tables, dims[0])
    assert cuda_trace.shared_bytes(tables, dims[0], in_global=True) < \
        cuda_lib.MAX_SHARED_BYTES


@pytest.mark.parametrize("name", ["lights", "mesh"])
def test_one_chunk_keeps_the_plain_bits(monkeypatch, name):
    # chip_smoke.one_chunk runs the plain any-hit of a small scene (the
    # default one: unrolled) and of a mesh scene in one chunk: the plain
    # bounce and frame give the same bits with it and without it, and with
    # the any-hit's lanes taken in slices of a few lanes
    if name == "lights":
        r = _lit(40, 16, 8)
    else:
        r = chip_smoke.scene_renderer(CPU, chip_smoke.mesh_scene, 16, 8, 2,
                                      lights=40)
    ps = ttr.gen_primary(r.cfg, r.camera.rays(CPU), 1)
    args = (r.cfg, r.scene, r.lights, ps)

    def run():
        return (_planes(cuda_bounce.fused_frame_reference(*args)) +
                _planes(cuda_bounce.fused_bounce_reference(*args, 0, False)))

    want = run()
    with chip_smoke.one_chunk():
        got = run()
    monkeypatch.setattr(chip_smoke, "ONE_CHUNK_TESTS", 1000)
    with chip_smoke.one_chunk():
        sliced = run()
    assert len(got) == len(want) == len(sliced)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert all(_same(a, b) for a, b in zip(sliced, want))
    assert bool(want[9].any()) and not bool(want[9].all())  # missed: some


# --- the card -------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def one_chunk():
    """The plain tracers' brute force in one chunk a trace
    (``chip_smoke.one_chunk``: the same bits, held on the CPU by
    test_one_chunk_keeps_the_plain_bits), so that a plain frame over
    thousands of lights launches a few kernels a light."""
    with chip_smoke.one_chunk():
        yield


_planes = chip_smoke._flat_planes


def _same(a, b):
    """Bit for bit: float tensors compared as their int32 words."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _card_scene(name, dev, w, h, depth=2):
    """(cfg, scene, lights, camera rays): the overflowing scenes ("lights":
    default + 1 200 point lights; "mesh", "baked": the mesh scene and the
    baked grid + 5 000; "grid": wide_grid_scene) and those that fit both
    placements ("default", "mesh_fit", "inst_fit", "baked_fit")."""
    from spt_tpu_torch.lights import LightManager, default_lights

    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=depth)
    if name in ("lights", "default"):
        lights = (_row(LightManager, 1200).device(dev) if name == "lights"
                  else default_lights(dev))
        scene = tscene.flatten_scene(tscene.build_default_scene(), dev)
        return cfg, scene, lights, tcamera.default_camera(w, h).rays(dev)
    if name == "grid":
        r = _grid(w, h, depth, device=dev)
        return r.cfg, r.scene, r.lights, r.camera.rays(dev)
    build = {"mesh": chip_smoke.mesh_scene, "mesh_fit": chip_smoke.mesh_scene,
             "inst_fit": chip_smoke.inst_grid_scene,
             "baked": chip_smoke.unique_grid_scene,
             "baked_fit": chip_smoke.unique_grid_scene}[name]
    desc, cam = build(tscene, tmaterials, tdesc)
    scene = tscene.flatten_scene(desc, dev)
    lights = default_lights(dev)
    if name in ("mesh", "baked"):
        c = np.asarray(cam["target"], np.float64)
        lights = chip_smoke.light_row(
            LightManager(), 5000, (c[0] - 2.0, c[1] + 2.0, c[2] + 1.0),
            (4.0 / 5000, 0.0, 0.0), 0.002).device(dev)
    camera = tcamera.Camera(aspect_ratio=w / h, **cam)
    return cfg, scene, lights, camera.rays(dev)


OVERFLOW = {"lights": None, "mesh": "resident", "grid": "instanced",
            "baked": "stream"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(OVERFLOW))
def test_global_forms_match_plain_on_card(cuda_device, one_chunk, name):
    w, h = (64, 48) if name in ("lights", "grid") else (16, 8)
    cfg, scene, lights, rays = _card_scene(name, cuda_device, w, h)
    assert cuda_bounce._accel_mode(scene) == OVERFLOW[name]
    assert cuda_bounce.tables_in_global(cfg, scene, lights)
    ps = ttr.gen_primary(cfg, rays, 1)
    before = (cuda_bounce.GLOBAL_LAUNCHES, cuda_bounce.GLOBAL_BOUNCE_LAUNCHES,
              cuda_bounce.LAUNCHES, cuda_bounce.BOUNCE_LAUNCHES)
    k = cuda_bounce.fused_frame(cfg, scene, lights, ps)
    kb = cuda_bounce.fused_bounce(cfg, scene, lights, ps, 0, False)
    assert (cuda_bounce.GLOBAL_LAUNCHES, cuda_bounce.GLOBAL_BOUNCE_LAUNCHES,
            cuda_bounce.LAUNCHES, cuda_bounce.BOUNCE_LAUNCHES) == (
                before[0] + 1, before[1] + 1, before[2], before[3])
    p = cuda_bounce.fused_frame_reference(cfg, scene, lights, ps)
    pb = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps, 0, False)
    torch.cuda.synchronize()
    for got, want in ((k, p), (kb, pb)):
        got, want = _planes(got), _planes(want)
        assert len(got) == len(want)
        assert all(_same(a, b) for a, b in zip(got, want))
    assert int(k[4][0]) == w * h


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "mesh_fit", "inst_fit",
                                  "baked_fit"])
def test_forced_global_matches_shared_on_card(cuda_device, name):
    # a scene that fits both placements: K1 from bounce 0 and three K3
    # bounces through each, every plane bit for bit
    cfg, scene, lights, rays = _card_scene(name, cuda_device, 128, 96,
                                           depth=4)
    assert not cuda_bounce.tables_in_global(cfg, scene, lights)
    ps = ttr.gen_primary(cfg, rays, 2)
    frames = [cuda_bounce.fused_frame(cfg, scene, lights, ps, _in_global=g)
              for g in (False, True)]
    assert all(_same(a, b) for a, b in zip(*map(_planes, frames)))
    states = [ps, ps]
    for b in range(3):
        out = [cuda_bounce.fused_bounce(cfg, scene, lights, s, b, False,
                                        _in_global=g)
               for s, g in zip(states, (False, True))]
        assert all(_same(x, y) for x, y in zip(*map(_planes, out)))
        states = [o[0] for o in out]


def _random_rays(dev, n, center, spread, seed):
    g = np.random.default_rng(seed)
    o = center + g.uniform(-spread, spread, (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def planes(a):
        return Vec3(*(torch.tensor(a[:, k], dtype=torch.float32, device=dev)
                      for k in range(3)))

    return planes(o), planes(d)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["grid", "spheres", "inst_fit", "mesh_fit",
                                  "baked_fit"])
def test_standalone_tracers_global_on_card(cuda_device, name):
    # "grid" (4 096 instances, K7) and "spheres" (the mesh scene with 12 000
    # spheres, K4) take the global placement: against the plain version; the
    # others fit and are held with the global placement forced against the
    # shared one
    dev = cuda_device
    if name == "spheres":
        desc, cam = chip_smoke.mesh_scene(tscene, tmaterials, tdesc)
        chip_smoke.add_sphere_ring(desc, (0.0, 0.5, 0.0), 1.3, n=12000,
                                   r=0.01)
        scene = tscene.flatten_scene(desc, dev)
    else:
        _, scene, _, _ = _card_scene(name, dev, 16, 8)
    if scene.inst is not None:
        fns = (cuda_trace.inst_closest_hit, cuda_trace.inst_any_hit)
        plain = (cuda_trace.inst_closest_hit_reference,
                 cuda_trace.inst_any_hit_reference)
        src, inputs = scene.inst, cuda_trace._inst_inputs
    elif cuda_trace.is_stream(scene.accel):
        fns = (cuda_trace.stream_closest_hit, cuda_trace.stream_any_hit)
        src, plain, inputs = scene.accel, None, None
    else:
        fns = (cuda_trace.closest_hit, cuda_trace.any_hit)
        plain = (cuda_trace.closest_hit_reference,
                 cuda_trace.any_hit_reference)
        src, inputs = scene.accel, cuda_trace._resident_inputs
    lo = scene.tri_v0.min(0).values.cpu().numpy()
    hi = scene.tri_v0.max(0).values.cpu().numpy()
    o, d = _random_rays(dev, 8192, 0.5 * (lo + hi), 0.6 * (hi - lo), 7)
    tmax = torch.full((8192,), 1e30, device=dev)
    overflow = name in ("grid", "spheres")
    if overflow:
        tables, _, dims = inputs(src, scene)
        assert cuda_trace.tables_in_global(tables, dims[0])
        got = [fn(src, scene, o, d, 1e-4, tmax) for fn in fns]
        want = [fn(src, scene, o, d, 1e-4, tmax) for fn in plain]
    else:
        got = [fn(src, scene, o, d, 1e-4, tmax, _in_global=True)
               for fn in fns]
        want = [fn(src, scene, o, d, 1e-4, tmax, _in_global=False)
                for fn in fns]
    torch.cuda.synchronize()
    (gh, gb), (wh, wb) = got, want
    for a, b in zip(gh, wh):
        if a is None:
            assert b is None
        elif isinstance(a, Vec3):
            assert all(_same(x, y) for x, y in zip(a, b))
        else:
            assert _same(a, b)
    assert torch.equal(gb, wb)


def _node_total(part) -> int:
    """The nodes of a ``chip_smoke.body_nodes`` part in all."""
    if isinstance(part, int):
        return part
    if isinstance(part, dict):
        return _node_total(next(iter(part.values())))
    return sum(_node_total(x) for x in part)


def _captured_against_chain(r, dev, frames=(1, 3)):
    """`r`'s captured frames (`frames` a call: 1, then 3) against
    frame_chain's from the same state, bit for bit -> the launch counts of
    the captured ones."""
    args = (r.cfg, r.scene, r.env, r.lights, r.camera.rays(dev))
    wants = []
    st = r.state
    for k in frames:
        st, stats = frame_chain(*args, st, k)
        wants.append((st, stats))
    before = twf.launch_counts()
    for k, (ws, wstats) in zip(frames, wants):
        r.render_frames(k)
        assert all(_same(a, b) for a, b in zip(r.state, ws))
        assert _same(r.last_stats.rays_per_bounce, wstats.rays_per_bounce)
    torch.cuda.synchronize()
    return twf._count_delta(twf.launch_counts(), before)


@pytest.mark.cuda
@pytest.mark.parametrize("name, integrator", [
    ("lights", "masked"), ("lights", "compact"), ("grid", "masked")])
def test_captured_overflow_frames_match_frame_chain_on_card(
        cuda_device, name, integrator):
    # compact at depth 2: one chunk loop (depth 3 and more lights below)
    w, h = (128, 128) if integrator == "compact" else (128, 96)
    if name == "grid":
        r = _grid(w, h, 3, device=cuda_device)
    else:
        r = _lit(1200, w, h, integrator=integrator,
                 depth=2 if integrator == "compact" else 3,
                 device=cuda_device)
    delta = _captured_against_chain(r, cuda_device)
    assert delta[(cuda_bounce, "LAUNCHES")] == 0
    assert delta[(cuda_bounce, "BOUNCE_LAUNCHES")] == 0
    assert cuda_bounce.tables_in_global(r.cfg, r.scene, r.lights)
    if r.captured_step().step.whole:
        # masked on the small scene: K1's whole-frame form, a frame a launch
        # with the tables in global memory
        assert delta[(cuda_bounce, "WHOLE_GLOBAL_LAUNCHES")] == 4
        assert delta[(cuda_bounce, "WHOLE_LAUNCHES")] == 0
        assert delta[(cuda_bounce, "GLOBAL_LAUNCHES")] == 0
    else:
        # masked on the grid runs K1 and K3, compact K3 at bounce 0
        assert delta[(cuda_bounce, "GLOBAL_BOUNCE_LAUNCHES" if integrator ==
                      "compact" else "GLOBAL_LAUNCHES")] > 0
    assert r.captured_step().graph.launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("integrator, n_lights, depth, size", [
    ("compact", 1080, 3, 128), ("compact", 1200, 3, 128),
    ("compact", 1200, 4, 128), ("compact", 1200, 6, 1080),
    ("regen", 1200, 3, 128), ("megakernel", 1200, 3, 128),
    ("spheres-masked", 1200, 3, 128), ("spheres-compact", 1200, 3, 128)])
def test_captured_compact_with_many_lights_matches_frame_chain_on_card(
        cuda_device, integrator, n_lights, depth, size):
    # every captured integrator under ~1 000 point lights at 128x128 (compact
    # past COMPACT_MIN_LANES, two, three and five chunk loops), and compact
    # at 1920x1080 d6 (519 168 lanes a chunk), bit for bit with frame_chain:
    # the light loop shades its lights in groups (transport.light_group),
    # so a chunk body holds ~4 800 nodes at 128x128 (~23 000 on the sphere
    # field, whose shadow test is chunked) and ~55 000 at 1080p,
    # not the ~1.5 million that failed at depth 3 (ROADMAP.md section 3,
    # fault 3), whose second replay faulted; "spheres-*" is
    # chip_smoke.sphere_field, declined by the fused kernels: the unfused
    # route's loop (masked) and chunks (compact).  At 1080p (some 40 s a
    # frame) a call of one frame (the eager warm-up and the capture), then
    # one of two: two replays.
    w, h = (1920, 1080) if size == 1080 else (128, 128)
    if integrator.startswith("spheres-"):
        cfg = tconfig.RenderConfig(width=w, height=h, spp=1,
                                   max_depth=depth,
                                   integrator=integrator.split("-")[1])
        r = Renderer(chip_smoke.sphere_field(tscene), cfg,
                     lights=_row(tlights.LightManager, n_lights).device(
                         cuda_device),
                     camera=tcamera.Camera(aspect_ratio=1.0,
                                           **chip_smoke.SPHERE_POSE),
                     device=cuda_device)
    else:
        r = _lit(n_lights, w, h, integrator=integrator, depth=depth,
                 device=cuda_device)
    delta = _captured_against_chain(
        r, cuda_device, (1, 2) if size == 1080 else (1, 3))
    graph = r.captured_step().graph
    assert graph.launches == (2 if size == 1080 else 3)
    nodes = chip_smoke.body_nodes(graph.items)
    bodies = [x for x in nodes if isinstance(x, dict)]
    if integrator in ("compact", "spheres-compact"):
        assert len(bodies) == depth - 1
        assert max(_node_total(b) for b in bodies) < 60000
        assert delta[("loop", "chunk")] > 0
