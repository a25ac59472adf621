"""The unfused route: scenes the fused kernels decline render as the JAX
package renders them (integrators/wavefront ``_fused_ok`` and
``transport.bounce_loop``; ops/intersect's chunked route without an accel).

On the CPU:
- against the JAX package's Renderer (< 1 % relative RMSE on
  ``hdr_image``, the same scene built from a numpy seed in both packages):
  200 spheres with no accel and a 256-triangle sphere mesh with 33 spheres
  beside it, masked; compact (at 16 384 lanes, past COMPACT_MIN_LANES) and
  regen on the 200 spheres;
- the route decisions: the port declines each of the JAX package's four
  classes (more than 192 primitives without an accel, more than 32
  spheres beside one, more than 64 materials, more than 32 NEE emitters),
  where the JAX package's ``pallas_bounce.explain_decline`` does, and keeps
  the fused route on default, cornell, hdr and chip_smoke's mesh scene;
  a declined scene logs each reason once; a kernel that fails on a
  supported scene raises and switches no route; the kernels' inputs
  refuse a declined scene (a scene the kernels take whose tables do not
  fit a block's shared memory stays on the fused route, its tables read
  from global memory: ``tests/test_torch_tables.py``);
- the unfused masked route against the fused one (through
  ``fused_frame_reference``), bit for bit in radiance, rays per bounce
  and bounces run, on each declined class and on default;
- ``render_debug`` on the 200 spheres against the JAX package's (as
  ``test_torch_cli.py::test_render_debug_matches_jax`` holds it).

On the card (``cuda`` marker; skipped without one): each declined scene's
captured frames against ``frame_chain``, bit for bit, one graph launch a
frame, every launch count equal and no fused kernel launched.
"""

import logging
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import lights as tlights  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.engine.renderer import Renderer, frame_chain  # noqa: E402
from spt_tpu_torch.integrators import debug as tdebug  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.ops import cuda_bounce, cuda_sort  # noqa: E402

CPU = torch.device("cpu")
W, H = 32, 24
DEBUG_MODES = ("geomtype", "hitmiss", "normal", "depth", "matid")


@pytest.fixture(scope="module")
def J():
    """The JAX package (the card's machine has none: its tests skip)."""
    pytest.importorskip("jax")
    from spt_tpu import camera, config, lights, materials, scene
    from spt_tpu.engine.renderer import Renderer
    from spt_tpu.integrators import debug
    from spt_tpu.ops import pallas_bounce

    return types.SimpleNamespace(camera=camera, config=config, lights=lights,
                                 materials=materials, scene=scene,
                                 Renderer=Renderer, debug=debug,
                                 pb=pallas_bounce)
POSE = chip_smoke.SPHERE_POSE


_mats = chip_smoke.sphere_materials


# 200 spheres and no triangles (no accel)
_spheres = chip_smoke.sphere_field


def _mesh_spheres(mod, seed=4, n=33):
    """A 256-triangle UV sphere mesh (a cluster accel in both packages)
    with `n` analytic spheres beside it."""
    rng = np.random.default_rng(seed)
    d = mod.SceneDesc()
    _mats(mod, d)
    mesh = d.add_mesh(mod.create_sphere_mesh(stacks=8, slices=16, radius=0.8))
    d.add_instance(mesh, mod.desc.translate(np.eye(4, dtype=np.float32),
                                            [0.0, 0.8, 0.0]), material_id=0)
    for _ in range(n):
        d.add_sphere(rng.uniform([-2.5, 0.1, -2.0], [2.5, 1.6, 1.0]),
                     float(rng.uniform(0.1, 0.2)), int(rng.integers(3)))
    return d


def _materials(mod):
    """65 spheres of a material each: past the 64 the kernels hold."""
    d = mod.SceneDesc()
    for i in range(65):
        d.add_material(mod.Material([0.3 + 0.01 * i, 0.5, 0.7 - 0.01 * i],
                                    roughness=0.5, metallic=float(i % 3 == 1)))
        d.add_sphere([(i % 13) * 0.45 - 2.7, 0.3 + (i // 13) * 0.45, -0.5],
                     0.2, i)
    return d


def _emitters(mod):
    """A 60-triangle emissive UV sphere above a ground sphere and two
    others: 60 NEE emitters, past the 32 the kernels hold."""
    d = mod.SceneDesc()
    _mats(mod, d)
    lamp = d.add_material(mod.Material([0.0, 0.0, 0.0], roughness=1.0,
                                       emission=[4.0, 3.6, 3.0]))
    mesh = d.add_mesh(mod.create_sphere_mesh(stacks=5, slices=6, radius=0.4))
    d.add_instance(mesh, mod.desc.translate(np.eye(4, dtype=np.float32),
                                            [0.0, 2.2, 0.0]), material_id=lamp)
    d.add_sphere([0.0, -100.0, 0.0], 100.0, 0)
    d.add_sphere([-0.8, 0.5, 0.0], 0.5, 1)
    d.add_sphere([0.8, 0.5, 0.3], 0.5, 2)
    return d


DECLINED = {"prims_without_accel": (_spheres, "no cluster accel"),
            "spheres_beside_mesh": (_mesh_spheres, "MAX_ACCEL_SPHERES"),
            "materials": (_materials, "MAX_MATERIALS"),
            "emitters": (_emitters, "MAX_EMITTERS")}


def _port(build, w=W, h=H, depth=3, **kw):
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=depth,
                               **kw)
    return Renderer(build(tscene), cfg,
                    camera=tcamera.Camera(aspect_ratio=w / h, **POSE),
                    device=CPU)


def _jax(J, build, w=W, h=H, depth=3):
    cfg = J.config.RenderConfig(width=w, height=h, spp=1, max_depth=depth)
    return J.Renderer(build(J.scene), cfg,
                      camera=J.camera.Camera(aspect_ratio=w / h, **POSE),
                      multi_device=False)


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def _same(a, b):
    """Bit for bit: float tensors compared as their int32 words."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


# --- against the JAX package --------------------------------------------------------

@pytest.mark.parametrize("name", ["prims_without_accel",
                                  "spheres_beside_mesh"])
def test_declined_scene_matches_jax_renderer(J, name):
    build = DECLINED[name][0]
    t, j = _port(build), _jax(J, build)
    assert (t.scene.accel is None) == (name == "prims_without_accel")
    assert not twf._fused_ok(t.cfg, t.scene, t.lights)
    t.render_frames(2)
    j.render_frames(2)
    got, want = t.hdr_image(), j.hdr_image()
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    assert _rel_rmse(got, want) < 0.01
    rays = t.last_stats.rays_per_bounce.numpy()
    assert int(rays[0]) == 2 * W * H
    np.testing.assert_allclose(rays, np.asarray(j.last_stats.rays_per_bounce),
                               rtol=5e-3)


def test_compact_and_regen_match_jax_on_declined_scene(J):
    # 128 x 128 = 16 384 lanes: compact takes its chunk loops
    j = _jax(J, _spheres, 128, 128)
    j.render_frames(1)
    want = j.hdr_image()
    for integrator in ("compact", "regen"):
        t = _port(_spheres, 128, 128, integrator=integrator)
        t.render_frames(1)
        assert _rel_rmse(t.hdr_image(), want) < 0.01, integrator
        np.testing.assert_allclose(
            t.last_stats.rays_per_bounce.numpy(),
            np.asarray(j.last_stats.rays_per_bounce), rtol=5e-3)


@pytest.mark.parametrize("mode", DEBUG_MODES)
def test_render_debug_matches_jax_on_declined_scene(J, mode):
    assert J.debug.MODES == tdebug.MODES == DEBUG_MODES
    w, h = 24, 16
    want = np.asarray(J.debug.render_debug(
        J.config.RenderConfig(width=w, height=h),
        J.scene.flatten_scene(_spheres(J.scene)),
        J.camera.Camera(aspect_ratio=w / h, **POSE).rays(), mode))
    got = tdebug.render_debug(
        tconfig.RenderConfig(width=w, height=h),
        tscene.flatten_scene(_spheres(tscene), CPU),
        tcamera.Camera(aspect_ratio=w / h, **POSE).rays(CPU), mode).numpy()
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    if mode in ("normal", "depth"):
        # the radius-100 ground sphere's |oc|^2 - r^2 cancels at grazing
        # angles, and the packages sum |oc|^2 in other orders (jnp.sum, the
        # port's component sum): its normals there differ by up to 2.5e-4
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-4 if mode == "normal" else 1e-5)
    else:
        np.testing.assert_array_equal(got, want)


# --- the route decision ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(DECLINED))
def test_declines_where_jax_declines(J, name):
    build, why = DECLINED[name]
    t = _port(build)
    reason = cuda_bounce.explain_decline(t.cfg, t.scene, t.lights)
    assert reason is not None and why in reason
    assert not twf._fused_ok(t.cfg, t.scene, t.lights)
    js = J.scene.flatten_scene(build(J.scene))
    jl = J.lights.default_lights()
    assert not J.pb.supports(js, jl, W * H, pad_ok=True)
    assert J.pb.explain_decline(js, jl, W * H, pad_ok=True) is not None


def _kept(J):
    desc, cfg, cam = chip_smoke.port_mesh_scene(stacks=8, slices=12)
    mesh = (desc, cfg.replace(width=W, height=H), tlights.default_lights(CPU))
    j_mesh, _ = chip_smoke.mesh_scene(J.scene, J.materials, J.scene.desc,
                                      stacks=8, slices=12)
    lm = tlights.LightManager()
    lm.add_directional_light((0.4, -1.0, -0.3), (1.0, 0.95, 0.9), 1.0)
    cfg = tconfig.RenderConfig(width=W, height=H)
    return {"default": (tscene.build_default_scene(), cfg,
                        tlights.default_lights(CPU),
                        J.scene.build_default_scene()),
            "cornell": (tscene.build_cornell_box_scene(),
                        cfg.replace(max_depth=8),
                        tlights.LightManager().device(CPU),
                        J.scene.build_cornell_box_scene()),
            "hdr": (tscene.build_hdr_glass_scene(), cfg, lm.device(CPU),
                    J.scene.build_hdr_glass_scene()),
            "mesh": mesh + (j_mesh,)}


@pytest.mark.parametrize("name", ["default", "cornell", "hdr", "mesh"])
def test_keeps_the_fused_route_on_supported_scenes(J, name):
    desc, cfg, lights, jdesc = _kept(J)[name]
    scene = tscene.flatten_scene(desc, CPU)
    assert cuda_bounce.explain_decline(cfg, scene, lights) is None
    assert twf._fused_ok(cfg, scene, lights)
    assert J.pb.explain_decline(J.scene.flatten_scene(jdesc),
                                J.lights.default_lights(), W * H,
                                pad_ok=True) is None


def test_a_declined_scene_logs_each_reason_once(caplog, monkeypatch):
    monkeypatch.setattr(twf, "_ANNOUNCED", set())
    t = _port(_materials, 8, 8, depth=2)
    with caplog.at_level(logging.WARNING, logger="spt_tpu_torch"):
        t.render_frames(1)
        t.render_frames(2)
        _port(_spheres, 8, 8, depth=2).render_frames(1)
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 2
    assert "65 materials > MAX_MATERIALS=64" in lines[0]
    assert "200 primitives > MAX_PRIMS=192" in lines[1]
    assert all("unfused bounce" in m for m in lines)


def test_a_kernel_failure_on_a_supported_scene_raises(monkeypatch):
    # the route is chosen before any launch: a failing kernel on a scene
    # the kernels take propagates, and the unfused loop never runs
    def fail(*a, **k):
        raise RuntimeError("fused_frame failed: CUDA error 700")

    def unfused(*a, **k):
        raise AssertionError("switched to the unfused route")

    monkeypatch.setattr(cuda_bounce, "fused_frame", fail)
    monkeypatch.setattr(cuda_bounce, "fused_bounce", fail)
    monkeypatch.setattr(ttr, "bounce_loop", unfused)
    for integrator in ("masked", "compact"):
        r = Renderer(tscene.build_default_scene(),
                     tconfig.RenderConfig(width=128, height=128, spp=1,
                                          max_depth=3, integrator=integrator),
                     camera=tcamera.default_camera(128, 128), device=CPU)
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            r.render_frames(1)


def test_the_kernels_refuse_a_declined_scene():
    t = _port(_emitters, 8, 8)
    ps = ttr.gen_primary(t.cfg, t.camera.rays(CPU), 1)
    with pytest.raises(NotImplementedError, match="MAX_EMITTERS"):
        cuda_bounce._kernel_inputs(t.cfg, t.scene, t.lights, ps,
                                   "fused_frame")


# --- the unfused route against the fused one ----------------------------------------

@pytest.mark.parametrize("name", list(DECLINED) + ["default"])
def test_unfused_loop_matches_the_fused_plain_version(name, monkeypatch):
    # the fused route on the CPU is fused_frame_reference; sorting is off,
    # so that it runs the whole frame as the unfused loop does
    if name == "default":
        t = Renderer(tscene.build_default_scene(),
                     tconfig.RenderConfig(width=W, height=H, max_depth=4),
                     camera=tcamera.default_camera(W, H), device=CPU)
    else:
        t = _port(DECLINED[name][0], depth=4)
    cfg, scene, lights, env = t.cfg.replace(ray_sort=False), t.scene, \
        t.lights, t.env
    ps = ttr.gen_primary(cfg, t.camera.rays(CPU), 2)
    runs = {}
    for fused in (False, True):
        monkeypatch.setattr(twf, "_fused_ok", lambda *a, f=fused: f)
        runs[fused] = twf._wavefront_masked(cfg, scene, env, lights, ps)
    (rad, stats), (want, want_stats) = runs[False], runs[True]
    assert _same(rad, want)
    assert _same(stats.rays_per_bounce, want_stats.rays_per_bounce)
    assert int(stats.bounces_run) == int(want_stats.bounces_run)
    rays = stats.rays_per_bounce
    assert int(rays[0]) == W * H and int(rays[-1]) > 0


# --- on the card -------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step is a CUDA graph")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name, integrator", [
    (n, "masked") for n in DECLINED] + [("prims_without_accel", "compact")])
def test_captured_declined_scene_matches_frame_chain_on_card(
        cuda_device, name, integrator):
    w, h = (128, 128) if integrator == "compact" else (96, 64)
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=4,
                               integrator=integrator)
    r = Renderer(DECLINED[name][0](tscene), cfg,
                 camera=tcamera.Camera(aspect_ratio=w / h, **POSE),
                 device=cuda_device)
    args = (r.cfg, r.scene, r.env, r.lights, r.camera.rays(cuda_device))
    wants = []

    def chain():
        st = r.state
        for k in (1, 3):
            st, stats = frame_chain(*args, st, k)
            wants.append((st, stats))

    def captured():
        for k, (ws, wstats) in zip((1, 3), wants):
            r.render_frames(k)
            assert all(_same(a, b) for a, b in zip(r.state, ws))
            assert _same(r.last_stats.rays_per_bounce, wstats.rays_per_bounce)
            assert _same(r.last_stats.bounces_run, wstats.bounces_run)

    eager = _counts_of(chain)
    assert _counts_of(captured) == eager
    assert r.captured_step().graph.launches == 3
    for m, a in ((cuda_bounce, "LAUNCHES"), (cuda_bounce, "BOUNCE_LAUNCHES"),
                 (cuda_sort, "LAUNCHES")):
        assert (m, a) not in eager


def _counts_of(fn):
    """The launch counts `fn` adds (launch_counts read after a sync)."""
    torch.cuda.synchronize()
    before = twf.launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in twf._count_delta(twf.launch_counts(),
                                                 before).items() if v}
