"""The compact integrator of spt_tpu_torch against the masked path and JAX.

The compaction ops are held op for op against ``spt_tpu.ops.compaction``
(exact: they move integers and values, no arithmetic).  The compact path is
held to the port's masked path as ``tests/test_transport.py:157-190`` holds
the JAX package's: rays_per_bounce equal, images within rtol 1e-2 / atol
1e-3 (the two paths bounce the same lanes with the same RNG; only the
lane order inside a launch differs).  Against the JAX package's compact
path the gate is the port's image gate, relative RMSE < 1 %, and the rays
per bounce within 0.5 % (float rounding may send a rare lane the other
way at a branch, as in tests/test_torch_renderer.py).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import env as tenv  # noqa: E402
from spt_tpu_torch import lights as tlights  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.ops import compaction as tcp  # noqa: E402
from spt_tpu_torch.ops import cuda_bounce  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here, not at the top: the card
    test below runs where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from spt_tpu import camera, config, env, lights, scene
    from spt_tpu.integrators import wavefront
    from spt_tpu.ops import compaction

    return types.SimpleNamespace(jnp=jnp, camera=camera, config=config,
                                 env=env, lights=lights, scene=scene,
                                 wf=wavefront, cp=compaction)


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


# --- the ops, against spt_tpu.ops.compaction ----------------------------------

@pytest.mark.parametrize("kind", ["basic", "all_dead", "all_live", "random",
                                  "sparse"])
def test_compact_indices_matches_jax(J, kind):
    rng = np.random.default_rng(7)
    mask = {"basic": np.array([1, 0, 1, 1, 0, 0, 1, 0], bool),
            "all_dead": np.zeros(8, bool), "all_live": np.ones(8, bool),
            "random": rng.uniform(size=4096) < 0.3,
            "sparse": rng.uniform(size=1024) < 0.01}[kind]
    q, c = tcp.compact_indices(torch.from_numpy(mask))
    jq, jc = J.cp.compact_indices(J.jnp.asarray(mask))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert int(c) == int(jc) == int(mask.sum())
    # every live lane exactly once, in ascending order; padding at lane 0
    np.testing.assert_array_equal(q[:int(c)].numpy(), np.flatnonzero(mask))
    assert (q[int(c):] == 0).all()


def test_gather_scatter_roundtrip_matches_jax(J):
    rng = np.random.default_rng(11)
    n = 256
    mask = rng.uniform(size=n) < 0.4
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.integers(0, 100, size=n).astype(np.int32)
    q, c = tcp.compact_indices(torch.from_numpy(mask))
    packed = tcp.compact_gather({"a": torch.from_numpy(a),
                                 "b": torch.from_numpy(b)}, q)
    out = tcp.scatter_back({"a": packed["a"] + 1.0, "b": packed["b"] * 2}, q,
                           {"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
                           c)
    jq, jc = J.cp.compact_indices(J.jnp.asarray(mask))
    jnp = J.jnp
    jp = J.cp.compact_gather({"a": jnp.asarray(a), "b": jnp.asarray(b)}, jq)
    jout = J.cp.scatter_back({"a": jp["a"] + 1.0, "b": jp["b"] * 2}, jq,
                             {"a": jnp.asarray(a), "b": jnp.asarray(b)}, jc)
    for k in ("a", "b"):
        np.testing.assert_array_equal(packed[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    np.testing.assert_array_equal(out["a"].numpy()[~mask], a[~mask])
    np.testing.assert_array_equal(out["b"].numpy()[mask], b[mask] * 2)


def test_padding_entries_clamp_and_drop_like_jax(J):
    # a queue padded with index n (wavefront.py:226-228): the gather reads
    # lane n - 1 (JAX clamps), the scatter-home writes nothing
    n = 10
    vals = np.arange(n, dtype=np.float32) * 3.0
    queue = np.array([2, 5, 7, n, n], np.int64)
    got = tcp.compact_gather(torch.from_numpy(vals), torch.from_numpy(queue))
    jnp = J.jnp
    want = J.cp.compact_gather(jnp.asarray(vals), jnp.asarray(queue, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tcp.scatter_back(torch.full((5,), -1.0), torch.from_numpy(queue),
                            torch.from_numpy(vals), 5)
    jback = J.cp.scatter_back(jnp.full((5,), -1.0),
                              jnp.asarray(queue, jnp.int32), jnp.asarray(vals), 5)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    assert back[n - 1] == vals[n - 1] and (back[[2, 5, 7]] == -1.0).all()


def test_sort_by_key_and_live_count_match_jax(J):
    key = np.array([2, 0, 1, 0, 2, 1], np.int32)
    payload = np.arange(6, dtype=np.int32)
    order, sp = tcp.sort_by_key(torch.from_numpy(key), torch.from_numpy(payload))
    jorder, jsp = J.cp.sort_by_key(J.jnp.asarray(key), J.jnp.asarray(payload))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(sp.numpy(), [1, 3, 2, 5, 0, 4])
    m = np.array([True, False, True])
    assert int(tcp.live_count(torch.from_numpy(m))) == int(
        J.cp.live_count(J.jnp.asarray(m))) == 2


@pytest.mark.parametrize("n", [100, 8192, 10240, 19200, 2073600])
def test_queue_width_matches_jax(J, n):
    assert twf._queue_width(n) == J.wf._queue_width(n)


# --- the compact path ---------------------------------------------------------

def _default(w, h, depth=6):
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=depth)
    return (cfg, tscene.flatten_scene(tscene.build_default_scene(), CPU),
            tenv.make_procedural_environment(CPU), tlights.default_lights(CPU),
            tcamera.default_camera(w, h).rays(CPU))


def _cornell_inside(w, h, depth=3):
    # camera inside the box, so nearly every lane survives bounce 0 and the
    # later bounces need several queue chunks
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=depth)
    cam = tcamera.Camera(position=(0, 2.75, 2.5), target=(0, 2.75, 0.0),
                         fov_degrees=70.0, aspect_ratio=w / h)
    return (cfg, tscene.flatten_scene(tscene.build_cornell_box_scene(), CPU),
            tenv.make_procedural_environment(CPU),
            tlights.LightManager().device(CPU), cam.rays(CPU))


@pytest.mark.parametrize("w,h", [(128, 80), (160, 120)])
def test_compact_equals_masked(w, h):
    # 128x80 mirrors tests/test_transport.py (below the compaction floor of
    # 16384 lanes, so both take the masked path); 160x120 runs compacted
    cfg, scene, env, lights, cam = _default(w, h)
    a, sa = twf.render_wavefront(cfg, scene, env, lights, cam, 0)
    b, sb = twf.render_wavefront(cfg, scene, env, lights, cam, 0, compact=True)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-2, atol=1e-3)
    np.testing.assert_array_equal(sb.rays_per_bounce.numpy(),
                                  sa.rays_per_bounce.numpy())
    assert int(sb.bounces_run) == int(sa.bounces_run)


@pytest.mark.parametrize("w,h", [(128, 96), (160, 120)])
def test_multi_chunk_bounce(w, h):
    # an enclosed scene keeps every lane live past bounce 0, so bounce 1
    # needs several chunks; an unpadded last chunk would slide backwards and
    # bounce lanes twice (double RNG advance and radiance)
    cfg, scene, env, lights, cam = _cornell_inside(w, h)
    a, sa = twf.render_wavefront(cfg, scene, env, lights, cam, 0)
    b, sb = twf.render_wavefront(cfg, scene, env, lights, cam, 0, compact=True)
    n = w * h
    assert int(sa.rays_per_bounce[1]) > 8192
    if n >= twf.COMPACT_MIN_LANES:
        assert int(sa.rays_per_bounce[1]) > twf._queue_width(n)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-2, atol=1e-3)
    np.testing.assert_array_equal(sb.rays_per_bounce.numpy(),
                                  sa.rays_per_bounce.numpy())


def test_compact_bounce0_through_fused_bounce_chunks_through_shade(monkeypatch):
    # bounce 0 goes through fused_bounce once, at full width; later bounces
    # trace and shade chunks of _queue_width lanes
    cfg, scene, env, lights, cam = _cornell_inside(160, 120)
    cfg = cfg.replace(integrator="compact")
    calls, shades = [], []
    fb, sh = cuda_bounce.fused_bounce, ttr.shade

    def rec_fb(*a, **k):
        calls.append((a[3].num_paths, a[4]))
        return fb(*a, **k)

    def rec_sh(*a, **k):
        shades.append(a[4].num_paths)
        return sh(*a, **k)

    monkeypatch.setattr(cuda_bounce, "fused_bounce", rec_fb)
    monkeypatch.setattr(ttr, "shade", rec_sh)
    img, stats = twf.render_wavefront(cfg, scene, env, lights, cam, 0)
    assert calls == [(160 * 120, 0)]
    w = twf._queue_width(160 * 120)
    assert shades and set(shades) == {w}
    rays = stats.rays_per_bounce.numpy()
    assert len(shades) == sum(-(-int(r) // w) for r in rays[1:] if r)
    assert img.shape == (120, 160, 3) and torch.isfinite(img).all()


def test_compact_depth1_and_small_take_masked(monkeypatch):
    monkeypatch.setattr(twf, "_wavefront_compact",
                        lambda *a, **k: pytest.fail("compacted"))
    for w, h, d in ((160, 120, 1), (64, 48, 6)):
        cfg, scene, env, lights, cam = _default(w, h, d)
        twf.render_wavefront(cfg.replace(integrator="compact"), scene, env,
                             lights, cam, 0)


@pytest.mark.parametrize("name", ["default", "hdr_glass"])
def test_compact_matches_jax_compact(J, name):
    w, h, depth = 160, 120, 3
    kw = dict(width=w, height=h, spp=1, max_depth=depth, integrator="compact")
    jcfg, tcfg = J.config.RenderConfig(**kw), tconfig.RenderConfig(**kw)
    if name == "hdr_glass":
        pose = dict(position=(0, 2.0, 6.0), target=(0, 1.0, 0.0),
                    fov_degrees=50.0, aspect_ratio=w / h)
        jlm, tlm = J.lights.LightManager(), tlights.LightManager()
        for lm in (jlm, tlm):
            lm.add_directional_light((0.4, -1.0, -0.3), (1.0, 0.95, 0.9), 1.0)
        img = tenv.synthetic_equirect(64)
        jargs = (J.scene.flatten_scene(J.scene.build_hdr_glass_scene()),
                 J.env.make_hdr_environment(img), jlm.device(),
                 J.camera.Camera(**pose).rays())
        targs = (tscene.flatten_scene(tscene.build_hdr_glass_scene(), CPU),
                 tenv.make_hdr_environment(img, CPU), tlm.device(CPU),
                 tcamera.Camera(**pose).rays(CPU))
    else:
        jargs = (J.scene.flatten_scene(J.scene.build_default_scene()),
                 J.env.make_procedural_environment(), J.lights.default_lights(),
                 J.camera.default_camera(w, h).rays())
        targs = _default(w, h, depth)[1:]
    want, jstats = J.wf.render_wavefront(jcfg, *jargs, 0)
    got, tstats = twf.render_wavefront(tcfg, *targs, 0)
    assert _rel_rmse(got.numpy(), np.asarray(want)) < 0.01
    np.testing.assert_allclose(tstats.rays_per_bounce.numpy(),
                               np.asarray(jstats.rays_per_bounce), rtol=5e-3)


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused_bounce kernel has no CPU "
                    "mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_compact_bounce0_kernel_matches_plain_on_card(cuda_device, monkeypatch):
    # K3's small form at the compact path's bounce-0 call on cornell, every
    # returned plane bit for bit against its plain version
    w, h = 256, 192
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=8,
                               integrator="compact")
    cam = tcamera.Camera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                         fov_degrees=50.0, aspect_ratio=w / h)
    scene = tscene.flatten_scene(tscene.build_cornell_box_scene(), cuda_device)
    lights = tlights.LightManager().device(cuda_device)
    env = tenv.make_procedural_environment(cuda_device)
    calls = []
    fb = cuda_bounce.fused_bounce

    def rec(*a, **k):
        calls.append((a, k))
        return fb(*a, **k)

    monkeypatch.setattr(cuda_bounce, "fused_bounce", rec)
    before = cuda_bounce.BOUNCE_LAUNCHES
    img, _ = twf.render_wavefront(cfg, scene, env, lights, cam.rays(cuda_device),
                                  0)
    torch.cuda.synchronize()
    assert cuda_bounce.BOUNCE_LAUNCHES == before + 1 and len(calls) == 1
    (args, kw), = calls
    assert args[4] == 0 and args[3].num_paths == w * h
    k, km = fb(*args, **kw)
    p, pm = cuda_bounce.fused_bounce_reference(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y)
    assert torch.equal(km, pm)
    assert torch.isfinite(img).all()


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["compact", "megakernel"])
def test_renderer_default_device_renders_on_card(cuda_device, integrator):
    # the entry point's default device="cuda", with the integrators this
    # slice ports; multi_device=True without a process group raises, naming
    # how to start one
    from spt_tpu_torch.engine.renderer import Renderer

    cfg = tconfig.RenderConfig(width=160, height=120, max_depth=4,
                               integrator=integrator)
    r = Renderer(tscene.build_default_scene(), cfg,
                 camera=tcamera.default_camera(160, 120))
    assert r.device.type == "cuda"
    r.render_frames(2)
    img = r.hdr_image()
    assert img.shape == (120, 160, 3) and np.isfinite(img).all()
    assert img.max() > 0 and r.accumulated_samples == 2
    with pytest.raises(RuntimeError, match="torchrun.*init_process_group"):
        Renderer(tscene.build_default_scene(),
                 cfg.replace(integrator="masked"), multi_device=True)
