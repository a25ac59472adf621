"""The whole slice: spt_tpu_torch's Renderer on the CPU against spt_tpu's.

Gate: hdr_image relative RMSE < 1 % against the JAX Renderer on the same
config (the repo's existing image gate; the two packages trace the same
per-pixel RNG streams, so the images differ only by float rounding and the
rare lane that takes the other side of a branch).  Telemetry:
rays_per_bounce[0] == frames * W * H exactly.  The captured step's body
(``StaticStep.frame``, run eagerly) on the frames the card takes whole
and on those it does not, bit for bit with ``frame_chain``.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

from spt_tpu import camera as jcamera  # noqa: E402
from spt_tpu import config as jconfig  # noqa: E402
from spt_tpu import env as jenv  # noqa: E402
from spt_tpu import lights as jlights  # noqa: E402
from spt_tpu import scene as jscene  # noqa: E402
from spt_tpu.engine import state as jstate  # noqa: E402
from spt_tpu.engine.renderer import Renderer as JaxRenderer  # noqa: E402

from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import env as tenv  # noqa: E402
from spt_tpu_torch import lights as tlights  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.engine import state as tstate  # noqa: E402
from spt_tpu_torch.engine.image import read_png  # noqa: E402
from spt_tpu_torch.engine.renderer import (Renderer, StaticStep,  # noqa: E402
                                           frame_chain)
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.ops import cuda_bounce  # noqa: E402

CPU = torch.device("cpu")
W, H, FRAMES = 64, 48, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _renderers(name):
    """(JAX Renderer, port Renderer) on the same BASELINE-style config."""
    depth = 8 if name == "cornell" else 6
    kw = dict(width=W, height=H, spp=1, max_depth=depth)
    jcfg, tcfg = jconfig.RenderConfig(**kw), tconfig.RenderConfig(**kw)
    if name == "cornell":
        pose = dict(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                    fov_degrees=50.0, aspect_ratio=W / H)
        j = JaxRenderer(jscene.build_cornell_box_scene(), jcfg,
                        lights=jlights.LightManager().device(),
                        camera=jcamera.Camera(**pose), multi_device=False)
        t = Renderer(tscene.build_cornell_box_scene(), tcfg,
                     lights=tlights.LightManager().device(CPU),
                     camera=tcamera.Camera(**pose), device=CPU)
        return j, t
    if name == "hdr_glass":
        pose = dict(position=(0, 2.0, 6.0), target=(0, 1.0, 0.0),
                    fov_degrees=50.0, aspect_ratio=W / H)
        jlm, tlm = jlights.LightManager(), tlights.LightManager()
        for lm in (jlm, tlm):
            lm.add_directional_light((0.4, -1.0, -0.3), (1.0, 0.95, 0.9), 1.0)
        img = tenv.synthetic_equirect(64)
        j = JaxRenderer(jscene.build_hdr_glass_scene(), jcfg,
                        env=jenv.make_hdr_environment(img), lights=jlm.device(),
                        camera=jcamera.Camera(**pose), multi_device=False)
        t = Renderer(tscene.build_hdr_glass_scene(), tcfg,
                     env=tenv.make_hdr_environment(img, CPU),
                     lights=tlm.device(CPU), camera=tcamera.Camera(**pose),
                     device=CPU)
        return j, t
    j = JaxRenderer(jscene.build_default_scene(), jcfg,
                    camera=jcamera.default_camera(W, H), multi_device=False)
    t = Renderer(tscene.build_default_scene(), tcfg,
                 camera=tcamera.default_camera(W, H), device=CPU)
    return j, t


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.mark.parametrize("name", ["default", "cornell", "hdr_glass"])
def test_slice_matches_jax_renderer(name):
    j, t = _renderers(name)
    j.render_frames(FRAMES)
    t.render_frames(FRAMES)
    want, got = j.hdr_image(), t.hdr_image()
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    assert _rel_rmse(got, want) < 0.01
    rays = t.last_stats.rays_per_bounce.numpy()
    assert int(rays[0]) == FRAMES * W * H
    jrays = np.asarray(j.last_stats.rays_per_bounce)
    np.testing.assert_allclose(rays, jrays, rtol=5e-3)
    assert t.accumulated_samples == j.accumulated_samples == FRAMES
    np.testing.assert_allclose(t.image(), np.asarray(j.image()), atol=0.02)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    j, t = _renderers("default")
    j.render_frames(2)
    path = str(tmp_path / "ck.npz")
    j.save_checkpoint(path)
    t.load_checkpoint(path)
    np.testing.assert_array_equal(t.state.accum.numpy(), np.asarray(j.state.accum))
    assert float(t.state.sample_count) == float(j.state.sample_count) == 2.0
    assert int(t.state.frame_index) == int(j.state.frame_index) == 2
    # both continue with the same RNG epochs
    j.render_frames(2)
    t.render_frames(2)
    assert _rel_rmse(t.hdr_image(), j.hdr_image()) < 0.01
    # and back: the port's checkpoint loads in the JAX package
    t.save_checkpoint(path)
    back = jstate.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(back.accum), t.state.accum.numpy())
    assert int(back.frame_index) == 4


def test_port_imports_no_jax():
    bad = []
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "spt_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "spt_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {m}")
    assert not bad, bad


@pytest.mark.parametrize("change", [
    {"spheres_beside_mesh": 33}, {"stream_tier": True},
    {"spheres_without_mesh": 200}, {"multi_device": True}])
def test_unported_options_raise(change, monkeypatch):
    # what the port refuses: a mesh past the stream tier's cluster limit,
    # and pixel-band sharding without a process group, which names how to
    # start one; more than 32 spheres beside a cluster accel, and more than
    # 192 primitives without enough triangles for one, render through the
    # unfused route instead, as the JAX package renders them
    cfg = tconfig.RenderConfig(width=16, height=8)
    if change.get("multi_device"):
        with pytest.raises(RuntimeError,
                           match="torchrun.*init_process_group"):
            Renderer(tscene.build_default_scene(), cfg, device=CPU,
                     multi_device=True)
        return
    desc = tscene.build_default_scene()
    if "spheres_beside_mesh" in change:
        desc.add_instance(desc.add_mesh(tscene.create_sphere_mesh(
            stacks=16, slices=16)))
    for key in ("spheres_beside_mesh", "spheres_without_mesh"):
        for i in range(change.get(key, 0)):
            desc.add_sphere((0.1 * i, 5.0, 0.0), 0.05)
    if "stream_tier" in change:
        # a single mesh past MAX_RESIDENT_TRIS takes the stream tier (K8)
        # now; past its cluster limit (lowered here) it still raises
        from spt_tpu_torch.ops import bvh as tbvh

        monkeypatch.setattr(tbvh, "MAX_STREAM_CLUSTERS", 192)
        desc.add_instance(desc.add_mesh(tscene.create_sphere_mesh(
            stacks=80, slices=80)))
        with pytest.raises(NotImplementedError):
            r = Renderer(desc, cfg, device=CPU)
            r.render_frame()
        return
    r = Renderer(desc, cfg, device=CPU)
    why = ("MAX_ACCEL_SPHERES" if "spheres_beside_mesh" in change
           else "no cluster accel")
    assert why in cuda_bounce.explain_decline(cfg, r.scene, r.lights)
    r.render_frame()
    assert np.isfinite(r.hdr_image()).all()


def test_cuda_device_names_the_current_card(monkeypatch):
    # "cuda" becomes the current card's index, as the tensors made on it
    # report their device: Renderer(desc) with its default device="cuda"
    # used to refuse its own procedural environment ("cuda:0" != "cuda")
    from spt_tpu_torch.engine.renderer import render_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert render_device("cuda") == torch.device("cuda", 3)
    assert render_device("cuda:1") == torch.device("cuda", 1)
    assert render_device(CPU) == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_device("cuda")


def test_env_on_another_device_is_refused():
    env = tenv.make_procedural_environment(torch.device("meta"))
    with pytest.raises(ValueError, match="meta"):
        Renderer(tscene.build_default_scene(), tconfig.RenderConfig(width=8, height=8),
                 env=env, device=CPU)


def test_progressive_loop_reset_resize_png(tmp_path):
    cfg = tconfig.RenderConfig(width=16, height=12, max_depth=3)
    r = Renderer(tscene.build_default_scene(), cfg,
                 camera=tcamera.default_camera(16, 12), device=CPU)
    before = cuda_bounce.LAUNCHES
    r.render_frame()       # first check resets (camera "moved")
    r.render_frame()
    assert r.accumulated_samples == 2 and int(r.state.frame_index) == 2
    r.camera.process_mouse(30.0, 0.0)
    r.render_frame()       # movement resets accumulation, not the epoch
    assert r.accumulated_samples == 1 and int(r.state.frame_index) == 3
    assert cuda_bounce.LAUNCHES == before  # CPU tensors never launch
    path = str(tmp_path / "o.png")
    r.save_png(path)
    png = read_png(path)
    assert png.shape == (12, 16, 3) and png.max() > 0
    r.resize(24, 8)
    assert r.accumulated_samples == 0
    r.render_frames(2)
    assert r.image().shape == (8, 24, 3)
    assert int(r.last_stats.rays_per_bounce[0]) == 2 * 24 * 8
    assert abs(r.camera.aspect_ratio - 3.0) < 1e-12


# (scene, RenderConfig changes, band rows or None, whether the frame runs
# whole on the card): the default scene and cornell under the procedural
# sky at 64x36, with and without jitter and on a band past row 0, take the
# whole-frame form; an HDR map, spp 2, regen and a mesh scene do not.
STEP_CASES = [
    ("default", {}, None, True), ("default", {"jitter": False}, None, True),
    ("default", {}, (12, 12), True), ("cornell", {"max_depth": 8}, None, True),
    ("cornell", {"jitter": False}, (24, 12), True),
    ("hdr", {}, None, False), ("default", {"spp": 2}, None, False),
    ("default", {"integrator": "regen"}, (12, 12), False),
    ("mesh", {"max_depth": 3}, None, False)]


@pytest.mark.parametrize("name, change, band, whole", STEP_CASES)
def test_static_step_matches_frame_chain_whole_or_split(name, change, band,
                                                        whole):
    # three frames of the captured body run eagerly, from a frame index
    # about to wrap, against frame_chain: every word of the state and the
    # stats equal.  The rule takes the frames marked whole; on the CPU
    # every frame is the split one, and no whole-frame kernel launches
    # (the card's whole frames: tests/test_torch_fused_frame.py)
    import chip_smoke

    w, h = 64, 36
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=6)
    env = tenv.make_procedural_environment(CPU)
    lights = tlights.default_lights(CPU)
    cam = tcamera.default_camera(w, h)
    desc = tscene.build_default_scene()
    if name == "cornell":
        desc, lights = tscene.build_cornell_box_scene(), tlights.LightManager(
        ).device(CPU)
        cam = tcamera.Camera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                             fov_degrees=50.0, aspect_ratio=w / h)
    elif name == "hdr":
        env = tenv.make_hdr_environment(tenv.synthetic_equirect(16), CPU)
    elif name == "mesh":
        desc, _, _ = chip_smoke.port_mesh_scene(stacks=12, slices=16)
    cfg = cfg.replace(**change)
    scene = tscene.flatten_scene(desc, CPU)
    row0, rows = band or (0, h)
    assert twf._whole_frame_ok(cfg, scene, env, lights) is whole
    step = StaticStep(cfg, scene, env, lights, CPU, row0, rows)
    assert not step.whole and step.tables is None
    rays = cam.rays(CPU)
    st = tstate.init_state(w * rows, CPU)
    st.frame_index.fill_(2 ** 31 - 2)
    want = frame_chain(cfg, scene, env, lights, rays,
                       tstate.RenderState(*(t.clone() for t in st)), 3, row0,
                       rows)
    whole_counts = [(cuda_bounce, "WHOLE_LAUNCHES"),
                    (cuda_bounce, "WHOLE_GLOBAL_LAUNCHES")]
    before = [twf.launch_counts()[k] for k in whole_counts]
    step.load(rays, st)
    for _ in range(3):
        step.frame()
    assert [twf.launch_counts()[k] for k in whole_counts] == before
    for a, b in zip(step.state, want[0]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(step.state.frame_index) == -2 ** 31 + 1
    for a, b in zip(step.stats(), want[1]):
        assert torch.equal(a, b)
