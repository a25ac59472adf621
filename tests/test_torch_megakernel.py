"""The megakernel integrator of spt_tpu_torch: image and gradients.

The image is held to the JAX package's ``render_megakernel`` at the
repo's image gate (relative RMSE < 1 %: the same per-pixel RNG streams,
float rounding apart).  The gradient of an image mean with respect to
``base_color`` is held to central finite differences at 5 % (the gate of
tests/test_grad.py) and to ``jax.grad`` at rtol 1e-3 / atol 1e-7 of the
largest entry (the same derivative of the same float32 forward pass,
summed in another order); the roughness and metallic gradients must be
finite, as tests/test_grad.py:60 asks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from spt_tpu import camera as jcamera  # noqa: E402
from spt_tpu import config as jconfig  # noqa: E402
from spt_tpu import env as jenv  # noqa: E402
from spt_tpu import lights as jlights  # noqa: E402
from spt_tpu import scene as jscene  # noqa: E402
from spt_tpu.integrators import megakernel as jmk  # noqa: E402

from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import env as tenv  # noqa: E402
from spt_tpu_torch import lights as tlights  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.engine.renderer import Renderer  # noqa: E402
from spt_tpu_torch.integrators import megakernel as tmk  # noqa: E402

CPU = torch.device("cpu")


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def _port(w, h, depth, spp=1):
    cfg = tconfig.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    return (cfg, tscene.flatten_scene(tscene.build_default_scene(), CPU),
            tenv.make_procedural_environment(CPU), tlights.default_lights(CPU),
            tcamera.default_camera(w, h).rays(CPU))


def _jax(w, h, depth, spp=1):
    cfg = jconfig.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    return (cfg, jscene.flatten_scene(jscene.build_default_scene()),
            jenv.make_procedural_environment(), jlights.default_lights(),
            jcamera.default_camera(w, h).rays())


def test_megakernel_matches_jax():
    # JAX's render_megakernel is a fori_loop over render_sample, averaged;
    # its body is run here sample by sample, eagerly (one XLA program of the
    # whole loop costs about a minute of compile on the CPU)
    got = tmk.render_megakernel(*_port(32, 24, 3, spp=2), frame_index=1)
    jargs = _jax(32, 24, 3, spp=2)
    want = sum(np.asarray(jmk.render_sample(*jargs, 1, s)) for s in range(2))
    want = (want / 2).reshape(24, 32, 3)
    assert got.shape == (24, 32, 3) and torch.isfinite(got).all()
    assert _rel_rmse(got.numpy(), want) < 0.01


def _port_loss(cfg, scene, env, lights, cam, **mats):
    s = scene._replace(materials=scene.materials._replace(**mats))
    return tmk.render_sample(cfg, s, env, lights, cam, 0).mean()


def test_albedo_grad_matches_finite_differences_and_jax():
    cfg, scene, env, lights, cam = _port(32, 16, 3)
    bc = scene.materials.base_color.clone().requires_grad_(True)
    _port_loss(cfg, scene, env, lights, cam, base_color=bc).backward()
    g = bc.grad.numpy()
    assert np.isfinite(g).all() and (np.abs(g) > 0).sum() >= 6

    jcfg, jsc, jenv_, jl, jcam = _jax(32, 16, 3)

    def jloss(base_color):
        s = jsc._replace(materials=jsc.materials._replace(base_color=base_color))
        return jnp.mean(jmk.render_sample(jcfg, s, jenv_, jl, jcam, 0))

    jg = np.asarray(jax.grad(jloss)(jsc.materials.base_color))
    np.testing.assert_allclose(g, jg, rtol=1e-3,
                               atol=1e-7 * float(np.abs(jg).max()))

    # central finite differences on the 3 largest-|grad| entries
    for f in np.abs(g).ravel().argsort()[::-1][:3]:
        i, j = np.unravel_index(f, g.shape)
        eps = 1e-3
        e = torch.zeros_like(bc)
        e[i, j] = eps
        with torch.no_grad():
            hi = _port_loss(cfg, scene, env, lights, cam, base_color=bc + e)
            lo = _port_loss(cfg, scene, env, lights, cam, base_color=bc - e)
        fd = float((hi - lo) / (2 * eps))
        assert abs(g[i, j] - fd) <= 0.05 * max(abs(fd), 1e-6), (
            f"entry ({i},{j}): analytic {g[i, j]:.6g} vs fd {fd:.6g}")


def test_roughness_and_metallic_grads_finite():
    cfg, scene, env, lights, cam = _port(32, 16, 3)
    rough = scene.materials.roughness.clone().requires_grad_(True)
    metal = scene.materials.metallic.clone().requires_grad_(True)
    _port_loss(cfg, scene, env, lights, cam, roughness=rough,
               metallic=metal).backward()
    assert torch.isfinite(rough.grad).all() and torch.isfinite(metal.grad).all()
    assert (metal.grad.abs() > 0).any()


def test_flattened_materials_are_leaves():
    # a caller sets requires_grad on the scene's own tables
    scene = tscene.flatten_scene(tscene.build_default_scene(), CPU)
    for t in (scene.materials.base_color, scene.materials.roughness,
              scene.materials.metallic):
        assert t.is_leaf
        t.requires_grad_(True)
    cfg, _, env, lights, cam = _port(16, 8, 2)
    tmk.render_sample(cfg, scene, env, lights, cam, 0).sum().backward()
    assert scene.materials.base_color.grad is not None


@pytest.mark.parametrize("start", ["masked", "compact", "regen"])
def test_renderer_megakernel_and_toggle(start):
    w, h = 24, 16
    cfg = tconfig.RenderConfig(width=w, height=h, max_depth=3, integrator=start)
    r = Renderer(tscene.build_default_scene(), cfg,
                 camera=tcamera.default_camera(w, h), device=CPU)
    r.render_frames(2)
    assert r.accumulated_samples == 2
    assert r.toggle_integrator() == "megakernel"
    assert r.accumulated_samples == 0          # the toggle resets
    r.render_frames(2)
    assert r.accumulated_samples == 2
    rays = r.last_stats.rays_per_bounce.numpy()
    assert rays.tolist() == [2 * w * h, 0, 0]  # primaries only
    assert int(r.last_stats.bounces_run) == 3
    img = r.hdr_image()
    assert img.shape == (h, w, 3) and np.isfinite(img).all() and img.max() > 0
    assert r.toggle_integrator() == start
    assert r.cfg.integrator == start and r.accumulated_samples == 0


def test_renderer_megakernel_frame_is_render_megakernel():
    # the Renderer's megakernel frame accumulates render_megakernel's image
    w, h = 32, 24
    cfg = tconfig.RenderConfig(width=w, height=h, spp=2, max_depth=3,
                               integrator="megakernel")
    r = Renderer(tscene.build_default_scene(), cfg,
                 camera=tcamera.default_camera(w, h), device=CPU)
    r.render_frames(1)
    want = tmk.render_megakernel(*_port(w, h, 3, spp=2), frame_index=0)
    np.testing.assert_allclose(r.hdr_image(), want.numpy(), rtol=1e-6,
                               atol=1e-7)
