"""The sorted mesh frame of spt_tpu_torch against spt_tpu, on the CPU.

fused_bounce's plain version and the sorted frame (wavefront.py's
_fused_mesh_sorted_frame) in both branches, on small scenes with a
cluster_size-8 accel forced on them and the prim caps of both packages
lowered, as tests/test_pallas.py:333-351,490-578 force them.  The JAX side
runs its Pallas kernels in interpret mode.  Gates, each with its reason:

- fused_bounce's plain version against pallas fused_bounce: rtol 1e-4 /
  atol 1e-5 on >= 99.5 % of lanes, missed and alive equal on the same
  share (a lane may take the other side of a branch on a last-bit
  difference of the frameworks' CPU rsqrt/sin/cos);
- the sorted frame against the port's unsorted frame: rtol 1e-4 /
  atol 1e-5 on every lane (sorting only regroups lanes), rays_per_bounce
  exact;
- the sorted frame against JAX's fused frame: the same on >= 99.5 % of
  lanes (one lane of 8192 in the condensed case differs by 1.5e-4
  relative, as much from JAX's unfused frame: the frameworks' CPU
  transcendentals), rays_per_bounce exact.
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
from spt_tpu.integrators import transport as jtr  # noqa: E402
from spt_tpu.integrators import wavefront as jwf  # noqa: E402
from spt_tpu.ops import bvh as jbvh  # noqa: E402
from test_torch_mesh import interpret_pallas  # noqa: E402,F401

from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import env as tenv  # noqa: E402
from spt_tpu_torch import interop  # noqa: E402
from spt_tpu_torch import lights as tlights  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.ops import cuda_bounce  # noqa: E402

CPU = torch.device("cpu")


# --- fused_bounce and the sorted frame ------------------------------------------

def _forced_accel(jscene_, monkeypatch, cap):
    """A small JAX scene with a cluster_size-8 accel forced on it, and the
    prim caps of both packages lowered so that accel mode engages
    (tests/test_pallas.py:333-351)."""
    import spt_tpu.ops.pallas_bounce as pb

    accel = jbvh.build_mesh_accel(np.asarray(jscene_.tri_v0),
                                  np.asarray(jscene_.tri_e1),
                                  np.asarray(jscene_.tri_e2),
                                  np.asarray(jscene_.tri_mat), cluster_size=8)
    js = jscene_._replace(accel=accel)
    monkeypatch.setattr(pb, "MAX_PALLAS_PRIMS", cap)
    monkeypatch.setattr(cuda_bounce, "MAX_PRIMS", cap)
    ts = interop.scene(js, CPU)
    assert pb._accel_mode(js) == "resident"
    assert cuda_bounce._accel_mode(ts) == "resident"
    return js, ts


def _close(got, want, share=0.995):
    ok = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
    return ok.all(-1).mean() >= share


def test_fused_bounce_reference_matches_pallas(interpret_pallas, monkeypatch):
    pb, _ = interpret_pallas
    js, ts = _forced_accel(jscene.flatten_scene(jscene.build_default_scene()),
                           monkeypatch, 4)
    cfg = jconfig.RenderConfig(width=64, height=32, spp=1, max_depth=4)
    tcfg = tconfig.RenderConfig(width=64, height=32, spp=1, max_depth=4)
    cam = jcamera.default_camera(64, 32).rays()
    ps = jtr.gen_primary(cfg, cam, 3)
    lights = jlights.default_lights()
    tps = interop.path_state(ps, CPU)
    tl = interop.lights(lights, CPU)
    for bounce in range(2):
        want, wmissed = pb.fused_bounce(cfg, js, lights, ps, bounce, False)
        got, gmissed = cuda_bounce.fused_bounce(tcfg, ts, tl, tps, bounce,
                                                False)
        assert cuda_bounce.BOUNCE_LAUNCHES == 0
        for g, w in zip((got.radiance, got.direction, got.throughput),
                        (want.radiance, want.direction, want.throughput)):
            assert _close(torch.stack(list(g), -1).numpy(),
                          np.stack([np.asarray(c) for c in w], -1))
        assert (gmissed.numpy() == np.asarray(wmissed)).mean() >= 0.995
        assert (got.alive.numpy() == np.asarray(want.alive)).mean() >= 0.995
        ps, tps = want, interop.path_state(want, CPU)


def _frame_case(name, monkeypatch):
    """(JAX scene, port scene, w, h, camera kwargs, config overrides) of the
    sorted-frame cases of tests/test_pallas.py:490-578.  The default scene
    at 64x64 fits the condense heads, so its full-width case turns the
    condense off; Cornell fills the frame, so every chunk keeps more
    survivors than its head holds and the runtime check picks the
    full-width branch."""
    if name in ("full_width", "unsafe_full_width"):
        cornell = name == "unsafe_full_width"
        js, ts = _forced_accel(jscene.flatten_scene(
            jscene.build_cornell_box_scene() if cornell
            else jscene.build_default_scene()), monkeypatch, 4)
        cam = (dict(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                    fov_degrees=50.0, aspect_ratio=1.0) if cornell else
               dict(position=(0.0, 3.0, 8.0), target=(0.0, 1.0, 0.0),
                    fov_degrees=60.0, aspect_ratio=1.0))
        return js, ts, 64, 64, cam, {} if cornell else {"condense": False}
    js, ts = _forced_accel(
        jscene.flatten_scene(jscene.build_test_triangle_scene()), monkeypatch, 1)
    cam = dict(position=(0.0, 1.0, 6.0), target=(0.0, 0.5, 0.0),
               fov_degrees=45.0, aspect_ratio=1.0)
    return js, ts, 128, 64, cam, {}


@pytest.mark.parametrize("case", ["full_width", "unsafe_full_width",
                                  "condensed"])
def test_sorted_frame_matches_unsorted(case, monkeypatch):
    _, ts, w, h, cam, kw = _frame_case(case, monkeypatch)
    branch = "condensed" if case == "condensed" else "full_width"
    rays = tcamera.Camera(**cam).rays(CPU)
    env = tenv.make_procedural_environment(CPU)
    lights = (tlights.LightManager().device(CPU) if case == "unsafe_full_width"
              else tlights.default_lights(CPU))
    out = {}
    for sort in (True, False):
        cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=4,
                                   ray_sort=sort, **kw)
        ps = ttr.gen_primary(cfg, rays, 0)
        twf.SORTED_SAMPLES.clear()
        out[sort] = twf._wavefront_masked(cfg, ts, env, lights, ps)
        assert dict(twf.SORTED_SAMPLES) == ({branch: 1} if sort else {})
    np.testing.assert_allclose(out[True][0].numpy(), out[False][0].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out[True][1].rays_per_bounce.numpy(),
                                  out[False][1].rays_per_bounce.numpy())


@pytest.mark.parametrize("branch", ["full_width", "condensed"])
def test_sorted_frame_matches_jax(branch, interpret_pallas, monkeypatch):
    js, ts, w, h, cam, kw = _frame_case(branch, monkeypatch)
    jcfg = jconfig.RenderConfig(width=w, height=h, spp=1, max_depth=4, **kw)
    tcfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=4, **kw)
    jrays = jcamera.Camera(**cam).rays()
    ps = jtr.gen_primary(jcfg, jrays, 0)
    assert jwf._ray_sort_ok(jcfg, js, w * h)
    want, wstats = jwf._wavefront_masked(
        jcfg, js, jenv.make_procedural_environment(), jlights.default_lights(),
        ps, jnp.zeros((4,), jnp.int32), fused=True)
    twf.SORTED_SAMPLES.clear()
    got, gstats = twf._wavefront_masked(
        tcfg, ts, tenv.make_procedural_environment(CPU),
        tlights.default_lights(CPU), interop.path_state(ps, CPU))
    assert dict(twf.SORTED_SAMPLES) == {branch: 1}
    assert _close(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gstats.rays_per_bounce.numpy(),
                                  np.asarray(wstats.rays_per_bounce))
