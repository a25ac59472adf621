"""One shade_core bounce of spt_tpu_torch against spt_tpu from the same state.

Both packages start from the JAX package's path state (carried across with
``interop``) and shade one bounce, as tests/test_pallas.py holds the Pallas
bounce against shade_core.  Tolerances: RNG words, alive and missed exact on
>= 99.9 % of lanes — a lane may take the other side of a branch (RR, Fresnel,
an edge) on a last-bit difference of the frameworks' CPU rsqrt/sin/cos —
and radiance within 0.01 on every lane.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from spt_tpu import config as jconfig  # noqa: E402
from spt_tpu import env as jenv  # noqa: E402
from spt_tpu.camera import Camera as JaxCamera  # noqa: E402
from spt_tpu.camera import default_camera as jax_default_camera  # noqa: E402
from spt_tpu.integrators import transport as jtr  # noqa: E402
from spt_tpu.lights import LightManager as JaxLightManager  # noqa: E402
from spt_tpu.lights import default_lights as jax_default_lights  # noqa: E402
from spt_tpu.scene import build_cornell_box_scene, build_default_scene  # noqa: E402
from spt_tpu.scene import flatten_scene  # noqa: E402

from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import interop  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402

CPU = torch.device("cpu")
W = H = 64

PRESETS = {
    "default": {},
    "gpu_parity": None,
    "metal_mirror": {"metal_mirror": True},
    "cpu_transparency": {"cpu_transparency": True,
                         "direct_light_dielectric": True},
    "no_shadow_rays": {"shadow_rays": False, "metal_vndf": False},
}


def _configs(preset):
    if PRESETS[preset] is None:
        return (jconfig.GPU_PARITY.replace(width=W, height=H),
                tconfig.GPU_PARITY.replace(width=W, height=H))
    kw = dict(width=W, height=H, **PRESETS[preset])
    return jconfig.RenderConfig(**kw), tconfig.RenderConfig(**kw)


def _setup(scene_name):
    if scene_name == "cornell":
        js = flatten_scene(build_cornell_box_scene())
        jl = JaxLightManager().device()
        cam = JaxCamera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                        fov_degrees=50.0, aspect_ratio=1.0).rays()
    else:
        js = flatten_scene(build_default_scene())
        jl = jax_default_lights()
        cam = jax_default_camera(W, H).rays()
    return js, jl, cam


def _state_before(jcfg, js, jl, cam, bounce):
    """The JAX package's path state entering `bounce` (kill a block of
    lanes so dead lanes are covered too)."""
    ps = jtr.gen_primary(jcfg, cam, 3)
    ps = ps._replace(alive=ps.alive & (jnp.arange(ps.num_paths) % 7 != 0))
    for b in range(bounce):
        hit = jtr.trace_bounce(js, ps)
        ps, _ = jtr.shade_core(jcfg, js, jl, ps, hit, b, False)
    return ps


def _np3(v):
    return np.stack([np.asarray(c) for c in v], -1)


def _t3(v):
    return torch.stack(list(v), -1).numpy()


def _compare(got, want, got_missed, want_missed):
    rng_ok = got.rng.numpy().astype(np.uint32) == np.asarray(want.rng)
    assert rng_ok.mean() >= 0.999, f"rng differs on {(~rng_ok).sum()} lanes"
    alive_ok = got.alive.numpy() == np.asarray(want.alive)
    assert alive_ok.mean() >= 0.999, f"alive differs on {(~alive_ok).sum()} lanes"
    miss_ok = got_missed.numpy() == np.asarray(want_missed)
    assert miss_ok.mean() >= 0.999
    drad = np.abs(_t3(got.radiance) - _np3(want.radiance)).max(-1)
    assert (drad > 0.01).sum() == 0, f"radiance off on {(drad > 0.01).sum()} lanes"


@pytest.mark.parametrize("scene_name", ["default", "cornell"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("bounce", [0, 3])
def test_shade_core_bounce_matches(scene_name, preset, bounce):
    jcfg, tcfg = _configs(preset)
    js, jl, cam = _setup(scene_name)
    ps = _state_before(jcfg, js, jl, cam, bounce)
    is_last = bounce == 3

    hit = jtr.trace_bounce(js, ps)
    want, want_missed = jtr.shade_core(jcfg, js, jl, ps, hit, bounce, is_last)

    ts, tl = interop.scene(js, CPU), interop.lights(jl, CPU)
    tps = interop.path_state(ps, CPU)
    thit = ttr.trace_bounce(ts, tps)
    got, got_missed = ttr.shade_core(tcfg, ts, tl, tps, thit, bounce, is_last)
    _compare(got, want, got_missed, want_missed)
    assert bool(got.alive.any()) or is_last


def test_shade_adds_environment_to_misses():
    jcfg, tcfg = _configs("default")
    js, jl, cam = _setup("default")
    ps = _state_before(jcfg, js, jl, cam, 1)
    je = jenv.make_hdr_environment(jenv.synthetic_equirect(16))
    want = jtr.shade(jcfg, js, je, jl, ps, jtr.trace_bounce(js, ps), 1, False)
    ts, tl = interop.scene(js, CPU), interop.lights(jl, CPU)
    tps = interop.path_state(ps, CPU)
    got = ttr.shade(tcfg, ts, interop.environment(je, CPU), tl, tps,
                    ttr.trace_bounce(ts, tps), 1, False)
    drad = np.abs(_t3(got.radiance) - _np3(want.radiance)).max(-1)
    assert (drad > 0.01).sum() == 0
