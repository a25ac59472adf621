"""The light loop of ``transport.shade_core`` under many point lights.

The loop shades its lights in groups (``transport.light_group``: (G, N)
planes, G = LIGHT_PLANE // (N * the shadow test's columns), the plane
by device) and adds each
light's term to each lane in light order, so a captured chunk body holds
~1 400 nodes a group and one a light, not the ~1 400 a light that the
default scene's unrolled shadow test launched one light at a time
(ROADMAP.md section 3, fault 3: a captured compact frame whose two chunk
bodies held ~1.5 million nodes each failed on the card).

On the CPU:
- the grouped loop against the JAX package's ``shade_core`` from the same
  path state under a row of point lights (``chip_smoke.light_row``): the
  default scene under 1 200 without shadow rays, in groups of 500, 500
  and 200, and ``chip_smoke.sphere_field`` (200 spheres: the chunked
  any-hit) under 300 with them, in groups of 128, 128 and 44 (JAX's eager
  light loop takes ~20 ms a light there); the lanes' RNG words, alive and
  missed flags on >= 99.9 % of lanes (a lane may take the other side of a
  branch on a last-bit difference of the frameworks' CPU transcendentals,
  as in tests/test_torch_transport.py), radiance within 1 % relative RMSE
  (the many-light gate of tests/test_torch_tables.py);
- the grouped loop bit for bit with one light a group and with ragged
  groups, every plane, shadow rays on (the default scene's unrolled
  any-hit);
- the compact chunk body's launches under 1 200 lights at 128 x 128
  (depth 2: one chunk loop), counted as the aten calls that make a kernel
  on the card; and, with LIGHT_PLANE set so that the small frame's
  body takes the groups of a 1920 x 1080 frame's (a body's launches depend
  on its groups, not its lanes), the compact chunk body's and the regen
  body's at 1920 x 1080 on the card, each frame's bodies in all (compact d6: five
  chunk loops) well under ``cuda_graph.MAX_BODY_NODES``;
- one light a group, its launches with the default scene's shadow test
  unrolled and through the chunked route: hundreds either way, so the
  groups, not the route, keep the bodies small.
"""

import collections

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
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402

CPU = torch.device("cpu")
ROW = dict(start=(-6.0, 3.0, 1.0), step=(0.01, 0.0, 0.0), intensity=0.01)


def _planes(ps, missed):
    return [*ps.origin, *ps.direction, *ps.throughput, *ps.radiance, ps.rng,
            ps.alive, ps.emission_ok, missed]


def _same(a, b):
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("scene_name, n, group", [("default", 1200, 500),
                                                   ("spheres", 300, 128)])
def test_grouped_light_loop_matches_jax_shade_core(monkeypatch, scene_name, n,
                                                   group):
    pytest.importorskip("jax")
    from spt_tpu import camera as jcamera
    from spt_tpu import config as jconfig
    from spt_tpu import lights as jlights
    from spt_tpu import scene as jscene
    from spt_tpu.integrators import transport as jtr
    from spt_tpu_torch import interop

    w = h = 16
    kw = dict(width=w, height=h, shadow_rays=scene_name == "spheres")
    jcfg, tcfg = jconfig.RenderConfig(**kw), tconfig.RenderConfig(**kw)
    if scene_name == "default":
        js = jscene.flatten_scene(jscene.build_default_scene())
        cam = jcamera.default_camera(w, h).rays()
    else:
        js = jscene.flatten_scene(chip_smoke.sphere_field(jscene))
        cam = jcamera.Camera(aspect_ratio=1.0,
                             **chip_smoke.SPHERE_POSE).rays()
    jl = chip_smoke.light_row(jlights.LightManager(), n, **ROW).device()
    ps = jtr.gen_primary(jcfg, cam, 3)
    hit = jtr.trace_bounce(js, ps)
    want, want_missed = jtr.shade_core(jcfg, js, jl, ps, hit, 0, False)

    ts, tl = interop.scene(js, CPU), interop.lights(jl, CPU)
    tps = interop.path_state(ps, CPU)
    # groups of 500, 500 and 200 lights (128, 128 and 44) on these lanes;
    # the sphere field's shadow test is chunked, CHUNK_SIZE columns
    cols = ttr.isect.occluded_columns(ts, CPU) if kw["shadow_rays"] else 1
    assert cols == (128 if scene_name == "spheres" else 1)
    monkeypatch.setitem(ttr.LIGHT_PLANE, "cpu", group * w * h * cols)
    assert ttr.light_group(tl, w * h, cols, CPU) == group
    got, got_missed = ttr.shade_core(tcfg, ts, tl, tps,
                                     ttr.trace_bounce(ts, tps), 0, False)
    for a, b in ((got.rng.numpy().astype(np.uint32), np.asarray(want.rng)),
                 (got.alive.numpy(), np.asarray(want.alive)),
                 (got_missed.numpy(), np.asarray(want_missed))):
        assert (a == b).mean() >= 0.999
    g = torch.stack(list(got.radiance), -1).numpy()
    wr = np.stack([np.asarray(c) for c in want.radiance], -1)
    assert np.abs(wr).max() > 0.0
    assert np.sqrt(np.mean((g - wr) ** 2) / np.mean(wr ** 2)) < 0.01


def test_grouped_light_loop_keeps_the_per_light_bits(monkeypatch):
    # shadow rays on the default scene: its 20 primitives' unrolled any-hit
    # on (G * N) lanes; one light a group is the loop before grouping
    w = h = 32
    cfg = tconfig.RenderConfig(width=w, height=h)
    scene = tscene.flatten_scene(tscene.build_default_scene(), CPU)
    lights = chip_smoke.light_row(tlights.LightManager(), 150,
                                  **ROW).device(CPU)
    ps = ttr.gen_primary(cfg, tcamera.default_camera(w, h).rays(CPU), 2)
    hit = ttr.trace_bounce(scene, ps)
    runs = []
    for group in (1, 7, 150):
        monkeypatch.setitem(ttr.LIGHT_PLANE, "cpu", group * w * h)
        assert ttr.light_group(lights, w * h, device=CPU) == group
        runs.append(_planes(*ttr.shade_core(cfg, scene, lights, ps, hit, 0,
                                            False)))
    assert bool(runs[0][9].abs().max() > 0)
    for other in runs[1:]:
        assert all(_same(a, b) for a, b in zip(runs[0], other))


# aten calls that make no kernel on the card (views and metadata)
_NO_KERNEL = {"aten.select.int", "aten.slice.Tensor", "aten.view.default",
              "aten.alias.default", "aten.expand.default",
              "aten.unsqueeze.default", "aten._unsafe_view.default",
              "aten.detach.default", "aten.unbind.int",
              "aten.reshape.default", "aten.squeeze.dim",
              "aten.permute.default", "aten.transpose.int",
              "aten.as_strided.default", "aten.t.default",
              "aten.lift_fresh.default", "aten.scalar_tensor.default"}


def _body_launches(monkeypatch, integrator, w, h, n, plane=None):
    """The launches of each run of the frame's WHILE body (the compact
    chunk loop, the regen step) of the default scene under n lights at w x
    h, depth 2, with the CPU's LIGHT_PLANE `plane` (None: as it is)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func) not in _NO_KERNEL:
                self.calls[str(func)] += 1
            return func(*args, **(kwargs or {}))

    bodies = []
    loop = twf._while_loop

    def counted(cond_fn, body_fn, carry):
        def body(c):
            with Count() as m:
                out = body_fn(c)
            bodies.append(sum(m.calls.values()))
            return out

        body.__name__ = body_fn.__name__
        return loop(cond_fn, body, carry)

    monkeypatch.setattr(twf, "_while_loop", counted)
    if plane is not None:
        monkeypatch.setitem(ttr.LIGHT_PLANE, "cpu", plane)
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=2,
                               integrator=integrator)
    r = Renderer(tscene.build_default_scene(), cfg,
                 lights=chip_smoke.light_row(tlights.LightManager(), n,
                                             **ROW).device(CPU),
                 camera=tcamera.default_camera(w, h), device=CPU)
    frame_chain(r.cfg, r.scene, r.env, r.lights, r.camera.rays(CPU), r.state,
                1)
    assert bodies
    return r, bodies


def test_chunk_body_launches_under_many_lights(monkeypatch):
    n = 1200
    r, bodies = _body_launches(monkeypatch, "compact", 128, 128, n)
    w = twf._queue_width(128 * 128)
    groups = -(-n // ttr.light_group(r.lights, w, device=CPU))
    # one add a light, the rest a group: the failing bodies held ~1 400 a
    # light (~1.7 million)
    assert max(bodies) < n + groups * 2000
    assert max(bodies) < 20000


@pytest.mark.parametrize("integrator, w, h, lanes, loops", [
    # the compact chunk (a quarter of the frame's lanes), d6: five loops
    ("compact", 128, 128, twf._queue_width(1920 * 1080), 5),
    # the regen step over every lane of the frame: one loop
    ("regen", 32, 32, 1920 * 1080, 1)])
def test_bodies_of_a_1080p_frame_stay_under_the_node_limit(
        monkeypatch, integrator, w, h, lanes, loops):
    from spt_tpu_torch.ops import cuda_graph

    n = 1200
    lights = chip_smoke.light_row(tlights.LightManager(), n,
                                  **ROW).device(CPU)
    group = ttr.light_group(lights, lanes)
    small = twf._queue_width(w * h) if integrator == "compact" else w * h
    # the small frame's body in the card's 1080p body's groups: 32 lights
    # (38 groups) in the compact chunk, 8 (150) in the regen step
    assert (group, small) == ({"compact": 32, "regen": 8}[integrator],
                              {"compact": 8192, "regen": 1024}[integrator])
    r, bodies = _body_launches(monkeypatch, integrator, w, h, n,
                               plane=group * small)
    assert ttr.light_group(r.lights, small, device=CPU) == group
    groups = -(-n // group)
    assert max(bodies) < n + groups * 2000
    # the faulting graph held ~3 million nodes in two bodies
    assert loops * max(bodies) < cuda_graph.MAX_BODY_NODES // 4


def test_a_light_alone_costs_hundreds_of_launches(monkeypatch):
    # why the loop groups its lights rather than only taking the default
    # scene's shadow test through the chunked route: one light a group
    # launches ~1 400 kernels with the unrolled test and still ~300 with
    # the chunked one (the light sample and the BRDF), so 1 200 lights in
    # the five chunk bodies of a d6 compact frame come near
    # MAX_BODY_NODES either way
    from torch.utils._python_dispatch import TorchDispatchMode

    from spt_tpu_torch.ops import cuda_graph
    from spt_tpu_torch.ops import intersect as isect

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls += str(func) not in _NO_KERNEL
            return func(*args, **(kwargs or {}))

    w = h = 16
    cfg = tconfig.RenderConfig(width=w, height=h)
    scene = tscene.flatten_scene(tscene.build_default_scene(), CPU)
    ps = ttr.gen_primary(cfg, tcamera.default_camera(w, h).rays(CPU), 2)
    hit = ttr.trace_bounce(scene, ps)
    monkeypatch.setitem(ttr.LIGHT_PLANE, "cpu", w * h)

    def per_light():
        calls = []
        for n in (10, 20):
            lights = chip_smoke.light_row(tlights.LightManager(), n,
                                          **ROW).device(CPU)
            with Count() as m:
                ttr.shade_core(cfg, scene, lights, ps, hit, 0, False)
            calls.append(m.calls)
        return (calls[1] - calls[0]) / 10

    unrolled = per_light()
    monkeypatch.setattr(isect, "_occluded_unrolled",
                        lambda s, o, d, tmin, tmax: isect._occluded_chunked(
                            s, o, d, tmin, tmax))
    chunked = per_light()
    assert unrolled > 1000
    assert 200 < chunked < unrolled / 3
    assert 5 * 1200 * chunked > 0.8 * cuda_graph.MAX_BODY_NODES
