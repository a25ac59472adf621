"""The port's lax.while_loop (integrators/wavefront ``_while_loop``) and the
loops built on it: the compact path's chunks on a device counter and path
regeneration.

On the CPU: ``_while_loop``'s eager semantics (no iteration, the carry in
buffers of the loop's own updated in place, a carry whose planes share one
tensor, a body that swaps two planes, a body of other shapes refused); the
compact loop bit for bit with the loop it replaces, which read the live
count to the host once a bounce (kept here as ``_host_read_compact``):
every plane of the final path state, the rays per bounce and bounces_run,
on a scene whose bounces need several chunks, on the default scene and on
one whose paths all end at bounce 0; against the JAX package's compact
path at the tolerance of
``test_torch_compaction.py::test_compact_matches_jax_compact`` (relative
RMSE < 1 %, rays per bounce within 0.5 %: float rounding may send a rare
lane the other way at a branch); path regeneration against the JAX
package's ``render_wavefront_regen`` at the same tolerance.
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
from spt_tpu_torch.ops.compaction import (compact_gather,  # noqa: E402
                                          compact_indices, scatter_back)
from spt_tpu_torch.ops.vec3 import Vec3  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def J():
    pytest.importorskip("jax")
    from spt_tpu import camera, config, env, lights, scene
    from spt_tpu.integrators import wavefront

    return types.SimpleNamespace(camera=camera, config=config, env=env,
                                 lights=lights, scene=scene, wf=wavefront)


def _same(a, b):
    """Bit for bit: float tensors compared as their int32 words."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


# --- _while_loop -------------------------------------------------------------------

def test_while_loop_no_iteration_returns_a_copy():
    x = torch.arange(4.0)
    calls = []

    def body(c):
        calls.append(1)
        return c + 1

    out = twf._while_loop(lambda c: c.sum() < 0, body, x)
    assert not calls
    assert _same(out, x) and out.data_ptr() != x.data_ptr()


def test_while_loop_updates_its_own_carry_in_place():
    # the body sees the same tensors at every run and the loop returns
    # them; the caller's tensors are left as they were
    x, n = torch.tensor([1.0, 2.0, 3.0]), torch.zeros((), dtype=torch.int64)
    seen = []

    def body(c):
        k, v = c
        seen.append((k.data_ptr(), v.data_ptr()))
        return k + 1, v * 2.0

    k, v = twf._while_loop(lambda c: c[0] < 5, body, (n, x))
    assert len(seen) == 5 and len(set(seen)) == 1
    assert seen[0] == (k.data_ptr(), v.data_ptr())
    assert int(k) == 5 and _same(v, torch.tensor([32.0, 64.0, 96.0]))
    assert int(n) == 0 and _same(x, torch.tensor([1.0, 2.0, 3.0]))


def test_while_loop_carry_of_one_shared_tensor():
    # _zeros3 hands one tensor for all three planes: the loop's buffers are
    # three, so each plane keeps its own value
    z = torch.zeros(3)
    out = twf._while_loop(lambda c: c.x.sum() < 3,
                          lambda c: Vec3(c.x + 1, c.y + 2, c.z + 3),
                          Vec3(z, z, z))
    assert [float(t[0]) for t in out] == [1.0, 2.0, 3.0]
    assert len({t.data_ptr() for t in out}) == 3 and float(z.sum()) == 0.0


def test_while_loop_body_that_swaps_planes():
    # a body returning one buffer in another's place: read before written
    a, b = torch.tensor([1.0]), torch.tensor([2.0])
    out = twf._while_loop(lambda c: c[2] < 3, lambda c: (c[1], c[0], c[2] + 1),
                          (a, b, torch.zeros((), dtype=torch.int64)))
    assert (float(out[0]), float(out[1]), int(out[2])) == (2.0, 1.0, 3)


def test_while_loop_refuses_a_body_of_other_shapes():
    with pytest.raises(ValueError, match="shapes or dtypes"):
        twf._while_loop(lambda c: c.sum() < 10,
                        lambda c: torch.cat([c, c]), torch.ones(2))
    with pytest.raises(ValueError, match="shapes or dtypes"):
        twf._while_loop(lambda c: c.sum() < 10, lambda c: c.double() + 1,
                        torch.ones(2))


# --- the compact loop ---------------------------------------------------------------

def _host_read_compact(cfg, scene, env, lights, ps):
    """The compact loop as it was: the live count read to the host once a
    bounce, the chunks launched from a host loop, a break at the first
    bounce with no live lane.  Returns (PathState, rays, bounces_run)."""
    n = ps.num_paths
    rays = torch.zeros(cfg.max_depth, dtype=torch.int64)
    rays[0] = n
    ps = twf._bounce(cfg, scene, env, lights, ps, 0, cfg.max_depth == 1,
                     fused=True)
    w = twf._queue_width(n)
    pad = torch.full(((n + w - 1) // w * w - n,), n, dtype=torch.int64)
    lane = torch.arange(w)
    bounce = 1
    while bounce < cfg.max_depth:
        queue, count = compact_indices(ps.alive)
        live = int(count)
        if live == 0:
            break
        rays[bounce] = count
        queue = torch.cat([queue, pad])
        is_last = bounce == cfg.max_depth - 1
        for start in range(0, live, w):
            idx = queue[start:start + w]
            valid = (start + lane) < live
            sub = compact_gather(ps, idx)
            sub = sub._replace(alive=sub.alive & valid)
            sub = twf._bounce(cfg, scene, env, lights, sub, bounce, is_last)
            ps = scatter_back(sub, idx, ps, live - start)
        bounce += 1
    return ps, rays, bounce


def _compact_case(case, w=160, h=120):
    if case == "cornell_inside":
        # every lane survives bounce 0: bounce 1 needs several chunks
        cam = tcamera.Camera(position=(0, 2.75, 2.5), target=(0, 2.75, 0.0),
                             fov_degrees=70.0, aspect_ratio=w / h)
        return (tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=3),
                tscene.build_cornell_box_scene(), tlights.LightManager(),
                cam)
    if case == "default":
        cam = tcamera.default_camera(w, h)
    else:
        # looking at the sky: every path ends at bounce 0
        cam = tcamera.Camera(position=(0, 50.0, 0), target=(0.2, 100.0, 1.0),
                             aspect_ratio=w / h)
    return (tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=5),
            tscene.build_default_scene(), None, cam)


@pytest.mark.parametrize("case", ["cornell_inside", "default", "sky"])
def test_compact_loop_matches_the_host_read_loop(case):
    cfg, desc, lm, cam = _compact_case(case)
    scene = tscene.flatten_scene(desc, CPU)
    env = tenv.make_procedural_environment(CPU)
    lights = lm.device(CPU) if lm is not None else tlights.default_lights(CPU)
    ps0 = ttr.gen_primary(cfg, cam.rays(CPU), 0)
    want, want_rays, want_bounces = _host_read_compact(cfg, scene, env,
                                                       lights, ps0)
    got, rays = twf._compact_loop(cfg, scene, env, lights, ps0)
    for name, g, w in zip(("origin", "direction", "throughput", "radiance",
                           "rng", "alive", "emission_ok"), got, want):
        for gt, wt in zip(twf._tensors(g), twf._tensors(w)):
            assert _same(gt, wt), name
    assert _same(rays, want_rays)
    _, stats = twf._wavefront_compact(cfg, scene, env, lights, ps0)
    assert _same(stats.rays_per_bounce, want_rays)
    assert int(stats.bounces_run) == want_bounces
    if case == "sky":
        assert want_bounces == 1 and int(rays[1:].sum()) == 0
    if case == "cornell_inside":
        assert int(rays[1]) > twf._queue_width(cfg.width * cfg.height)


def test_compact_loop_matches_jax_compact_across_chunks(J):
    # the JAX package's compact path on the scene whose bounces take
    # several chunks
    w, h = 160, 120
    kw = dict(width=w, height=h, spp=1, max_depth=3, integrator="compact")
    pose = dict(position=(0, 2.75, 2.5), target=(0, 2.75, 0.0),
                fov_degrees=70.0, aspect_ratio=w / h)
    want, jstats = J.wf.render_wavefront(
        J.config.RenderConfig(**kw),
        J.scene.flatten_scene(J.scene.build_cornell_box_scene()),
        J.env.make_procedural_environment(), J.lights.LightManager().device(),
        J.camera.Camera(**pose).rays(), 0)
    got, tstats = twf.render_wavefront(
        tconfig.RenderConfig(**kw),
        tscene.flatten_scene(tscene.build_cornell_box_scene(), CPU),
        tenv.make_procedural_environment(CPU),
        tlights.LightManager().device(CPU),
        tcamera.Camera(**pose).rays(CPU), 0)
    assert int(tstats.rays_per_bounce[1]) > twf._queue_width(w * h)
    assert _rel_rmse(got.numpy(), np.asarray(want)) < 0.01
    np.testing.assert_allclose(tstats.rays_per_bounce.numpy(),
                               np.asarray(jstats.rays_per_bounce), rtol=5e-3)
    assert int(tstats.bounces_run) == int(jstats.bounces_run)


# --- path regeneration --------------------------------------------------------------

def test_regen_loop_matches_jax_regen(J):
    w, h = 96, 64
    kw = dict(width=w, height=h, spp=2, max_depth=4, integrator="regen")
    want, jstats = J.wf.render_wavefront_regen(
        J.config.RenderConfig(**kw),
        J.scene.flatten_scene(J.scene.build_default_scene()),
        J.env.make_procedural_environment(), J.lights.default_lights(),
        J.camera.default_camera(w, h).rays(), 3)
    got, tstats = twf.render_wavefront_regen(
        tconfig.RenderConfig(**kw),
        tscene.flatten_scene(tscene.build_default_scene(), CPU),
        tenv.make_procedural_environment(CPU), tlights.default_lights(CPU),
        tcamera.default_camera(w, h).rays(CPU), 3)
    assert got.shape == (h, w, 3)
    assert _rel_rmse(got.numpy(), np.asarray(want)) < 0.01
    np.testing.assert_allclose(tstats.rays_per_bounce.numpy(),
                               np.asarray(jstats.rays_per_bounce), rtol=5e-3)
    # the iterations the loop ran: bounded by spp * max_depth
    assert 0 < int(tstats.bounces_run) <= 2 * 4
    assert int(tstats.bounces_run) == int(jstats.bounces_run)


def test_while_loop_counts_its_body_runs():
    saved = twf.launch_counts()
    try:
        twf.LOOP_RUNS.clear()

        def grow(c):
            return c + 1

        twf._while_loop(lambda c: c < 3, grow,
                        torch.zeros((), dtype=torch.int64))
        twf._while_loop(lambda c: c < 0, grow,
                        torch.zeros((), dtype=torch.int64))
        assert twf.launch_counts()[("loop", "grow")] == 3
    finally:
        twf._set_counts(saved)
