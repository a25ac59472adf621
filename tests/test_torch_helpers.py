"""The port's single-ray and (N, 3) helpers against the JAX package's.

Each helper of ``spt_tpu_torch`` that no render path calls (ops/math3d,
ops/sampling's array forms, ops/intersect ``intersect`` / ``occluded`` /
``safe_origin``, lights ``sample_light``, env ``environment_color`` /
``procedural_sky`` / ``sample_equirect``, camera ``ray_directions`` /
``get_ray_direction``, materials ``gather``, ops/vec3 ``lerp``, ops/bvh
``slab_test``,
ops/tonemap ``aces_gamma_per_sample`` / ``to_u8``) runs on the same
numpy-seeded inputs as its JAX counterpart.  Tolerance, per case: bit for
bit where both evaluate the same float32 operations in the same order
(ulps 0); else within that many float32 ulps of the larger of |value| and
1: 2 where XLA's CPU code fuses what the port runs op by op (a 3-term
sum under a square root in ``length`` and ``refract``, a * b - c * d
contracted into a fused multiply-add in ``cross`` and the bases built on
it), 2-8 where a transcendental (sin, cos, pow) enters, 64 for the equirect lookups, whose atan2 / acos ulp moves a
texel weight by the map's width times that and the sample by the texels'
contrast times that (16 texels, values up to 9).  Then the known answers
of the JAX package's own tests (test_math_ops.py, test_env.py,
test_camera.py, test_intersect.py, test_scene.py:138), on the port alone.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from spt_tpu import camera as jcamera  # noqa: E402
from spt_tpu import env as jenv  # noqa: E402
from spt_tpu import lights as jlights  # noqa: E402
from spt_tpu import materials as jmaterials  # noqa: E402
from spt_tpu import scene as jscene  # noqa: E402
from spt_tpu.ops import bvh as jbvh  # noqa: E402
from spt_tpu.ops import intersect as jisect  # noqa: E402
from spt_tpu.ops import math3d as jm3  # noqa: E402
from spt_tpu.ops import sampling as jsampling  # noqa: E402
from spt_tpu.ops import tonemap as jtonemap  # noqa: E402
from spt_tpu.ops import vec3 as jvec3  # noqa: E402

from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import env as tenv  # noqa: E402
from spt_tpu_torch import lights as tlights  # noqa: E402
from spt_tpu_torch import materials as tmaterials  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.ops import bvh as tbvh  # noqa: E402
from spt_tpu_torch.ops import intersect as tisect  # noqa: E402
from spt_tpu_torch.ops import math3d as tm3  # noqa: E402
from spt_tpu_torch.ops import rng as rng_ops  # noqa: E402
from spt_tpu_torch.ops import sampling as tsampling  # noqa: E402
from spt_tpu_torch.ops import tonemap as ttonemap  # noqa: E402
from spt_tpu_torch.ops import vec3 as tvec3  # noqa: E402

CPU = torch.device("cpu")
N = 256


def _lights(mod, dev):
    lm = mod.LightManager()
    lm.add_directional_light([-0.5, -1.0, 0.3], [1.0, 0.95, 0.8], 2.0)
    lm.add_point_light([0.5, 3.0, 1.0], [0.9, 0.8, 1.0], 4.0)
    return lm.device() if dev is None else lm.device(dev)


def _tri_sphere_scene(mod):
    """Two triangles and two spheres (the unrolled route)."""
    d = mod.SceneDesc()
    d.add_material(mod.Material())
    d.add_material(mod.Material([0.2, 0.4, 0.9]))
    d.add_instance(d.add_mesh(mod.MeshData(
        positions=np.array([[-1, -1, -2], [1, -1, -2], [0, 1, -2],
                            [-2, -1, -3], [2, -1, -3], [0, -1, 1]],
                           np.float32),
        indices=np.array([[0, 1, 2], [3, 4, 5]], np.uint32))))
    d.add_sphere([0.0, 0.0, -5.0], 2.0, 1)
    d.add_sphere([1.5, 0.5, -1.5], 0.4, 0)
    return d


def _pkgs():
    """The JAX and port sides: modules and an array maker each."""
    j = types.SimpleNamespace(
        m3=jm3, sampling=jsampling, tonemap=jtonemap, env=jenv, vec3=jvec3,
        isect=jisect, materials=jmaterials, lights=jlights, bvh=jbvh,
        arr=lambda a: jnp.asarray(a), out=np.asarray,
        scene=lambda d: jscene.flatten_scene(d), light_table=_lights(
            jlights, None), rays=lambda cam: cam.rays(),
        hdr=lambda img: jenv.make_hdr_environment(img, intensity=0.8,
                                                  max_clamp=5.0),
        sky=jenv.make_procedural_environment, Camera=jcamera.Camera,
        smod=jscene, mat_table=lambda: jmaterials.build_device_materials(
            jmaterials.default_materials()))
    t = types.SimpleNamespace(
        m3=tm3, sampling=tsampling, tonemap=ttonemap, env=tenv, vec3=tvec3,
        isect=tisect, materials=tmaterials, lights=tlights, bvh=tbvh,
        arr=lambda a: torch.as_tensor(np.asarray(a)),
        out=lambda a: a.numpy(),
        scene=lambda d: tscene.flatten_scene(d, CPU),
        light_table=_lights(tlights, CPU), rays=lambda cam: cam.rays(CPU),
        hdr=lambda img: tenv.make_hdr_environment(img, CPU, 0.8, 5.0),
        sky=lambda: tenv.make_procedural_environment(CPU),
        Camera=tcamera.Camera, smod=tscene,
        mat_table=lambda: tmaterials.build_device_materials(
            tmaterials.default_materials(), CPU))
    return j, t


def _inputs(seed=7):
    rng = np.random.default_rng(seed)

    def unit(n=N):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    return dict(
        a=rng.normal(size=(N, 3)).astype(np.float32),
        b=rng.normal(size=(N, 3)).astype(np.float32),
        n=unit(), v=unit(), l=unit(),
        z=np.where(rng.random((N, 1)) < 0.25, 0.0,
                   rng.normal(size=(N, 3))).astype(np.float32),
        u1=rng.random(N).astype(np.float32),
        u2=rng.random(N).astype(np.float32),
        s=rng.random(N).astype(np.float32),
        eta=rng.choice(np.float32([1 / 1.5, 1.5, 1.0, 1 / 1.33]), N),
        alpha=rng.uniform(0.0004, 1.0, N).astype(np.float32),
        col=rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32),
        met=rng.choice(np.float32([0.0, 0.3, 1.0]), N),
        rough=rng.uniform(0.01, 1.0, N).astype(np.float32),
        ior=rng.uniform(1.0, 2.0, N).astype(np.float32),
        hdr=rng.uniform(0.0, 8.0, (N, 3)).astype(np.float32),
        xy=rng.random((2, N)).astype(np.float32),
        p=rng.uniform(-3.0, 3.0, (N, 3)).astype(np.float32),
        mid=rng.integers(-3, 12, N).astype(np.int32),
        img=rng.uniform(0.0, 9.0, (8, 16, 3)).astype(np.float32),
        o=np.concatenate([rng.uniform(-0.5, 0.5, (N, 2)),
                          np.zeros((N, 1))], 1).astype(np.float32),
        front=rng.random(N) < 0.5,
    )


def _ray_set(P, x):
    """Camera rays toward the scene of _tri_sphere_scene, as (N, 3)."""
    d = x["v"].copy()
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    return P.arr(x["o"]), P.m3.safe_normalize(P.arr(d))


# name -> (call(P, x) -> array or tuple, ulps)
CASES = {
    "dot": (lambda P, x: P.m3.dot(P.arr(x["a"]), P.arr(x["b"])), 0),
    "cross": (lambda P, x: P.m3.cross(P.arr(x["a"]), P.arr(x["b"])), 2),
    "length": (lambda P, x: P.m3.length(P.arr(x["a"])), 2),
    "safe_normalize": (lambda P, x: P.m3.safe_normalize(P.arr(x["z"])), 0),
    "normalize_or": (lambda P, x: P.m3.normalize_or(
        P.arr(x["z"]), P.arr(x["n"])), 0),
    "reflect": (lambda P, x: P.m3.reflect(P.arr(x["v"]), P.arr(x["n"])), 0),
    "refract": (lambda P, x: P.m3.refract(
        P.arr(x["v"]), P.arr(x["n"]), P.arr(x["eta"])), 2),
    "make_onb": (lambda P, x: P.m3.make_onb(P.arr(x["n"])), 2),
    "from_onb": (lambda P, x: P.m3.from_onb(
        *P.m3.make_onb(P.arr(x["n"])), P.arr(x["n"]), P.arr(x["a"])), 2),
    "faceforward": (lambda P, x: P.m3.faceforward(
        P.arr(x["n"]), P.arr(x["v"])), 0),
    "luminance_max": (lambda P, x: P.m3.luminance_max(P.arr(x["a"])), 0),
    "fresnel_schlick": (lambda P, x: P.sampling.fresnel_schlick(
        P.arr(x["s"]), P.arr(x["col"])), 0),
    "fresnel_schlick_ior": (lambda P, x: P.sampling.fresnel_schlick_ior(
        P.arr(x["s"] * 2.0 - 0.5), P.arr(x["ior"])), 0),
    "evaluate_brdf": (lambda P, x: P.sampling.evaluate_brdf(
        P.arr(x["n"]), P.arr(x["v"]), P.arr(x["l"]), P.arr(x["col"]),
        P.arr(x["met"]), P.arr(x["rough"]), P.arr(x["ior"])), 4),
    "cosine_hemisphere_local": (
        lambda P, x: P.sampling.cosine_hemisphere_local(
            P.arr(x["u1"]), P.arr(x["u2"])), 2),
    "cosine_sample": (lambda P, x: P.sampling.cosine_sample(
        P.arr(x["n"]), P.arr(x["u1"]), P.arr(x["u2"])), 4),
    "ggx_sample_half_vector": (lambda P, x: P.sampling.ggx_sample_half_vector(
        P.arr(x["u1"]), P.arr(x["u2"]), P.arr(x["alpha"]), P.arr(x["n"])), 4),
    "ggx_sample_vndf": (lambda P, x: P.sampling.ggx_sample_vndf(
        P.arr(x["u1"]), P.arr(x["u2"]), P.arr(x["alpha"]), P.arr(x["n"]),
        P.arr(x["v"])), 8),
    "aces_gamma_per_sample": (lambda P, x: P.tonemap.aces_gamma_per_sample(
        P.arr(x["hdr"])), 2),
    "to_u8": (lambda P, x: P.tonemap.to_u8(P.arr(x["s"] * 1.2 - 0.1)), 0),
    "lerp": (lambda P, x: P.vec3.lerp(
        P.vec3.Vec3.from_array(P.arr(x["a"])),
        P.vec3.Vec3.from_array(P.arr(x["b"])), P.arr(x["s"])), 0),
    "procedural_sky": (lambda P, x: P.env.procedural_sky(P.arr(x["v"])), 2),
    "sample_equirect": (lambda P, x: P.env.sample_equirect(
        P.arr(x["img"]), P.arr(x["v"])), 64),
    "environment_color_hdr": (lambda P, x: P.env.environment_color(
        P.hdr(x["img"]), P.arr(x["a"])), 64),
    "environment_color_sky": (lambda P, x: P.env.environment_color(
        P.sky(), P.arr(x["a"])), 2),
    "sample_light_directional": (lambda P, x: P.lights.sample_light(
        P.light_table, 0, P.arr(x["p"])), 0),
    "sample_light_point": (lambda P, x: P.lights.sample_light(
        P.light_table, 1, P.arr(x["p"])), 2),
    "ray_directions": (lambda P, x: P.rays(P.Camera(
        aspect_ratio=4 / 3)).ray_directions(
            P.arr(x["xy"][0]), P.arr(x["xy"][1])), 2),
    "gather": (lambda P, x: tuple(P.materials.gather(
        P.mat_table(), P.arr(x["mid"]))), 0),
    "intersect": (lambda P, x: tuple(P.isect.intersect(
        P.scene(_tri_sphere_scene(P.smod)), *_ray_set(P, x), tmin=0.0)), 0),
    "occluded": (lambda P, x: P.isect.occluded(
        P.scene(_tri_sphere_scene(P.smod)), *_ray_set(P, x), tmin=0.0,
        tmax=P.arr(x["s"] * 6.0)), 0),
    "safe_origin": (lambda P, x: P.isect.safe_origin(
        P.arr(x["p"] * 100.0), P.arr(x["n"]), P.arr(x["front"])), 0),
    "slab_test": (lambda P, x: P.bvh.slab_test(
        P.arr(x["a"][0] - 1.0), P.arr(x["a"][0] + 1.0),
        P.vec3.Vec3.from_array(P.arr(x["p"])),
        P.vec3.Vec3.from_array(1.0 / P.arr(x["v"])), 0.0,
        P.arr(x["s"] * 8.0)), 0),
}


def _flat(out, P):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o, P)]
    if isinstance(out, (tvec3.Vec3, jvec3.Vec3)):
        return [P.out(c) for c in out]
    return [np.asarray(P.out(out))]


def _ulps_ok(got, want, ulps):
    if got.dtype != np.float32:
        return np.array_equal(got, want)
    if ulps == 0:
        return np.array_equal(got.view(np.int32), want.view(np.int32))
    scale = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    return bool(np.all(np.abs(got.astype(np.float64) - want) <= ulps * scale))


@pytest.mark.parametrize("name", list(CASES))
def test_helper_matches_jax(name):
    call, ulps = CASES[name]
    x = _inputs()
    j, t = _pkgs()
    want, got = _flat(call(j, x), j), _flat(call(t, x), t)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if g.dtype == np.float32 and w.dtype == np.float32:
            assert _ulps_ok(g, w, ulps), (k, float(np.abs(g - w).max()))
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w)


def test_get_ray_direction_matches_jax_and_the_batched_form():
    pose = dict(position=(0.0, 3.0, 8.0), target=(0.0, 1.0, 0.0),
                fov_degrees=60.0, aspect_ratio=4 / 3)
    jc, tc = jcamera.Camera(**pose), tcamera.Camera(**pose)
    xy = np.random.default_rng(5).random((16, 2))
    rays = tc.rays(CPU)
    for x, y in xy:
        got = tc.get_ray_direction(float(x), float(y))
        np.testing.assert_array_equal(got, jc.get_ray_direction(float(x),
                                                                float(y)))
        batched = rays.ray_directions(torch.tensor([x], dtype=torch.float32),
                                      torch.tensor([y], dtype=torch.float32))
        np.testing.assert_allclose(batched[0].numpy(), got, atol=1e-6)
    np.testing.assert_allclose(tc.get_ray_direction(0.5, 0.5), tc.forward,
                               atol=1e-6)
    assert tc.get_ray_direction(0.5, 0.25) @ tc.up > 0
    assert tc.get_ray_direction(0.5, 0.75) @ tc.up < 0


# --- the JAX package's own known answers, on the port ----------------------------

def _t(*rows):
    return torch.tensor(rows, dtype=torch.float32)


def _one_scene(*spheres, tri=False):
    d = tscene.SceneDesc()
    d.add_material(tscene.Material())
    if tri:
        d.add_instance(d.add_mesh(tscene.MeshData(
            positions=np.array([[-1, -1, -2], [1, -1, -2], [0, 1, -2]],
                               np.float32),
            indices=np.array([[0, 1, 2]], np.uint32))))
    for c, r in spheres:
        d.add_sphere(c, r, 0)
    return tscene.flatten_scene(d, CPU)


def _known_math():
    i = _t([1.0, -1.0, 0.0]) / np.sqrt(2)
    n = _t([0.0, 1.0, 0.0])
    np.testing.assert_allclose(tm3.reflect(i, n)[0].numpy(),
                               [1 / np.sqrt(2), 1 / np.sqrt(2), 0], atol=1e-6)
    t, can = tm3.refract(i, n, torch.tensor([1 / 1.5]))
    assert bool(can[0])
    np.testing.assert_allclose(float(t[0, 0]), np.sin(np.pi / 4) / 1.5,
                               atol=1e-6)
    _, can = tm3.refract(tm3.safe_normalize(_t([0.99, -0.14106736, 0.0])), n,
                         torch.tensor([1.5]))
    assert not bool(can[0])
    assert torch.all(tm3.safe_normalize(torch.zeros(4, 3)) == 0)
    fb = tm3.normalize_or(torch.zeros(4, 3), torch.tensor([0.0, 1.0, 0.0]))
    assert torch.equal(fb, torch.tensor([[0.0, 1.0, 0.0]] * 4))
    nn = tm3.safe_normalize(torch.randn(128, 3, generator=torch.Generator()
                                        .manual_seed(3)))
    tb, bb = tm3.make_onb(nn)
    for a, b in ((tb, nn), (bb, nn), (tb, bb)):
        assert float(tm3.dot(a, b).abs().max()) < 1e-5
    np.testing.assert_allclose(tm3.length(tb).numpy(), 1.0, atol=1e-5)
    ff, entering = tm3.faceforward(_t([0.0, 1.0, 0.0], [0.0, 1.0, 0.0]),
                                   _t([0.0, -1.0, 0.0], [0.0, 1.0, 0.0]))
    assert entering.tolist() == [True, False]
    assert ff.tolist() == [[0, 1, 0], [0, -1, 0]]


def _uniforms(n, seed):
    """The JAX tests' draws: next_float2 of seed_paths(0..n-1, seed)."""
    state = rng_ops.seed_paths(torch.arange(n, dtype=torch.int64), seed)
    return rng_ops.next_float2(state)[1:]


def _known_sampling():
    up = torch.tensor([[0.0, 1.0, 0.0]]).expand(200000, 3)
    d = tsampling.cosine_sample(up, *_uniforms(200000, 7)).numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert d[:, 1].min() >= -1e-6
    np.testing.assert_allclose(d[:, 1].mean(), 2.0 / 3.0, atol=5e-3)
    z = torch.tensor([[0.0, 0.0, 1.0]]).expand(50000, 3)
    u1, u2 = _uniforms(50000, 1)
    h = tsampling.ggx_sample_half_vector(u1, u2, torch.tensor(0.05 ** 2),
                                         z).numpy()
    np.testing.assert_allclose(np.linalg.norm(h, axis=-1), 1.0, atol=1e-5)
    assert h[:, 2].min() > 0.9
    rough = tsampling.ggx_sample_half_vector(u1, u2, torch.tensor(1.0), z)
    smooth = tsampling.ggx_sample_half_vector(u1, u2, torch.tensor(0.01), z)
    assert float(rough[:, 2].mean()) < float(smooth[:, 2].mean())
    v = tm3.safe_normalize(torch.tensor([[0.3, 0.1, 0.9]]).expand(10000, 3))
    h = tsampling.ggx_sample_vndf(*_uniforms(10000, 3), torch.tensor(0.25),
                                  z[:10000], v).numpy()
    np.testing.assert_allclose(np.linalg.norm(h, axis=-1), 1.0, atol=1e-4)
    assert (h * v.numpy()).sum(-1).min() >= -1e-5
    f = tsampling.evaluate_brdf(
        _t([0.0, 1.0, 0.0]), tm3.safe_normalize(_t([0.5, 1.0, 0.0])),
        tm3.safe_normalize(_t([-0.3, 0.8, 0.1])), _t([0.5, 0.5, 0.5]),
        torch.tensor([0.0]), torch.tensor([1.0]), torch.tensor([1.0]))
    assert torch.all(f >= 0.0)
    f0 = _t([0.04, 0.04, 0.04])
    np.testing.assert_allclose(
        tsampling.fresnel_schlick(torch.tensor([1.0]), f0)[0].numpy(), 0.04,
        atol=1e-6)
    np.testing.assert_allclose(
        tsampling.fresnel_schlick(torch.tensor([0.0]), f0)[0].numpy(), 1.0,
        atol=1e-6)


def _known_tonemap():
    assert ttonemap.to_u8(torch.tensor([0.0, 0.5, 1.0, 2.0])).tolist() == [
        0, 127, 255, 255]
    out = ttonemap.aces_gamma_per_sample(torch.tensor([0.0, 100.0]))
    np.testing.assert_allclose(out.numpy(), [0.0, 1.0], atol=1e-3)


def _known_env():
    d = torch.as_tensor(_inputs()["v"][:32])
    np.testing.assert_allclose(
        tenv.sample_equirect(torch.full((8, 16, 3), 3.0), d).numpy(), 3.0,
        atol=1e-5)
    img = np.zeros((4, 8, 3), np.float32)
    img[0] = [1, 0, 0]
    img[-1] = [0, 1, 0]
    up = tenv.sample_equirect(torch.as_tensor(img), _t([0.0, 1.0, 0.0]))[0]
    down = tenv.sample_equirect(torch.as_tensor(img), _t([0.0, -1.0, 0.0]))[0]
    assert up[0] > 0.9 and up[1] < 0.1 and down[1] > 0.9 and down[0] < 0.1
    e = tenv.make_hdr_environment(np.full((2, 4, 3), 100.0, np.float32), CPU,
                                  intensity=0.8, max_clamp=5.0)
    np.testing.assert_allclose(
        tenv.environment_color(e, _t([0.0, 0.0, 1.0]))[0].numpy(), 4.0,
        atol=1e-5)
    sky = tenv.procedural_sky(_t([0.0, 1.0, 0.0]))
    assert torch.equal(tenv.environment_color(
        tenv.make_procedural_environment(CPU), _t([0.0, 1.0, 0.0])), sky)
    assert sky[0, 2] > sky[0, 0]
    sun = torch.as_tensor(tenv.SUN_DIRECTION.astype(np.float32))[None]
    away = tenv.procedural_sky(_t([0.0, 0.3, 1.0]))
    assert float(tenv.procedural_sky(sun).sum()) > float(away.sum()) + 0.5


def _known_intersect():
    tri = _one_scene(tri=True)
    hit = tisect.intersect(tri, _t([0.0, 0.0, 0.0], [0.0, 5.0, 0.0]),
                           _t([0.0, 0.0, -1.0], [0.0, 0.0, -1.0]), tmin=0.0)
    np.testing.assert_allclose(float(hit.t[0]), 2.0, atol=1e-6)
    assert torch.isinf(hit.t[1]) and int(hit.kind[0]) == tisect.KIND_TRIANGLE
    assert hit.hit_mask.tolist() == [True, False]
    nrm = hit.normal[0].numpy()
    np.testing.assert_allclose(np.abs(nrm / np.linalg.norm(nrm)), [0, 0, 1],
                               atol=1e-6)
    o, d = _t([0.0, 0.0, 0.0]), _t([0.0, 0.0, -1.0])
    hit = tisect.intersect(_one_scene(([0.0, 0.0, -5.0], 2.0)), o, d,
                           tmin=0.0)
    np.testing.assert_allclose(float(hit.t[0]), 3.0, atol=1e-5)
    np.testing.assert_allclose(hit.normal[0].numpy(), [0, 0, 1], atol=1e-5)
    assert int(hit.kind[0]) == tisect.KIND_SPHERE
    inside = tisect.intersect(_one_scene(([0.0, 0.0, 0.0], 2.0)), o, d,
                              tmin=0.0)
    np.testing.assert_allclose(float(inside.t[0]), 2.0, atol=1e-5)
    one = _one_scene(([0.0, 0.0, -5.0], 1.0))
    assert not bool(tisect.intersect(one, o, d, tmin=0.0,
                                     tmax=3.0).hit_mask[0])
    assert bool(tisect.intersect(one, o, d, tmin=0.0, tmax=4.5).hit_mask[0])
    assert not bool(tisect.intersect(one, o, d, tmin=7.0).hit_mask[0])
    two = _one_scene(([0.0, 0.0, -5.0], 1.0), ([0.0, 0.0, -3.0], 1.0))
    two = two._replace(sph_mat=torch.tensor([0, 1], dtype=torch.int32))
    hit = tisect.intersect(two, o, d, tmin=0.0)
    np.testing.assert_allclose(float(hit.t[0]), 2.0, atol=1e-5)
    assert int(hit.mat_id[0]) == 1
    assert tisect.occluded(tri, _t([0.0, 0.0, 0.0], [0.0, 0.0, -3.0]),
                           _t([0.0, 0.0, -1.0], [0.0, 0.0, -1.0]),
                           tmin=0.0).tolist() == [True, False]
    assert not bool(tisect.occluded(tri, o, d, tmin=0.0,
                                    tmax=torch.tensor([1.5]))[0])
    p = _t([1000.0, 0.0, 0.0], [0.1, 0.0, 0.0])
    nz = _t([0.0, 1.0, 0.0], [0.0, 1.0, 0.0])
    off = tisect.safe_origin(p, nz, torch.tensor([True, True]))
    np.testing.assert_allclose(off[:, 1].numpy(), [0.1, 1e-4], rtol=1e-5)


def _known_gather():
    table = tmaterials.build_device_materials(tmaterials.default_materials(),
                                              CPU)
    got = tmaterials.gather(table, torch.tensor([0, 4, 100]))
    np.testing.assert_allclose(got.base_color[0].numpy(), [1.0, 0.71, 0.29])
    assert int(got.mat_type[1]) == 1
    np.testing.assert_allclose(got.base_color[2].numpy(), [0.6, 0.6, 0.6])


@pytest.mark.parametrize("check", [_known_math, _known_sampling,
                                   _known_tonemap, _known_env,
                                   _known_intersect, _known_gather],
                         ids=lambda f: f.__name__[1:])
def test_known_answers(check):
    check()
