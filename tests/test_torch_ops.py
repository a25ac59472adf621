"""spt_tpu_torch lane math against spt_tpu: scene tables, sampling,
environment lookups and small-scene intersection.

Tolerances: the port evaluates every expression in the JAX package's order,
so values differ only where XLA's and PyTorch's CPU rsqrt and transcendental
functions (sin, cos, atan2, acos, pow) round differently — a few float32
ulps, hence rtol 1e-5 (see _close for the few ill-conditioned lanes).  Hit
kind, material and hit/miss are discrete: exact on >= 99.99 % of lanes (a
lane grazing an edge may flip on a last-bit difference); t and normals at
rtol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from spt_tpu import env as jenv  # noqa: E402
from spt_tpu import lights as jlights  # noqa: E402
from spt_tpu import scene as jscene  # noqa: E402
from spt_tpu.ops import intersect as jisect  # noqa: E402
from spt_tpu.ops import sampling as jsamp  # noqa: E402
from spt_tpu.ops.vec3 import Vec3 as JVec3  # noqa: E402

from spt_tpu_torch import env as tenv  # noqa: E402
from spt_tpu_torch import interop  # noqa: E402
from spt_tpu_torch import lights as tlights  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.ops import intersect as tisect  # noqa: E402
from spt_tpu_torch.ops import sampling as tsamp  # noqa: E402
from spt_tpu_torch.ops.vec3 import Vec3 as TVec3  # noqa: E402

CPU = torch.device("cpu")
N = 4096


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _jv(a):
    return JVec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def _tv(a):
    a = np.ascontiguousarray(a, np.float32)
    return TVec3(torch.from_numpy(a[:, 0].copy()), torch.from_numpy(a[:, 1].copy()),
                 torch.from_numpy(a[:, 2].copy()))


def _close(got, want, rtol=1e-5, atol=1e-6):
    """rtol 1e-5 on >= 99.9 % of lanes and 1e-3 on all of them.  The two
    frameworks' CPU rsqrt/sin/cos/pow differ by an ulp here and there, and
    a few ill-conditioned lanes (a grazing specular peak divides by
    4 cos_nv cos_nl + 1e-4) magnify that ulp past 1e-5."""
    if isinstance(got, TVec3):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    g, w = got.numpy(), np.asarray(want)
    ok = np.abs(g - w) <= atol + rtol * np.abs(w)
    assert ok.mean() >= 0.999, f"{(~ok).sum()} of {ok.size} lanes off"
    np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol)


SCENES = {
    "default": "build_default_scene",
    "cornell": "build_cornell_box_scene",
    "hdr_glass": "build_hdr_glass_scene",
    "triangle": "build_test_triangle_scene",
}


# --- scene tables -------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENES))
def test_flatten_matches(name):
    # host-side numpy code copied across: tables must be identical
    js = jscene.flatten_scene(getattr(jscene, SCENES[name])())
    ts = tscene.flatten_scene(getattr(tscene, SCENES[name])(), CPU)
    for f in ("tri_v0", "tri_e1", "tri_e2", "tri_mat", "sph_center",
              "sph_radius", "sph_mat"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    for f in ts.materials._fields:
        np.testing.assert_array_equal(getattr(ts.materials, f).numpy(),
                                      np.asarray(getattr(js.materials, f)))
    assert (ts.emitters is None) == (js.emitters is None)
    if js.emitters is not None:
        for f in ts.emitters._fields:
            np.testing.assert_array_equal(getattr(ts.emitters, f).numpy(),
                                          np.asarray(getattr(js.emitters, f)))
    assert ts.tri_ns is None and js.tri_ns is None


def test_shading_normals_quantized_like_jax():
    # a smooth UV sphere (96 triangles) carries interpolated normals; the
    # port stores the JAX package's 12-bit quantized values bit for bit
    def desc(mod):
        d = mod.SceneDesc()
        d.add_material(mod.Material([0.7, 0.7, 0.7]))
        mid = d.add_mesh(mod.create_sphere_mesh(stacks=6, slices=8, radius=1.0))
        d.add_instance(mid)
        return d

    js = jscene.flatten_scene(desc(jscene))
    ts = tscene.flatten_scene(desc(tscene), CPU)
    assert js.tri_ns is not None and ts.tri_ns is not None
    np.testing.assert_array_equal(ts.tri_ns.numpy(), np.asarray(js.tri_ns))


def test_scenes_beyond_the_slice_raise(monkeypatch):
    # a 512-triangle mesh gets the resident cluster accel; past
    # MAX_RESIDENT_TRIS without a shared BLAS the stream tier (K8) traces
    # the same accel, up to MAX_STREAM_CLUSTERS clusters
    from spt_tpu_torch.ops import bvh as tbvh, cuda_bounce

    mesh = tscene.SceneDesc()
    mesh.add_material(tscene.Material())
    mesh.add_instance(mesh.add_mesh(tscene.create_sphere_mesh(stacks=16, slices=16)))
    assert tscene.flatten_scene(mesh, CPU).accel is not None
    big = tscene.SceneDesc()
    big.add_material(tscene.Material())
    big.add_instance(big.add_mesh(tscene.create_sphere_mesh(stacks=80, slices=80)))
    bs = tscene.flatten_scene(big, CPU)
    assert bs.inst is None and cuda_bounce._accel_mode(bs) == "stream"
    assert bs.accel.num_clusters == 208 and bs.accel.sup_lo.shape[0] == 13
    monkeypatch.setattr(tbvh, "MAX_STREAM_CLUSTERS", 192)
    with pytest.raises(NotImplementedError, match="MAX_STREAM_CLUSTERS"):
        tscene.flatten_scene(big, CPU)
    monkeypatch.undo()
    # textured scenes flatten with the packed texture table
    tex = tscene.build_default_scene()
    tex.materials[0] = tscene.Material(
        base_color_texture=np.ones((4, 4, 3), np.float32))
    ts = tscene.flatten_scene(tex, CPU)
    assert ts.textures is not None and tuple(ts.textures.shape) == (1, 65536, 2)
    assert ts.tri_uv is not None and int(ts.materials.tex_id[0]) == 0
    # the instanced grid flattens onto the TLAS/BLAS pair
    import chip_smoke
    from spt_tpu_torch import materials as tmaterials
    from spt_tpu_torch.scene import desc as tdesc

    grid, _ = chip_smoke.inst_grid_scene(tscene, tmaterials, tdesc)
    assert tscene.flatten_scene(grid, CPU).inst is not None
    # three distinct meshes over the gate share no BLAS that fits: the
    # stream tier
    three = tscene.SceneDesc()
    three.add_material(tscene.Material())
    for k in range(3):
        mid = three.add_mesh(tscene.create_sphere_mesh(stacks=48 + k, slices=64))
        three.add_instance(mid)
    ts3 = tscene.flatten_scene(three, CPU)
    assert ts3.inst is None and cuda_bounce._accel_mode(ts3) == "stream"


def test_lights_match():
    lm_j, lm_t = jlights.LightManager(), tlights.LightManager()
    for lm in (lm_j, lm_t):
        lm.add_directional_light((0.4, -1.0, -0.3), (1.0, 0.95, 0.9), 1.0)
        lm.add_point_light((1.0, 3.0, 0.5), (1.0, 0.5, 0.2), 4.0)
    jl, tl = lm_j.device(pad_multiple=4), lm_t.device(CPU, pad_multiple=4)
    for f in tl._fields:
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)))
    d = tlights.default_lights(CPU)
    np.testing.assert_array_equal(d.vec.numpy(), np.asarray(jlights.default_lights().vec))


def test_sample_light_matches():
    rng = np.random.default_rng(11)
    p = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    lm_j, lm_t = jlights.LightManager(), tlights.LightManager()
    for lm in (lm_j, lm_t):
        lm.add_directional_light((-0.5, -1.0, 0.3), (1.0, 0.95, 0.8), 2.0)
        lm.add_point_light((0.0, 5.0, 1.0), (1.0, 0.9, 0.8), 30.0)
    jl, tl = lm_j.device(pad_multiple=4), lm_t.device(CPU, pad_multiple=4)
    for i in range(4):
        want = jlights.sample_light_v(jl, i, _jv(p))
        got = tlights.sample_light_v(tl, i, _tv(p))
        _close(got[0], want[0])
        _close(got[1], want[1])
        _close(got[2], want[2])
        assert bool(got[3]) == bool(want[3])


# --- sampling -----------------------------------------------------------------

def _sampling_inputs(seed):
    rng = np.random.default_rng(seed)
    n = _unit(rng, N)
    v = _unit(rng, N)
    v = np.where((n * v).sum(1, keepdims=True) < 0, -v, v).astype(np.float32)
    l = _unit(rng, N)
    u1 = rng.random(N, dtype=np.float32)
    u2 = rng.random(N, dtype=np.float32)
    rough = rng.uniform(0.01, 1.0, N).astype(np.float32)
    metal = rng.uniform(0.0, 1.0, N).astype(np.float32)
    ior = rng.uniform(1.0, 2.0, N).astype(np.float32)
    base = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    return n, v, l, u1, u2, rough, metal, ior, base


@pytest.mark.parametrize("fn", [
    "fresnel_schlick_eta", "fresnel_schlick_v", "d_ggx", "g_smith_cpu",
    "g_smith_gpu", "evaluate_brdf_v", "cosine_sample_v",
    "ggx_sample_half_vector_v", "ggx_sample_vndf_v"])
def test_sampling_matches(fn):
    n, v, l, u1, u2, rough, metal, ior, base = _sampling_inputs(3)
    c = (n * v).sum(1).astype(np.float32)
    alpha = (np.clip(rough, 0.02, 1.0) ** 2).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    if fn == "fresnel_schlick_eta":
        want = jsamp.fresnel_schlick_eta(J(c), J(ior * 0 + 1), J(ior))
        got = tsamp.fresnel_schlick_eta(T(c), T(ior * 0 + 1), T(ior))
    elif fn == "fresnel_schlick_v":
        want = jsamp.fresnel_schlick_v(J(c), _jv(base))
        got = tsamp.fresnel_schlick_v(T(c), _tv(base))
    elif fn == "d_ggx":
        want, got = jsamp.d_ggx(J(c), J(alpha)), tsamp.d_ggx(T(c), T(alpha))
    elif fn == "g_smith_cpu":
        want = jsamp.g_smith_cpu(J(c), J(u1), J(alpha))
        got = tsamp.g_smith_cpu(T(c), T(u1), T(alpha))
    elif fn == "g_smith_gpu":
        want = jsamp.g_smith_gpu(J(u1), J(c), J(alpha))
        got = tsamp.g_smith_gpu(T(u1), T(c), T(alpha))
    elif fn == "evaluate_brdf_v":
        want = jsamp.evaluate_brdf_v(_jv(n), _jv(v), _jv(l), _jv(base),
                                     J(metal), J(rough), J(ior))
        got = tsamp.evaluate_brdf_v(_tv(n), _tv(v), _tv(l), _tv(base),
                                    T(metal), T(rough), T(ior))
    elif fn == "cosine_sample_v":
        want = jsamp.cosine_sample_v(_jv(n), J(u1), J(u2))
        got = tsamp.cosine_sample_v(_tv(n), T(u1), T(u2))
    elif fn == "ggx_sample_half_vector_v":
        want = jsamp.ggx_sample_half_vector_v(J(u1), J(u2), J(alpha), _jv(n))
        got = tsamp.ggx_sample_half_vector_v(T(u1), T(u2), T(alpha), _tv(n))
    else:
        want = jsamp.ggx_sample_vndf_v(J(u1), J(u2), J(alpha), _jv(n), _jv(v))
        got = tsamp.ggx_sample_vndf_v(T(u1), T(u2), T(alpha), _tv(n), _tv(v))
    _close(got, want)


# --- environment --------------------------------------------------------------

def test_procedural_sky_matches():
    d = _unit(np.random.default_rng(5), N)
    _close(tenv.procedural_sky_v(_tv(d)), jenv.procedural_sky_v(_jv(d)))


def test_sample_equirect_matches():
    rng = np.random.default_rng(6)
    d = _unit(rng, N)
    # include the poles and the u seam, where the taps wrap and clamp
    d[:4] = [[0, 1, 0], [0, -1, 0], [-1, 0, 1e-7], [-1, 0, -1e-7]]
    img = rng.uniform(0, 8, (16, 32, 3)).astype(np.float32)
    _close(tenv.sample_equirect_v(torch.from_numpy(img), _tv(d)),
           jenv.sample_equirect_v(jnp.asarray(img), _jv(d)))


@pytest.mark.parametrize("hdr", [False, True])
def test_environment_color_matches(hdr):
    rng = np.random.default_rng(8)
    d = (_unit(rng, N) * 3.0).astype(np.float32)  # unnormalized on purpose
    if hdr:
        img = tenv.synthetic_equirect(32)
        np.testing.assert_array_equal(img, jenv.synthetic_equirect(32))
        je, te = jenv.make_hdr_environment(img), tenv.make_hdr_environment(img, CPU)
    else:
        je, te = jenv.make_procedural_environment(), tenv.make_procedural_environment(CPU)
    assert interop.environment(je, CPU).enabled == te.enabled
    _close(tenv.environment_color_v(te, _tv(d)), jenv.environment_color_v(je, _jv(d)))


# --- intersection -------------------------------------------------------------

def _rays(name, seed):
    rng = np.random.default_rng(seed)
    if name == "cornell":
        o = rng.uniform([-2.5, 0.2, -2.5], [2.5, 5.2, 2.5], (N, 3))
    else:
        o = rng.uniform([-5, 0.2, -5], [5, 4, 8], (N, 3))
    return o.astype(np.float32), _unit(rng, N)


@pytest.mark.parametrize("name", ["default", "cornell", "shading_normals"])
def test_closest_hit_matches(name):
    if name == "shading_normals":
        def desc(mod):
            d = mod.build_default_scene()
            mid = d.add_mesh(mod.create_sphere_mesh(stacks=6, slices=8, radius=1.0))
            d.add_instance(mid, material_id=5)
            return d
        js, ts = jscene.flatten_scene(desc(jscene)), tscene.flatten_scene(desc(tscene), CPU)
        assert ts.tri_ns is not None
    else:
        js = jscene.flatten_scene(getattr(jscene, SCENES[name])())
        ts = interop.scene(js, CPU)
    o, d = _rays(name, 21)
    want = jisect.intersect_v(js, _jv(o), _jv(d), tmin=0.0,
                              tmax=np.float32(1e30))
    got = tisect.intersect_v(ts, _tv(o), _tv(d), tmin=0.0, tmax=1e30)
    whit = np.isfinite(np.asarray(want.t))
    ghit = torch.isfinite(got.t).numpy()
    kind_ok = ((got.kind.numpy() == np.asarray(want.kind))
               & (got.mat_id.numpy() == np.asarray(want.mat_id)) & (ghit == whit))
    assert kind_ok.mean() >= 0.9999, f"{(~kind_ok).sum()} lanes differ"
    assert 0.1 < whit.mean() < 1.0, "fixture should mix hits and misses"
    both = kind_ok & whit
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(want.t)[both], rtol=1e-5)
    for g, w in zip(got.normal, want.normal):
        np.testing.assert_allclose(g.numpy()[both], np.asarray(w)[both],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_occluded_matches(name):
    js = jscene.flatten_scene(getattr(jscene, SCENES[name])())
    ts = interop.scene(js, CPU)
    o, d = _rays(name, 22)
    tmax = np.random.default_rng(23).uniform(0.0, 6.0, N).astype(np.float32)
    want = np.asarray(jisect.occluded_v(js, _jv(o), _jv(d), tmin=1e-4,
                                        tmax=jnp.asarray(tmax)))
    got = tisect.occluded_v(ts, _tv(o), _tv(d), tmin=1e-4,
                            tmax=torch.from_numpy(tmax)).numpy()
    assert (got == want).mean() >= 0.9999
    assert 0.1 < want.mean() < 0.9


def test_safe_origin_matches():
    rng = np.random.default_rng(9)
    p = rng.uniform(-30, 30, (N, 3)).astype(np.float32)
    n = _unit(rng, N)
    front = rng.random(N) < 0.5
    _close(tisect.safe_origin_v(_tv(p), _tv(n), torch.from_numpy(front)),
           jisect.safe_origin_v(_jv(p), _jv(n), jnp.asarray(front)))
