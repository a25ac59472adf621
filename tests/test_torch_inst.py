"""The instanced (TLAS/BLAS) mesh tier of spt_tpu_torch against spt_tpu.

On the CPU the same scenes and rays (made with numpy from a seed) go
through the JAX function and its port; the JAX side runs its Pallas
kernels in interpret mode, as tests/test_inst.py does, and small fixtures
reach the instanced gate with MAX_RESIDENT_TRIS lowered in both packages,
as tests/test_inst.py:86-106 lowers it.  Gates, each with its reason:

- the TLAS/BLAS build (every InstAccel array), the texture table and the
  flattened texture coordinates: bit-exact (numpy host code copied across);
- the instanced tracer's plain version against pallas_inst closest_hit /
  any_hit and against the JAX package's flattened chunked route: kind and
  material exact on >= 99.99 % of lanes, t within 1e-4 relative (and
  1e-6 absolute, the rounding of an origin of order 1, for t near 0), normals
  within 1e-4 (normalised against the flattened route, whose world-space
  cross products differ in length by det(R)), uv within 1e-5, blocked flags
  exact — XLA's CPU code and PyTorch's round the object-space transform
  apart by a few ulps, which a grazing lane could turn into another hit;
- fused_frame's plain version in instanced, textured mode against
  pallas_bounce.fused_frame: rtol 1e-4 / atol 1e-5 on >= 99.5 % of lanes
  (the frameworks' CPU transcendentals), rays_per_bounce exact; the sorted
  frame against the unsorted one on every lane;
- the Renderer on the instanced grid against the JAX Renderer tracing
  through pallas_inst, as it does on its chip: hdr_image relative RMSE
  < 1 %.

On a CUDA card (marker ``cuda``; skipped without one) the instanced kernels
against their plain versions (every fused_bounce plane bit for bit, the
textured radiance too; every fused_frame plane bit for bit, also on all-dead, 2 %-scattered and ragged
lanes and on live counts that give each warp 3 or 20 lanes (run one at a time),
chip_smoke.FRAME_EDGES, the rays per bounce exact), and, bit
for bit on the untextured grid, fused_bounce's instanced form and the
instanced tracer on the cases the warp-cooperative cluster walk has to get
right (chip_smoke.WALK_CASES: warps of mixed object-space octants, every
other lane dead, a lane count that is not a multiple of 32, shadow rays
blocked a few clusters out). Run there with
``python -m pytest --noconftest tests/test_torch_inst.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import env as tenv  # noqa: E402
from spt_tpu_torch import lights as tlights  # noqa: E402
from spt_tpu_torch import materials as tmaterials  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.ops import bvh as tbvh  # noqa: E402
from spt_tpu_torch.ops import cuda_bounce, cuda_trace  # noqa: E402
from spt_tpu_torch.ops import intersect as tisect  # noqa: E402
from spt_tpu_torch.ops.vec3 import Vec3  # noqa: E402
from spt_tpu_torch.scene import desc as tdesc  # noqa: E402

CPU = torch.device("cpu")


def _jax():
    """The JAX modules the comparisons need (imported per test, so that the
    file also collects and runs its card tests where JAX is absent)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from spt_tpu import camera, config, env, lights, materials, scene
    from spt_tpu.ops import bvh, intersect
    from spt_tpu.ops import pallas_bounce as pb
    from spt_tpu.ops import pallas_inst as pinst
    from spt_tpu.ops.vec3 import Vec3 as JVec3
    from spt_tpu.scene import desc
    return dict(jax=jax, jnp=jnp, camera=camera, config=config, env=env,
                lights=lights, materials=materials, scene=scene, bvh=bvh,
                intersect=intersect, pb=pb, pinst=pinst, JVec3=JVec3,
                desc=desc)


@pytest.fixture
def jx(monkeypatch):
    """The JAX modules, with pallas_call in interpret mode."""
    j = _jax()
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(j["pb"].pl, "pallas_call", patched)
    return j


def _gate(monkeypatch, jx, n_tris):
    """Lower MAX_RESIDENT_TRIS in both packages just under a scene's
    flattened triangle count, so that its instances take the TLAS/BLAS."""
    monkeypatch.setattr(jx["bvh"], "MAX_RESIDENT_TRIS", n_tris - 1)
    monkeypatch.setattr(tbvh, "MAX_RESIDENT_TRIS", n_tris - 1)


def _m4(t=(0.0, 0.0, 0.0), deg=0.0, s=(1.0, 1.0, 1.0)):
    a = np.deg2rad(deg)
    m = np.eye(4)
    m[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]) @ np.diag(s)
    m[:3, 3] = t
    return m.astype(np.float32)


def _soup(mod, rng, nv=120, nt=200, material_id=0):
    pos = rng.uniform(-1, 1, (nv, 3)).astype(np.float32)
    idx = rng.integers(0, nv, (nt, 3)).astype(np.uint32)
    return mod.MeshData(positions=pos, indices=idx, material_id=material_id)


def _instanced_desc(mod, case):
    """tests/test_inst.py:_build_instanced's scene in either package: three
    transformed copies of a soup (one mirrored, or overridden to material
    2, by case), a second smaller soup, a sphere; "single" keeps the three
    copies of one soup only."""
    rng = np.random.default_rng(11)
    sc = mod.SceneDesc()
    for c in ([0.8, 0.2, 0.2], [0.2, 0.8, 0.2], [0.2, 0.2, 0.8]):
        sc.add_material(mod.Material(base_color=c))
    m0 = sc.add_mesh(_soup(mod, rng, material_id=0))
    m1 = sc.add_mesh(_soup(mod, rng, nv=60, nt=90, material_id=1))
    sc.add_instance(m0, _m4((-2.0, 0.0, 0.0)))
    sc.add_instance(m0, _m4((2.0, 0.5, -1.0), 35.0, (0.7, 1.3, 0.9)))
    third = _m4((0.0, -1.5, 1.0), -60.0,
                (-1.0, 1.0, 1.0) if case == "mirror" else (1.0, 1.0, 1.0))
    sc.add_instance(m0, third, **({"material_id": 2}
                                  if case == "override" else {}))
    if case != "single":
        sc.add_instance(m1, _m4((0.0, 2.0, -2.0), 10.0))
    sc.add_sphere([0.0, 0.0, -5.0], 1.0, 2)
    return sc


def _scenes(jx, monkeypatch, case):
    """(JAX DeviceScene, port DeviceScene) of a case, both instanced."""
    if case == "grid":
        jd, _ = chip_smoke.inst_grid_scene(jx["scene"], jx["materials"],
                                           jx["desc"], 8, 12)
        td, _ = chip_smoke.inst_grid_scene(tscene, tmaterials, tdesc, 8, 12)
    else:
        jd, td = _instanced_desc(jx["scene"], case), _instanced_desc(tscene,
                                                                     case)
    n = jx["scene"].flatten_scene(jd).num_triangles
    _gate(monkeypatch, jx, n)
    js, ts = jx["scene"].flatten_scene(jd), tscene.flatten_scene(td, CPU)
    assert js.inst is not None and ts.inst is not None
    return js, ts


# --- the build ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mirror", "override", "grid"])
def test_build_inst_accel_bit_exact(jx, monkeypatch, case):
    js, ts = _scenes(jx, monkeypatch, case)
    for f in ts.inst._fields:
        want, got = np.asarray(getattr(js.inst, f)), getattr(ts.inst, f).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert jx["pb"]._accel_mode(js) == "instanced"
    assert cuda_bounce._accel_mode(ts) == "instanced"
    if case == "grid":
        from spt_tpu_torch import interop

        np.testing.assert_array_equal(ts.tri_uv.numpy(), np.asarray(js.tri_uv))
        np.testing.assert_array_equal(
            ts.textures.numpy(), interop.textures(js.textures, CPU).numpy())
        np.testing.assert_array_equal(ts.materials.tex_id.numpy(),
                                      np.asarray(js.materials.tex_id))


def test_full_size_grid_is_instanced_and_textured_in_both():
    j = _jax()
    jd, _ = chip_smoke.inst_grid_scene(j["scene"], j["materials"], j["desc"])
    td, _ = chip_smoke.inst_grid_scene(tscene, tmaterials, tdesc)
    js, ts = j["scene"].flatten_scene(jd), tscene.flatten_scene(td, CPU)
    assert js.num_triangles == ts.num_triangles == 16 * 6144 + 4 * 1536
    assert j["pb"]._accel_mode(js) == "instanced"
    assert cuda_bounce._accel_mode(ts) == "instanced"
    # 2 meshes x 96 clusters x 64 = MAX_RESIDENT_TRIS: accepted at equality
    assert tuple(ts.inst.blas_lo.shape) == (2, 96, 3)
    assert ts.inst.num_meshes * ts.inst.cmax * 64 == tbvh.MAX_RESIDENT_TRIS
    assert ts.textures is not None and js.textures is not None
    assert ts.textures.shape[0] == 1 and ts.materials.tex_id.tolist()[:4] == [
        0, -1, -1, -1]
    for f in ("blas_okey", "inst", "inst_lo", "inst_okey"):
        np.testing.assert_array_equal(getattr(ts.inst, f).numpy(),
                                      np.asarray(getattr(js.inst, f)))


# --- the tracer -----------------------------------------------------------------

def _rays(n, seed, spread=4.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jv(jx, a):
    return jx["JVec3"](*(jx["jnp"].asarray(a[:, k]) for k in range(3)))


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)))


def _check_hits(got, want, normalize=False, uv=False):
    gk, wk = got.kind.numpy(), np.asarray(want.kind)
    assert (gk == wk).mean() >= 0.9999, f"kind off on {(gk != wk).sum()} lanes"
    both = (gk == wk) & (wk != 0)
    assert both.sum() > 50
    gm, wm = got.mat_id.numpy(), np.asarray(want.mat_id)
    assert (gm[both] == wm[both]).mean() >= 0.9999
    gt, wt = got.t.numpy()[both], np.asarray(want.t)[both]
    # near t = 0 the error is the origin's absolute rounding (coordinates
    # of order 1, float32 ulp 1.2e-7), not a share of t
    np.testing.assert_allclose(gt, wt, rtol=1e-4, atol=1e-6)
    gn = np.stack([c.numpy() for c in got.normal], -1)[both]
    wn = np.stack([np.asarray(c) for c in want.normal], -1)[both]
    if normalize:
        gn = gn / np.linalg.norm(gn, axis=1, keepdims=True)
        wn = wn / np.linalg.norm(wn, axis=1, keepdims=True)
    assert (np.abs(gn - wn) <= 1e-4 * np.maximum(1.0, np.abs(wn))).all()
    if uv:
        np.testing.assert_allclose(got.uvx.numpy()[both],
                                   np.asarray(want.uvx)[both], atol=1e-5)
        np.testing.assert_allclose(got.uvy.numpy()[both],
                                   np.asarray(want.uvy)[both], atol=1e-5)


@pytest.mark.parametrize("case", ["single", "multi", "mirror", "override",
                                  "grid"])
def test_inst_plain_matches_pallas_inst(jx, monkeypatch, case):
    js, ts = _scenes(jx, monkeypatch, case)
    o, d = _rays(1024, 7, spread=4.0 if case != "grid" else 5.0)
    if case == "grid":
        o = o + np.float32([2.0, 0.0, 2.0])
    pinst = jx["pinst"]
    want = pinst.closest_hit(js.inst, js, _jv(jx, o), _jv(jx, d), 0.0, 1e30)
    got = cuda_trace.inst_closest_hit_reference(ts.inst, ts, _tv(o), _tv(d),
                                                0.0, 1e30)
    _check_hits(got, want, uv=case == "grid")
    # a third of the lanes with an empty interval, which count blocked
    tmax = np.where(np.arange(1024) % 3 == 0, 0.0, 3.0).astype(np.float32)
    wb = np.asarray(pinst.any_hit(js.inst, js, _jv(jx, o), _jv(jx, d), 1e-4,
                                  jx["jnp"].asarray(tmax)))
    gb = cuda_trace.inst_any_hit_reference(ts.inst, ts, _tv(o), _tv(d), 1e-4,
                                           torch.from_numpy(tmax)).numpy()
    np.testing.assert_array_equal(gb, wb)
    assert 0 < (wb & (tmax > 0)).sum() < (tmax > 0).sum()


@pytest.mark.parametrize("case", ["mirror", "override"])
def test_inst_plain_matches_flattened_chunked_route(jx, monkeypatch, case):
    js, ts = _scenes(jx, monkeypatch, case)
    o, d = _rays(1024, 9)
    want = jx["intersect"]._intersect_chunked(js, _jv(jx, o), _jv(jx, d),
                                              1e-4, 1e30)
    got = cuda_trace.inst_closest_hit_reference(ts.inst, ts, _tv(o), _tv(d),
                                                1e-4, 1e30)
    _check_hits(got, want, normalize=True)


def test_intersect_routes_to_the_instanced_tracer(jx, monkeypatch):
    from spt_tpu_torch.ops import intersect as tisect

    _, ts = _scenes(jx, monkeypatch, "multi")
    o, d = _rays(256, 3)
    counts = (cuda_trace.INST_CLOSEST_LAUNCHES, cuda_trace.INST_ANY_LAUNCHES)
    hit = tisect.intersect_v(ts, _tv(o), _tv(d), 0.0, 1e30)
    ref = cuda_trace.inst_closest_hit_reference(ts.inst, ts, _tv(o), _tv(d),
                                                0.0, 1e30)
    assert torch.equal(hit.t, ref.t) and torch.equal(hit.mat_id, ref.mat_id)
    blk = tisect.occluded_v(ts, _tv(o), _tv(d), 1e-4, 2.0)
    assert torch.equal(blk, cuda_trace.inst_any_hit_reference(
        ts.inst, ts, _tv(o), _tv(d), 1e-4, 2.0))
    # CPU tensors run the plain versions and launch nothing
    assert counts == (cuda_trace.INST_CLOSEST_LAUNCHES,
                      cuda_trace.INST_ANY_LAUNCHES)


def test_instanced_tables_layout(jx, monkeypatch):
    # spheres, materials (tex_id last), lights, the BLAS boxes, the
    # instance rows, then the BLAS keys re-ranked 0..CMAX-1 per row
    _, ts = _scenes(jx, monkeypatch, "grid")
    lights = tlights.default_lights(CPU)
    cfg = tconfig.RenderConfig(width=8, height=8)
    buf = cuda_bounce._pack_tables(ts, lights, False, "instanced")
    assert buf.numel() == cuda_bounce._table_words(ts, lights, False,
                                                   "instanced")
    ia = ts.inst
    s, m, n_l = ts.num_spheres, ts.materials.count, lights.count
    mats = buf[s * 5:s * 5 + m * 12].reshape(m, 12)
    assert torch.equal(mats[:, 11].contiguous().view(torch.int32),
                       ts.materials.tex_id)
    off = s * 5 + m * 12 + n_l * 11
    c = ia.num_meshes * ia.cmax
    boxes = buf[off:off + c * 6].reshape(ia.num_meshes, ia.cmax, 6)
    assert torch.equal(boxes[..., :3], ia.blas_lo)
    rows = buf[off + c * 6:off + c * 6 + ia.num_instances * 22]
    assert torch.equal(rows.reshape(-1, 22)[:, 6:], ia.inst)
    keys = buf[off + c * 6 + ia.num_instances * 22:].contiguous().view(
        torch.int32).reshape(8 * ia.num_meshes, ia.cmax)
    assert torch.equal(keys >> 16, torch.arange(ia.cmax, dtype=torch.int32)
                       .expand_as(keys))
    # the same clusters in the same front-to-back order as blas_okey's
    order = torch.sort(ia.blas_okey[..., 0], dim=1).values & 0xFFFF
    assert torch.equal(keys & 0xFFFF, order)
    flags = cuda_bounce._flags(cfg, ts, False, "instanced")
    assert flags & cuda_bounce._TEXTURED and not flags & cuda_bounce._HAS_NS
    assert cuda_bounce.explain_decline(cfg, ts, lights) is None


def test_stream_tier_still_raises(monkeypatch):
    # three distinct meshes past the gate: no shared BLAS fits, so the
    # stream tier (K8) traces the flattened accel; past its cluster limit
    # the scene still raises
    d = tscene.SceneDesc()
    d.add_material(tscene.Material())
    for k in range(3):
        mid = d.add_mesh(tscene.create_sphere_mesh(stacks=48 + k, slices=64))
        d.add_instance(mid, _m4((2.0 * k, 0.0, 0.0)))
        d.add_instance(mid, _m4((2.0 * k, 2.0, 0.0)))
    ts = tscene.flatten_scene(d, CPU)
    assert ts.inst is None and cuda_bounce._accel_mode(ts) == "stream"
    monkeypatch.setattr(tbvh, "MAX_STREAM_CLUSTERS", ts.accel.num_clusters - 16)
    with pytest.raises(NotImplementedError, match="MAX_STREAM_CLUSTERS"):
        tscene.flatten_scene(d, CPU)


# --- the frame -------------------------------------------------------------------

def _quad_soup_desc(mod, tex):
    """tests/test_inst.py:588-624's scene: two textured quads and three soup
    copies, all of the textured material 0."""
    rng = np.random.default_rng(5)
    sc = mod.SceneDesc()
    sc.add_material(mod.Material(base_color=[1.0, 1.0, 1.0], roughness=1.0,
                                 ior=1.0, base_color_texture=tex))
    quad = mod.MeshData(
        positions=[[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
        indices=[[0, 1, 2], [0, 2, 3]], normals=[[0, 0, 1]] * 4,
        texcoords=[[0, 1], [1, 1], [1, 0], [0, 0]], material_id=0)
    soup = _soup(mod, rng, nv=100, nt=240, material_id=0)
    mq, ms = sc.add_mesh(quad), sc.add_mesh(soup)
    sc.add_instance(mq, _m4((-1.5, 0.0, 0.0)))
    sc.add_instance(mq, _m4((1.5, 0.3, -0.5), 30.0))
    sc.add_instance(ms, _m4((0.0, -2.5, 0.0)))
    sc.add_instance(ms, _m4((0.0, 2.5, 0.0)))
    sc.add_instance(ms, _m4((2.5, 0.0, 1.0), 75.0))
    return sc


def _quad_soup(jx, monkeypatch):
    tex = np.random.default_rng(5).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    jd = _quad_soup_desc(jx["scene"], tex)
    _gate(monkeypatch, jx, jx["scene"].flatten_scene(jd).num_triangles)
    js = jx["scene"].flatten_scene(jd)
    assert js.inst is not None and js.textures is not None
    assert jx["pb"]._accel_mode(js) == "instanced"
    from spt_tpu_torch import interop

    ts = interop.scene(js, CPU)
    assert cuda_bounce._accel_mode(ts) == "instanced"
    return js, ts


def test_instanced_textured_frame_matches_pallas(jx, monkeypatch):
    from spt_tpu_torch import interop

    js, ts = _quad_soup(jx, monkeypatch)
    lm = jx["lights"].LightManager()
    lm.add_directional_light((0.1, -0.3, -1.0), (1.0, 1.0, 1.0), 2.0)
    jl = lm.device()
    cam = dict(position=(0.0, 0.0, 6.0), target=(0.0, 0.0, 0.0),
               fov_degrees=55.0, aspect_ratio=1.0)
    jcfg = jx["config"].RenderConfig(width=32, height=32, spp=1, max_depth=2)
    tcfg = tconfig.RenderConfig(width=32, height=32, spp=1, max_depth=2)
    from spt_tpu.integrators import transport as jtr

    jps = jtr.gen_primary(jcfg, jx["camera"].Camera(**cam).rays(), 0)
    want = jx["pb"].fused_frame(jcfg, js, jl, jps)
    got = cuda_bounce.fused_frame(tcfg, ts, interop.lights(jl, CPU),
                                  interop.path_state(jps, CPU))
    for g, w in zip(got[:3], want[:3]):
        g = torch.stack(list(g), -1).numpy()
        w = np.stack([np.asarray(c) for c in w], -1)
        ok = np.abs(g - w) <= 1e-5 + 1e-4 * np.abs(w)
        assert ok.all(-1).mean() >= 0.995
    assert (got[3].numpy() == np.asarray(want[3])).mean() >= 0.995
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    rad = torch.stack(list(got[0]), -1)
    assert float(rad.max()) > 0.0


def test_instanced_sorted_frame_matches_unsorted(jx, monkeypatch):
    _, ts = _quad_soup(jx, monkeypatch)
    rays = tcamera.Camera(position=(0.0, 0.0, 6.0), target=(0.0, 0.0, 0.0),
                          fov_degrees=55.0, aspect_ratio=1.0).rays(CPU)
    env = tenv.make_procedural_environment(CPU)
    lights = tlights.default_lights(CPU)
    out = {}
    for sort in (True, False):
        cfg = tconfig.RenderConfig(width=64, height=64, spp=1, max_depth=3,
                                   ray_sort=sort, condense=False)
        twf.SORTED_SAMPLES.clear()
        out[sort] = twf._wavefront_masked(cfg, ts, env, lights,
                                          ttr.gen_primary(cfg, rays, 0))
        assert sum(twf.SORTED_SAMPLES.values()) == (1 if sort else 0)
    np.testing.assert_allclose(out[True][0].numpy(), out[False][0].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out[True][1].rays_per_bounce.numpy(),
                                  out[False][1].rays_per_bounce.numpy())


# --- the whole slice --------------------------------------------------------------

def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def test_grid_renderer_matches_jax(jx, monkeypatch):
    from spt_tpu.engine.renderer import Renderer as JaxRenderer
    from spt_tpu_torch.engine.renderer import Renderer

    jd, cam = chip_smoke.inst_grid_scene(jx["scene"], jx["materials"],
                                         jx["desc"], 8, 12)
    td, _ = chip_smoke.inst_grid_scene(tscene, tmaterials, tdesc, 8, 12)
    _gate(monkeypatch, jx, jx["scene"].flatten_scene(jd).num_triangles)
    # the JAX package traces this scene through pallas_inst on its chip; on
    # the CPU it would take the flattened world-space route, whose shading
    # normals quantize in world space and whose hit points round apart from
    # the object-space ones, so that some paths take other branches, past
    # the 1 % gate.  Route its traces to pallas_inst (interpret mode) as on
    # the chip; the shading stays its staged path.
    monkeypatch.setattr(jx["intersect"], "_pallas_ok",
                        lambda scene, n: scene.accel is not None
                        and n % 128 == 0)
    pose = dict(cam, aspect_ratio=64 / 48)
    kw = dict(width=64, height=48, spp=1, max_depth=3)
    j = JaxRenderer(jd, jx["config"].RenderConfig(**kw),
                    camera=jx["camera"].Camera(**pose), multi_device=False)
    t = Renderer(td, tconfig.RenderConfig(**kw),
                 camera=tcamera.Camera(**pose), device=CPU)
    assert j.scene.inst is not None and t.scene.inst is not None
    assert cuda_bounce._accel_mode(t.scene) == "instanced"
    j.render_frames(2)
    t.render_frames(2)
    want, got = j.hdr_image(), t.hdr_image()
    assert got.shape == (48, 64, 3) and np.isfinite(got).all()
    assert _rel_rmse(got, want) < 0.01
    assert int(t.last_stats.rays_per_bounce[0]) == 2 * 64 * 48


# --- the card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the instanced kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)


def _grid(dev, w, h, stacks=16, slices=24):
    """(cfg, scene, lights, primary PathState) of the instanced grid: at
    16 x 24 its 13 056 world triangles pass the gate on their own."""
    desc, cfg, cam = chip_smoke.port_inst_scene(stacks, slices)
    cfg = cfg.replace(width=w, height=h)
    cam.set_aspect_ratio(w / h)
    scene = tscene.flatten_scene(desc, dev)
    return cfg, scene, tlights.default_lights(dev), ttr.gen_primary(
        cfg, cam.rays(dev), 1)


def _planes_agree(k, p, share=0.999):
    if k.dtype.is_floating_point:
        off = ~((k == p) | ((k - p).abs() <= 1e-3))
    else:
        off = k != p
    return float(off.float().mean()) <= 1 - share


@pytest.mark.cuda
def test_inst_tracer_matches_plain_on_card(cuda_device):
    cfg, scene, _, ps = _grid(cuda_device, 256, 192)
    assert scene.inst is not None
    ia = scene.inst
    g = torch.Generator().manual_seed(5)
    n = 256 * 192
    ro = (torch.rand((n, 3), generator=g) * 6.0 - 1.0).to(cuda_device)
    rd = torch.randn((n, 3), generator=g)
    rd = (rd / rd.norm(dim=1, keepdim=True)).to(cuda_device)
    for o, d in ((ps.origin, ps.direction),
                 (Vec3(*ro.unbind(1)), Vec3(*rd.unbind(1)))):
        o = Vec3(*(c.contiguous() for c in o))
        d = Vec3(*(c.contiguous() for c in d))
        before = cuda_trace.INST_CLOSEST_LAUNCHES
        k = cuda_trace.inst_closest_hit(ia, scene, o, d, 0.0, 1e30)
        assert cuda_trace.INST_CLOSEST_LAUNCHES == before + 1
        p = cuda_trace.inst_closest_hit_reference(ia, scene, o, d, 0.0, 1e30)
        torch.cuda.synchronize()
        for a, b in ((k.t, p.t), (k.kind, p.kind), (k.mat_id, p.mat_id),
                     (k.uvx, p.uvx), (k.uvy, p.uvy), *zip(k.normal, p.normal)):
            assert _planes_agree(a, b)
        tmax = torch.where(torch.arange(n, device=cuda_device) % 3 == 0,
                           0.0, 2.0)
        kb = cuda_trace.inst_any_hit(ia, scene, o, d, 1e-4, tmax)
        pb = cuda_trace.inst_any_hit_reference(ia, scene, o, d, 1e-4, tmax)
        torch.cuda.synchronize()
        assert _planes_agree(kb, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("start,case", [
    (0, None), (2, None), *((None, case) for case in chip_smoke.FRAME_EDGES)])
def test_instanced_fused_kernels_match_plain_on_card(cuda_device, start, case):
    # the edge cases (chip_smoke.FRAME_EDGES) start at bounce 3 and check
    # fused_frame alone
    cfg, scene, lights, ps = _grid(cuda_device, 256, 192)
    assert cuda_bounce._accel_mode(scene) == "instanced"
    fps = ps
    if case is not None:
        grid = chip_smoke.frame_grid(torch, cfg, scene, lights, ps)
        fps, start = chip_smoke.frame_edge(torch, np, case, ps, grid)
    before = cuda_bounce.LAUNCHES
    k = cuda_bounce.fused_frame(cfg, scene, lights, fps, start_bounce=start)
    assert cuda_bounce.LAUNCHES == before + 1
    p = cuda_bounce.fused_frame_reference(cfg, scene, lights, fps,
                                          start_bounce=start)
    torch.cuda.synchronize()
    # every plane bit for bit, the textured radiance too since the plain
    # BRDF divides by pi on the card as the kernels do
    same = chip_smoke.frame_bits_equal(torch, k, p)
    assert all(same.values()), same
    assert chip_smoke.frame_counters(torch, k[4])[0] == int(fps.alive.sum())
    if case is not None and case.startswith("take"):
        assert chip_smoke.frame_take(torch, k[4]) == chip_smoke.edge_take(case)
    if case is not None:
        return
    kb, km = cuda_bounce.fused_bounce(cfg, scene, lights, ps, 0, False)
    pbs, pm = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps, 0,
                                                 False)
    torch.cuda.synchronize()
    # fused_bounce: every plane bit for bit, the textured radiance too
    same = _bits_equal(chip_smoke._state_planes(torch, kb, km, pbs, pm))
    assert all(same.values()), same


def _bits_equal(planes):
    """{plane: whether kernel and plain version agree bit for bit}."""
    out = {}
    for name, (k, p) in planes.items():
        same = k == p
        if k.dtype.is_floating_point:
            same = same | (torch.isnan(k) & torch.isnan(p))
        out[name] = bool(same.all())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.WALK_CASES)
def test_inst_cooperative_walk_bit_for_bit_on_card(cuda_device, case):
    cfg, scene, lights, ps = _grid(cuda_device, 256, 192)
    # untextured: the walk's own cases (the textured forms are held bit for
    # bit above)
    scene = scene._replace(textures=None)
    lights, ps = chip_smoke.walk_case(torch, np, case, scene, lights, ps)
    ia = scene.inst
    o, d = ps.origin, ps.direction
    tmax = torch.where(ps.alive, 1e30, 0.0)
    k = cuda_trace.inst_closest_hit(ia, scene, o, d, 0.0, tmax)
    p = cuda_trace.inst_closest_hit_reference(ia, scene, o, d, 0.0, tmax)
    kb = cuda_trace.inst_any_hit(ia, scene, o, d, 1e-4, tmax)
    pb = cuda_trace.inst_any_hit_reference(ia, scene, o, d, 1e-4, tmax)
    torch.cuda.synchronize()
    assert all(_bits_equal(chip_smoke._hit_planes(torch, k, p)).values())
    assert torch.equal(kb, pb)
    ks, km = cuda_bounce.fused_bounce(cfg, scene, lights, ps, 0, False)
    with chip_smoke.capture_calls([(tisect, "occluded_v")],
                                  results=True) as shadows:
        ps_, pm = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps,
                                                     0, False)
    torch.cuda.synchronize()
    same = _bits_equal(chip_smoke._state_planes(torch, ks, km, ps_, pm))
    assert all(same.values()), same
    if case == "blocked_early":
        live = sum(int((kw["tmax"] > kw["tmin"]).sum())
                   for _, _, kw, _ in shadows)
        blocked = sum(int((res & (kw["tmax"] > kw["tmin"])).sum())
                      for _, _, kw, res in shadows)
        assert blocked >= 0.2 * live > 0
