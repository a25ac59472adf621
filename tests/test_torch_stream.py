"""The stream tier of the mesh path (K8) of spt_tpu_torch against spt_tpu.

On the CPU the same scenes and rays (made with numpy from a seed, or carried
across with spt_tpu_torch.interop) go through the JAX function and its
port.  The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does; small fixtures reach the stream tier with
MAX_RESIDENT_TRIS / MAX_ACCEL_TRIS lowered in both packages.  Gates, each
with its reason:

- the accel tables of the baked grid (boxes, cl_okey, the supercluster
  level, tri_pack): bit-exact (numpy host code copied across); the port's
  per-super cluster visit order equal to the order pallas_stream's
  min-extraction opens the clusters in;
- the stream tracers' plain versions against pallas_stream closest_hit /
  any_hit: t within 1e-4, kind, material and uv exact where both hit,
  normals within 1e-5, blocked flags exact, empty intervals blocked
  (tests/test_pallas.py:177-307's gates; both sides are brute force over
  the same float32 rows, so only exact ties in t may resolve otherwise);
- the stream forms of fused_bounce / fused_frame's plain versions against
  pallas_bounce in interpret mode at 64x32 depth 2: rtol 1e-4 / atol 1e-5
  on >= 99.5 % of lanes (the frameworks' CPU transcendentals),
  rays_per_bounce exact;
- the Renderer on the reduced baked grid and on a single 13 122-triangle
  sphere against the JAX Renderer (which traces a stream scene through its
  chunked route on the CPU): hdr_image relative RMSE < 1 %; the sorted
  frame against the unsorted one on every lane.

On a CUDA card (marker ``cuda``; skipped without one) the stream kernels
against their plain versions (the textured radiance bit for bit), and, bit
for bit on the untextured grid, fused_bounce's stream form and the stream
tracer on the cases the warp-cooperative cluster walk has to get right
(chip_smoke.WALK_CASES: warps of mixed octants, every other lane dead, a
lane count that is not a multiple of 32, shadow rays blocked a few clusters
out). Run there with
``python -m pytest --noconftest tests/test_torch_stream.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import env as tenv  # noqa: E402
from spt_tpu_torch import interop  # noqa: E402
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
    from spt_tpu.integrators import transport
    from spt_tpu.ops import bvh, intersect
    from spt_tpu.ops import pallas_bounce as pb
    from spt_tpu.ops import pallas_stream as pstream
    from spt_tpu.ops import pallas_trace as pt
    from spt_tpu.ops.vec3 import Vec3 as JVec3
    from spt_tpu.scene import desc
    return dict(jax=jax, jnp=jnp, camera=camera, config=config, env=env,
                lights=lights, materials=materials, scene=scene, bvh=bvh,
                intersect=intersect, pb=pb, pstream=pstream, pt=pt,
                transport=transport, JVec3=JVec3, desc=desc)


@pytest.fixture
def jx(monkeypatch):
    """The JAX modules, with pallas_call in interpret mode."""
    j = _jax()
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    for m in (j["pb"], j["pstream"], j["pt"]):
        monkeypatch.setattr(m.pl, "pallas_call", patched)
    return j


def _gate(monkeypatch, jx, n_tris):
    """Lower the resident tier's limits in both packages just under a
    scene's triangle count, so that its accel takes the stream tier."""
    for mod, name in ((jx["bvh"], "MAX_RESIDENT_TRIS"),
                      (jx["pt"], "MAX_RESIDENT_TRIS"),
                      (jx["pb"], "MAX_ACCEL_TRIS"),
                      (tbvh, "MAX_RESIDENT_TRIS"),
                      (cuda_bounce, "MAX_ACCEL_TRIS")):
        monkeypatch.setattr(mod, name, n_tris - 1)


def _grid(jx, monkeypatch, stacks=8, slices=12):
    """(JAX DeviceScene, port DeviceScene, camera kwargs) of the baked grid,
    gated into the stream tier."""
    jd, cam = chip_smoke.unique_grid_scene(jx["scene"], jx["materials"],
                                           jx["desc"], stacks, slices)
    td, _ = chip_smoke.unique_grid_scene(tscene, tmaterials, tdesc, stacks,
                                         slices)
    _gate(monkeypatch, jx, sum(m.triangle_count for m in td.meshes))
    js, ts = jx["scene"].flatten_scene(jd), tscene.flatten_scene(td, CPU)
    return js, ts, cam


def _soup(jx):
    """tests/test_pallas.py:177-307's stream fixture: the 400-triangle soup
    and one sphere, rebuilt with cluster_size=8 so that it spans four
    superclusters, the JAX accel with its streaming table forced."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    idx = rng.integers(0, 300, (400, 3)).astype(np.uint32)
    sc = jx["scene"].SceneDesc()
    sc.add_material(jx["scene"].Material())
    sc.add_instance(sc.add_mesh(jx["scene"].MeshData(positions=pos,
                                                     indices=idx)))
    sc.add_sphere([0.0, 0.0, -4.0], 1.0, 0)
    js = jx["scene"].flatten_scene(sc)
    args = [np.asarray(js.tri_v0), np.asarray(js.tri_e1),
            np.asarray(js.tri_e2), np.asarray(js.tri_mat)]
    js = js._replace(accel=jx["bvh"].build_mesh_accel(
        *args, cluster_size=8, force_stream=True))
    assert js.accel.sup_lo.shape[0] >= 4
    return js, interop.scene(js, CPU)


def _rays(n, seed, spread=3.0, shift=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-spread, spread, (n, 3)) + shift).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jv(jx, a):
    return jx["JVec3"](*(jx["jnp"].asarray(a[:, k]) for k in range(3)))


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)))


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


# --- the build ------------------------------------------------------------------

def test_baked_grid_tables_match_jax(jx, monkeypatch):
    js, ts, _ = _grid(jx, monkeypatch)
    assert js.inst is None and ts.inst is None
    assert ts.num_triangles == 16 * 8 * 12 * 2 + 4 * 4 * 6 * 2
    for f in tbvh.MeshAccel._fields[:-1]:
        want, got = np.asarray(getattr(js.accel, f)), getattr(ts.accel, f).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    # the JAX package built its 128-padded streaming copy; the port none
    assert js.accel.tri_stream.shape[0] == js.accel.num_clusters
    assert not hasattr(ts.accel, "tri_stream")
    np.testing.assert_array_equal(ts.tri_uv.numpy(), np.asarray(js.tri_uv))
    np.testing.assert_array_equal(ts.tri_ns.numpy(), np.asarray(js.tri_ns))


def test_accel_mode_is_stream_in_both(jx, monkeypatch):
    js, ts, _ = _grid(jx, monkeypatch)
    assert jx["pb"]._accel_mode(js) == "stream"
    assert cuda_bounce._accel_mode(ts) == "stream"
    assert jx["intersect"]._trace_module(js) is jx["pstream"]
    assert cuda_trace.is_stream(ts.accel)


def test_full_size_baked_grid_is_stream_in_both():
    j = _jax()
    jd, _ = chip_smoke.unique_grid_scene(j["scene"], j["materials"], j["desc"])
    td, _ = chip_smoke.unique_grid_scene(tscene, tmaterials, tdesc)
    assert len(td.meshes) == 20 and len(td.instances) == 20
    ts = tscene.flatten_scene(td, CPU)
    assert ts.num_triangles == 16 * 6144 + 4 * 1536 == 104448
    assert ts.inst is None and ts.textures is not None
    assert cuda_bounce._accel_mode(ts) == "stream"
    assert ts.accel.num_clusters == 1632 and ts.accel.sup_lo.shape[0] == 102
    js = j["scene"].flatten_scene(jd)
    assert js.inst is None and j["pb"]._accel_mode(js) == "stream"
    for f in ("cluster_lo", "cl_okey", "sup_lo", "sup_hi", "sup_okey"):
        np.testing.assert_array_equal(getattr(ts.accel, f).numpy(),
                                      np.asarray(getattr(js.accel, f)), f)


def test_visit_order_matches_pallas_stream_walk(jx, monkeypatch):
    """cl_order row o holds, for each supercluster, its clusters' local ids
    in the order pallas_stream's open loop min-extracts them
    (_visit_keys on cl_okey, :181-190); the kernels' super order comes from
    sup_okey's ranks, a permutation per octant."""
    jnp = jx["jnp"]
    js, ts, _ = _grid(jx, monkeypatch)
    f = tbvh.SUPER_FAN
    okey = jnp.asarray(np.asarray(js.accel.cl_okey))
    g_total = ts.accel.sup_lo.shape[0]
    assert g_total >= 4
    order = ts.accel.cl_order.numpy()
    assert order.shape == (8, g_total * f) and order.dtype == np.int16
    for o in range(8):
        for g in range(g_total):
            flags = jnp.ones((f, 1, 1), bool)
            _, key = jx["pt"]._visit_keys(flags, okey[:, g * f:(g + 1) * f], o)
            walk = []
            for _ in range(f):
                m = jnp.min(key)
                walk.append(int(m & 0xFFFF) - g * f)
                key = jnp.where(key == m, jx["pt"]._OKEY_MISS, key)
            np.testing.assert_array_equal(order[o, g * f:(g + 1) * f], walk)
    ranks = np.sort(ts.accel.sup_okey.numpy()[..., 0] >> 16, axis=1)
    np.testing.assert_array_equal(ranks, np.tile(np.arange(g_total), (8, 1)))


def test_stream_tables_layout(jx, monkeypatch):
    # spheres, materials, lights, then the super boxes and sup_okey only;
    # the cluster level is read from global memory
    _, ts, _ = _grid(jx, monkeypatch)
    lights = tlights.default_lights(CPU)
    cfg = tconfig.RenderConfig(width=8, height=8)
    a = ts.accel
    g = a.sup_lo.shape[0]
    assert cuda_bounce._clusters(ts, "stream") == g
    buf = cuda_bounce._pack_tables(ts, lights, False, "stream")
    assert buf.numel() == cuda_bounce._table_words(ts, lights, False, "stream")
    off = ts.num_spheres * 5 + ts.materials.count * 12 + lights.count * 11
    boxes = buf[off:off + g * 6].reshape(g, 6)
    assert torch.equal(boxes[:, :3], a.sup_lo) and torch.equal(boxes[:, 3:],
                                                               a.sup_hi)
    keys = buf[off + g * 6:].contiguous().view(torch.int32).reshape(8, g)
    assert torch.equal(keys, a.sup_okey[..., 0])
    cbox, corder = cuda_trace.stream_globals(a)
    assert torch.equal(cbox[:, 3:], a.cluster_hi)
    assert torch.equal(corder, a.cl_order)
    assert cuda_bounce.explain_decline(cfg, ts, lights) is None
    # 1024 supers (MAX_STREAM_CLUSTERS) fit shared memory with room to spare
    assert 1024 * (6 + 8) * 4 + 2 * 8 * 1024 < cuda_bounce.MAX_RESIDENT_TABLE_BYTES


# --- the tracer -----------------------------------------------------------------

def _check_hits(got, want, uv=False):
    gk, wk = got.kind.numpy(), np.asarray(want.kind)
    np.testing.assert_array_equal(gk, wk)
    both = wk != 0
    assert both.sum() > 50
    np.testing.assert_array_equal(got.mat_id.numpy()[both],
                                  np.asarray(want.mat_id)[both])
    gt, wt = got.t.numpy(), np.asarray(want.t)
    assert (np.isinf(gt) == np.isinf(wt)).all()
    np.testing.assert_allclose(gt[both], wt[both], rtol=0, atol=1e-4)
    gn = np.stack([c.numpy() for c in got.normal], -1)[both]
    wn = np.stack([np.asarray(c) for c in want.normal], -1)[both]
    np.testing.assert_allclose(gn, wn, rtol=1e-5, atol=1e-5)
    if uv:
        for g, w in ((got.uvx, want.uvx), (got.uvy, want.uvy)):
            np.testing.assert_allclose(g.numpy()[both], np.asarray(w)[both],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["soup", "grid"])
def test_stream_plain_matches_pallas_stream(jx, monkeypatch, case):
    if case == "soup":
        js, ts = _soup(jx)
        o, d = _rays(512, 21)
    else:
        js, ts, _ = _grid(jx, monkeypatch)
        # origins among the grid's spheres (x and z in [0, 3.9])
        o, d = _rays(384, 22, spread=2.2, shift=(2.0, 0.0, 2.0))
    ps = jx["pstream"]
    before = (cuda_trace.STREAM_CLOSEST_LAUNCHES, cuda_trace.STREAM_ANY_LAUNCHES)
    want = ps.closest_hit(js.accel, js, _jv(jx, o), _jv(jx, d), tmin=0.0)
    got = cuda_trace.stream_closest_hit(ts.accel, ts, _tv(o), _tv(d), 0.0,
                                        np.inf)
    _check_hits(got, want, uv=case == "grid")
    # a third of the lanes with an empty interval, which count blocked
    n = o.shape[0]
    tmax = np.where(np.arange(n) % 3 == 0, 0.0, 3.0).astype(np.float32)
    wb = np.asarray(ps.any_hit(js.accel, js, _jv(jx, o), _jv(jx, d),
                               tmin=1e-4, tmax=jx["jnp"].asarray(tmax)))
    gb = cuda_trace.stream_any_hit(ts.accel, ts, _tv(o), _tv(d), 1e-4,
                                   torch.from_numpy(tmax)).numpy()
    np.testing.assert_array_equal(gb, wb)
    assert gb[tmax == 0].all() and 0 < gb[tmax > 0].sum() < (tmax > 0).sum()
    # CPU tensors run the plain versions and launch nothing
    assert before == (cuda_trace.STREAM_CLOSEST_LAUNCHES,
                      cuda_trace.STREAM_ANY_LAUNCHES)


def test_intersect_routes_stream_accels(jx, monkeypatch):
    _, ts, _ = _grid(jx, monkeypatch)
    o, d = _rays(128, 23, spread=2.2, shift=(2.0, 0.0, 2.0))
    hit = tisect.intersect_v(ts, _tv(o), _tv(d), 0.0, 1e30)
    ref = cuda_trace.closest_hit_reference(ts.accel, ts, _tv(o), _tv(d), 0.0,
                                           1e30)
    assert torch.equal(hit.t, ref.t) and torch.equal(hit.kind, ref.kind)
    blk = tisect.occluded_v(ts, _tv(o), _tv(d), 1e-4, 2.0)
    assert torch.equal(blk, tisect._occluded_chunked(ts, _tv(o), _tv(d), 1e-4,
                                                     2.0))
    # the resident tracer refuses an accel past the resident tier
    with pytest.raises(ValueError, match="stream tracer"):
        cuda_trace._resident_inputs(ts.accel, ts)


# --- the fused kernels' plain versions --------------------------------------------

def _fused_fixture(jx, monkeypatch):
    """tests/test_pallas.py:581-700's TestFusedStream scene: the default
    scene, its accel rebuilt with cluster_size=8 and the streaming table
    forced, both packages gated into the stream mode."""
    js = jx["scene"].flatten_scene(jx["scene"].build_default_scene())
    args = [np.asarray(js.tri_v0), np.asarray(js.tri_e1),
            np.asarray(js.tri_e2), np.asarray(js.tri_mat)]
    js = js._replace(accel=jx["bvh"].build_mesh_accel(
        *args, cluster_size=8, force_stream=True))
    for mod, name in ((jx["pb"], "MAX_PALLAS_PRIMS"), (jx["pb"], "MAX_ACCEL_TRIS"),
                      (cuda_bounce, "MAX_PRIMS"), (cuda_bounce, "MAX_ACCEL_TRIS")):
        monkeypatch.setattr(mod, name, 4)
    ts = interop.scene(js, CPU)
    assert jx["pb"]._accel_mode(js) == "stream"
    assert cuda_bounce._accel_mode(ts) == "stream"
    return js, ts


def _close(g, w, share=0.995):
    g = torch.stack(list(g), -1).numpy()
    w = np.stack([np.asarray(c) for c in w], -1)
    ok = np.abs(g - w) <= 1e-5 + 1e-4 * np.abs(w)
    return ok.all(-1).mean() >= share


def test_stream_fused_kernels_match_pallas(jx, monkeypatch):
    js, ts = _fused_fixture(jx, monkeypatch)
    jcfg = jx["config"].RenderConfig(width=64, height=32, spp=1, max_depth=2)
    tcfg = tconfig.RenderConfig(width=64, height=32, spp=1, max_depth=2)
    jl = jx["lights"].default_lights()
    tl = interop.lights(jl, CPU)
    cam = jx["camera"].default_camera(64, 32).rays()
    jps = jx["transport"].gen_primary(jcfg, cam, 0)
    tps = interop.path_state(jps, CPU)
    before = (cuda_bounce.LAUNCHES, cuda_bounce.BOUNCE_LAUNCHES)
    want = jx["pb"].fused_frame(jcfg, js, jl, jps)
    got = cuda_bounce.fused_frame(tcfg, ts, tl, tps)
    for g, w in zip(got[:3], want[:3]):
        assert _close(g, w)
    assert (got[3].numpy() == np.asarray(want[3])).mean() >= 0.995
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert float(torch.stack(list(got[0]), -1).max()) > 0.0
    wst, wm = jx["pb"].fused_bounce(jcfg, js, jl, jps, 0, False)
    gst, gm = cuda_bounce.fused_bounce(tcfg, ts, tl, tps, 0, False)
    for name in ("origin", "direction", "throughput", "radiance"):
        assert _close(getattr(gst, name), getattr(wst, name)), name
    assert (gm.numpy() == np.asarray(wm)).mean() >= 0.995
    assert (gst.alive.numpy() == np.asarray(wst.alive)).mean() >= 0.995
    assert before == (cuda_bounce.LAUNCHES, cuda_bounce.BOUNCE_LAUNCHES)


# --- the whole slice --------------------------------------------------------------

def test_baked_grid_renderer_matches_jax(jx, monkeypatch):
    from spt_tpu.engine.renderer import Renderer as JaxRenderer
    from spt_tpu_torch.engine.renderer import Renderer

    jd, cam = chip_smoke.unique_grid_scene(jx["scene"], jx["materials"],
                                           jx["desc"], 8, 12)
    td, _ = chip_smoke.unique_grid_scene(tscene, tmaterials, tdesc, 8, 12)
    _gate(monkeypatch, jx, sum(m.triangle_count for m in td.meshes))
    pose = dict(cam, aspect_ratio=64 / 48)
    kw = dict(width=64, height=48, spp=1, max_depth=3)
    j = JaxRenderer(jd, jx["config"].RenderConfig(**kw),
                    camera=jx["camera"].Camera(**pose), multi_device=False)
    t = Renderer(td, tconfig.RenderConfig(**kw),
                 camera=tcamera.Camera(**pose), device=CPU)
    assert cuda_bounce._accel_mode(t.scene) == "stream"
    j.render_frames(2)
    t.render_frames(2)
    want, got = j.hdr_image(), t.hdr_image()
    assert got.shape == (48, 64, 3) and np.isfinite(got).all()
    assert _rel_rmse(got, want) < 0.01
    assert int(t.last_stats.rays_per_bounce[0]) == 2 * 64 * 48


def test_baked_grid_sorted_frame_matches_unsorted(jx, monkeypatch):
    _, ts, cam = _grid(jx, monkeypatch)
    rays = tcamera.Camera(aspect_ratio=1.0, **cam).rays(CPU)
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


def test_single_sphere_past_the_resident_tier_renders_like_jax():
    """tests/test_pallas.py:670-700's case, ungated: a 13 122-triangle UV
    sphere takes the stream tier in both packages and renders alike."""
    j = _jax()
    from spt_tpu.engine.renderer import Renderer as JaxRenderer
    from spt_tpu_torch.engine.renderer import Renderer

    def desc(mod, dmod):
        d = mod.SceneDesc()
        d.add_material(mod.Material(base_color=(0.7, 0.5, 0.3)))
        d.add_instance(d.add_mesh(dmod.create_sphere_mesh(
            stacks=81, slices=81, radius=1.0)), material_id=0)
        return d

    pose = dict(position=(0.0, 0.0, 3.5), target=(0.0, 0.0, 0.0),
                fov_degrees=45.0, aspect_ratio=2.0)
    kw = dict(width=64, height=32, spp=1, max_depth=2)
    t = Renderer(desc(tscene, tdesc), tconfig.RenderConfig(**kw),
                 camera=tcamera.Camera(**pose), device=CPU)
    assert t.scene.num_triangles == 13122
    assert cuda_bounce._accel_mode(t.scene) == "stream"
    jr = JaxRenderer(desc(j["scene"], j["desc"]), j["config"].RenderConfig(**kw),
                     camera=j["camera"].Camera(**pose), multi_device=False)
    assert j["pb"]._accel_mode(jr.scene) == "stream"
    jr.render_frames(1)
    t.render_frames(1)
    got, want = t.hdr_image(), jr.hdr_image()
    assert np.isfinite(got).all() and got.max() > 0.0
    assert _rel_rmse(got, want) < 0.01


# --- the card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stream kernels have no CPU mode")
    return torch.device("cuda", 0)


def _card_grid(dev, w, h):
    """(cfg, scene, lights, primary PathState) of the full-size baked grid."""
    desc, cfg, cam = chip_smoke.port_stream_scene()
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
def test_stream_tracer_matches_plain_on_card(cuda_device):
    cfg, scene, _, ps = _card_grid(cuda_device, 128, 96)
    a = scene.accel
    assert cuda_bounce._accel_mode(scene) == "stream"
    n = 128 * 96
    g = torch.Generator().manual_seed(5)
    ro = (torch.rand((n, 3), generator=g) * 6.0 - 1.0).to(cuda_device)
    rd = torch.randn((n, 3), generator=g)
    rd = (rd / rd.norm(dim=1, keepdim=True)).to(cuda_device)
    for o, d in ((ps.origin, ps.direction),
                 (Vec3(*ro.unbind(1)), Vec3(*rd.unbind(1)))):
        o = Vec3(*(c.contiguous() for c in o))
        d = Vec3(*(c.contiguous() for c in d))
        before = cuda_trace.STREAM_CLOSEST_LAUNCHES
        k = cuda_trace.stream_closest_hit(a, scene, o, d, 0.0, 1e30)
        assert cuda_trace.STREAM_CLOSEST_LAUNCHES == before + 1
        p = cuda_trace.closest_hit_reference(a, scene, o, d, 0.0, 1e30)
        torch.cuda.synchronize()
        for x, y in ((k.t, p.t), (k.kind, p.kind), (k.mat_id, p.mat_id),
                     (k.uvx, p.uvx), (k.uvy, p.uvy), *zip(k.normal, p.normal)):
            assert _planes_agree(x, y)
        tmax = torch.where(torch.arange(n, device=cuda_device) % 3 == 0,
                           0.0, 2.0)
        kb = cuda_trace.stream_any_hit(a, scene, o, d, 1e-4, tmax)
        pb = cuda_trace.any_hit_reference(a, scene, o, d, 1e-4, tmax)
        torch.cuda.synchronize()
        assert _planes_agree(kb, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 2])
def test_stream_fused_kernels_match_plain_on_card(cuda_device, start):
    cfg, scene, lights, ps = _card_grid(cuda_device, 128, 96)
    assert cuda_bounce._accel_mode(scene) == "stream"
    before = cuda_bounce.LAUNCHES
    k = cuda_bounce.fused_frame(cfg, scene, lights, ps, start_bounce=start)
    assert cuda_bounce.LAUNCHES == before + 1
    p = cuda_bounce.fused_frame_reference(cfg, scene, lights, ps,
                                          start_bounce=start)
    torch.cuda.synchronize()
    for a, b in zip(k[:3], p[:3]):
        for x, y in zip(a, b):
            assert _planes_agree(x, y)
    assert _planes_agree(k[3], p[3])
    # the textured radiance too is bit for bit since the plain BRDF divides
    # by pi on the card as the kernels do
    assert all(_bits_equal({"radiance": (chip_smoke._v(torch, k[0]),
                                         chip_smoke._v(torch, p[0]))}).values())
    rk, rp = k[4].cpu().numpy(), p[4].cpu().numpy()
    assert (np.abs(rk - rp) <= 1e-3 * rp.clip(min=1)).all()
    kb, km = cuda_bounce.fused_bounce(cfg, scene, lights, ps, 0, False)
    pbs, pm = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps, 0,
                                                 False)
    torch.cuda.synchronize()
    for name in ("origin", "direction", "throughput", "radiance"):
        for x, y in zip(getattr(kb, name), getattr(pbs, name)):
            assert _planes_agree(x, y)
    for x, y in ((kb.rng, pbs.rng), (kb.alive, pbs.alive),
                 (kb.emission_ok, pbs.emission_ok), (km, pm)):
        assert _planes_agree(x, y)
    assert all(_bits_equal({"radiance": (chip_smoke._v(torch, kb.radiance),
                                         chip_smoke._v(torch, pbs.radiance))}
                           ).values())


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
def test_stream_cooperative_walk_bit_for_bit_on_card(cuda_device, case):
    cfg, scene, lights, ps = _card_grid(cuda_device, 128, 96)
    # untextured: the walk's own cases (the textured forms are held bit for
    # bit above)
    scene = scene._replace(textures=None)
    lights, ps = chip_smoke.walk_case(torch, np, case, scene, lights, ps)
    a = scene.accel
    o, d = ps.origin, ps.direction
    tmax = torch.where(ps.alive, 1e30, 0.0)
    k = cuda_trace.stream_closest_hit(a, scene, o, d, 0.0, tmax)
    p = cuda_trace.closest_hit_reference(a, scene, o, d, 0.0, tmax)
    kb = cuda_trace.stream_any_hit(a, scene, o, d, 1e-4, tmax)
    pb = cuda_trace.any_hit_reference(a, scene, o, d, 1e-4, tmax)
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
