"""The resident-tier mesh path of spt_tpu_torch against spt_tpu, on the CPU.

The same scenes and rays (made with numpy from a seed, or carried across
with spt_tpu_torch.interop) go through the JAX function and its port.  The
JAX side runs its Pallas kernels in interpret mode, as tests/test_pallas.py
does.  Gates, each with its reason:

- the cluster build and the 12-bit normal codec: bit-exact (numpy host code
  copied across);
- the cluster tracer's plain version against pallas_trace and the chunked
  intersectors: t within 1e-4, kind exact on hit lanes, blocked flags exact
  (tests/test_pallas.py:118-148's gates);
- the sort key exact; sorted keys exact, payloads travel with their lane,
  the unsort restores every plane exactly;
- the sorted-path route and the condense plan exactly as the JAX
  package decides them (the frame itself: tests/test_torch_mesh_frame.py);
- the whole slice: the port's Renderer against the JAX Renderer,
  hdr_image relative RMSE < 1 %.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from spt_tpu import camera as jcamera  # noqa: E402
from spt_tpu import config as jconfig  # noqa: E402
from spt_tpu import materials as jmaterials  # noqa: E402
from spt_tpu import scene as jscene  # noqa: E402
from spt_tpu.integrators import wavefront as jwf  # noqa: E402
from spt_tpu.ops import bvh as jbvh  # noqa: E402
from spt_tpu.ops import intersect as jisect  # noqa: E402
from spt_tpu.ops import ray_sort as jray_sort  # noqa: E402
from spt_tpu.ops.vec3 import Vec3 as JVec3  # noqa: E402
from spt_tpu.scene import desc as jdesc  # noqa: E402

from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import interop  # noqa: E402
from spt_tpu_torch import materials as tmaterials  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.engine.renderer import Renderer  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.ops import bvh as tbvh  # noqa: E402
from spt_tpu_torch.ops import cuda_bounce, cuda_trace, ray_sort  # noqa: E402
from spt_tpu_torch.ops import intersect as tisect  # noqa: E402
from spt_tpu_torch.ops.vec3 import Vec3  # noqa: E402
from spt_tpu_torch.scene import desc as tdesc  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def interpret_pallas(monkeypatch):
    """spt_tpu's Pallas modules with pallas_call in interpret mode."""
    import jax.experimental.pallas as pl

    import spt_tpu.ops.pallas_bounce as pb
    import spt_tpu.ops.pallas_trace as pt

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pb.pl, "pallas_call", patched)
    monkeypatch.setattr(pt.pl, "pallas_call", patched)
    return pb, pt


def _soup(mod):
    """tests/test_pallas.py:100-116's random soup: 400 triangles over 300
    vertices and one sphere."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    idx = rng.integers(0, 300, (400, 3)).astype(np.uint32)
    sc = mod.SceneDesc()
    sc.add_material(mod.Material())
    mid = sc.add_mesh(mod.MeshData(positions=pos, indices=idx))
    sc.add_instance(mid)
    sc.add_sphere([0.0, 0.0, -4.0], 1.0, 0)
    return sc


def _mesh(mod, mats, dmod, stacks=32, slices=48):
    return chip_smoke.mesh_scene(mod, mats, dmod, stacks, slices)[0]


def _scenes(name):
    """(JAX DeviceScene, port DeviceScene) flattened from the same desc."""
    if name == "soup":
        return (jscene.flatten_scene(_soup(jscene)),
                tscene.flatten_scene(_soup(tscene), CPU))
    return (jscene.flatten_scene(_mesh(jscene, jmaterials, jdesc)),
            tscene.flatten_scene(_mesh(tscene, tmaterials, tdesc), CPU))


def _rays(n=512, seed=1234):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jv(a):
    return JVec3.from_array(jnp.asarray(a))


def _tv(a):
    return Vec3(*torch.as_tensor(a).unbind(1))


# --- the cluster build ----------------------------------------------------------

@pytest.mark.parametrize("name", ["mesh", "soup"])
def test_accel_build_bit_exact(name):
    js, ts = _scenes(name)
    assert js.accel is not None and ts.accel is not None
    # cl_order is the port's own table, derived from cl_okey
    # (tests/test_torch_stream.py holds it to pallas_stream's walk)
    for f in tbvh.MeshAccel._fields[:-1]:
        np.testing.assert_array_equal(getattr(ts.accel, f).numpy(),
                                      np.asarray(getattr(js.accel, f)), f)
    np.testing.assert_array_equal(
        ts.accel.cl_order.numpy(),
        tbvh.cluster_visit_order(np.asarray(js.accel.cl_okey)))
    if name == "mesh":
        assert ts.num_triangles == 6156 and ts.num_spheres == 1
        assert cuda_bounce._accel_mode(ts) == "resident"
        np.testing.assert_array_equal(ts.tri_ns.numpy(), np.asarray(js.tri_ns))


@pytest.mark.parametrize("cluster_size", [8, 64])
def test_build_mesh_accel_direct_bit_exact(cluster_size):
    js, _ = _scenes("soup")
    args = [np.asarray(js.tri_v0), np.asarray(js.tri_e1),
            np.asarray(js.tri_e2), np.asarray(js.tri_mat)]
    ns = np.random.default_rng(5).uniform(-1, 1, (400, 9)).astype(np.float32)
    j = jbvh.build_mesh_accel(*args, cluster_size=cluster_size, ns=ns)
    t = tbvh.build_mesh_accel(*args, cluster_size=cluster_size, ns=ns)
    for f in tbvh.MeshAccel._fields[:-1]:  # cl_order: the port's own
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)


def test_normal_codec_bit_exact():
    rng = np.random.default_rng(9)
    ns = rng.uniform(-2.5, 2.5, (1000, 9)).astype(np.float32)
    ns[::7] = 0.0  # the no-normal sentinel rows
    packed = tbvh.encode_ns(ns)
    np.testing.assert_array_equal(packed, jbvh.encode_ns(ns))
    np.testing.assert_array_equal(tbvh.decode_ns(packed), jbvh.decode_ns(packed))
    np.testing.assert_array_equal(tbvh.quantize_ns(ns), jbvh.quantize_ns(ns))
    assert (tbvh.quantize_ns(ns)[::7] == 0.0).all()


def test_interop_carries_the_accel():
    js, ts = _scenes("soup")
    carried = interop.scene(js, CPU)
    for f in tbvh.MeshAccel._fields:
        assert torch.equal(getattr(carried.accel, f), getattr(ts.accel, f)), f


# --- the cluster tracer's plain version -------------------------------------------

def test_closest_plain_matches_pallas(interpret_pallas):
    _, pt = interpret_pallas
    js, ts = _scenes("soup")
    o, d = _rays()
    pal = pt.closest_hit(js.accel, js, _jv(o), _jv(d), tmin=0.0)
    chunked = jisect._intersect_chunked(js, _jv(o), _jv(d), np.float32(0.0),
                                        np.float32(np.inf))
    got = cuda_trace.closest_hit(ts.accel, ts, _tv(o), _tv(d), 0.0, np.inf)
    assert cuda_trace.CLOSEST_LAUNCHES == 0
    t = got.t.numpy()
    for want in (pal, chunked):
        tw = np.asarray(want.t)
        both_inf = np.isinf(tw) & np.isinf(t)
        close = np.abs(np.nan_to_num(tw - t, nan=1.0)) < 1e-4
        assert (both_inf | close).all()
        hitm = np.isfinite(tw)
        assert hitm.sum() > 50
        np.testing.assert_array_equal(got.kind.numpy()[hitm],
                                      np.asarray(want.kind)[hitm])


def test_anyhit_plain_matches_pallas(interpret_pallas):
    _, pt = interpret_pallas
    js, ts = _scenes("soup")
    o, d = _rays(seed=77)
    tmax = np.float32(4.0)
    pal = pt.any_hit(js.accel, js, _jv(o), _jv(d), tmin=1e-4, tmax=tmax)
    chunked = jisect._occluded_chunked(js, _jv(o), _jv(d), np.float32(1e-4),
                                       tmax)
    got = cuda_trace.any_hit(ts.accel, ts, _tv(o), _tv(d), 1e-4, 4.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(pal))
    np.testing.assert_array_equal(got, np.asarray(chunked))
    assert 0 < got.sum() < got.size


def test_anyhit_empty_intervals_count_blocked(interpret_pallas):
    """Lanes with tmax <= tmin (dead paths, shadow rays that contribute
    nothing) are blocked for pallas_trace.any_hit and for the port's any_hit
    and its plain version alike; the chunked route of occluded_v reports
    them unblocked, in both packages.  Every caller masks those lanes."""
    _, pt = interpret_pallas
    js, ts = _scenes("soup")
    o, d = _rays(seed=78)
    tmax = np.where(np.arange(len(o)) % 3 == 0, 0.0, 4.0).astype(np.float32)
    pal = pt.any_hit(js.accel, js, _jv(o), _jv(d), tmin=1e-4,
                     tmax=jnp.asarray(tmax))
    got = cuda_trace.any_hit(ts.accel, ts, _tv(o), _tv(d), 1e-4,
                             torch.as_tensor(tmax)).numpy()
    np.testing.assert_array_equal(got, np.asarray(pal))
    empty = tmax <= 1e-4
    assert got[empty].all() and 0 < got[~empty].sum() < (~empty).sum()
    chunked = tisect.occluded_v(ts, _tv(o), _tv(d), 1e-4,
                                torch.as_tensor(tmax)).numpy()
    assert not chunked[empty].any()
    np.testing.assert_array_equal(chunked[~empty], got[~empty])


def test_intersect_routes_like_jax():
    js, ts = _scenes("soup")
    o, d = _rays(64)
    hit = tisect.intersect_v(ts, _tv(o), _tv(d), 0.0, 1e30)
    ref = tisect._intersect_chunked(ts, _tv(o), _tv(d), 0.0, 1e30)
    assert torch.equal(hit.t, ref.t) and torch.equal(hit.kind, ref.kind)
    want = jisect.intersect_v(js, _jv(o), _jv(d), np.float32(0.0),
                              np.float32(1e30))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(want.t), rtol=0,
                               atol=1e-4)
    # more than UNROLL_LIMIT primitives without an accel has no route
    with pytest.raises(NotImplementedError, match="accel"):
        tisect.occluded_v(ts._replace(accel=None), _tv(o), _tv(d))


# --- ray sorting ----------------------------------------------------------------

def _sort_inputs(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    alive = rng.random(n) < 0.5
    lo = np.float32([-3, -3, -3])
    inv = np.float32([1 / 6, 1 / 6, 1 / 6])
    return d, o, alive, lo, inv


def test_sort_key_matches_jax():
    d, o, alive, lo, inv = _sort_inputs(4096, 7)
    want = jray_sort.sort_key(_jv(d), _jv(o), jnp.asarray(alive),
                              jnp.asarray(lo), jnp.asarray(inv))
    got = ray_sort.sort_key(_tv(d), _tv(o), torch.as_tensor(alive),
                            torch.as_tensor(lo), torch.as_tensor(inv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    k = got.numpy()
    assert (k[~alive] == 0xFFFFFFFF).all() and (k[alive] < 0xFFFFFFFF).all()
    oct_ = (d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2 + (d[:, 2] < 0)
    np.testing.assert_array_equal((k[alive] >> 27) & 7, oct_[alive])


@pytest.mark.parametrize("n,chunk", [(16384, 8192), (8192, 4096), (4096, 2048)])
def test_sort_by_key_matches_jax_and_round_trips(n, chunk):
    assert ray_sort.chunk_size(n) == jray_sort.chunk_size(n) == chunk
    rng = np.random.default_rng(3)
    key = rng.integers(0, 1 << 30, n, dtype=np.uint32)
    key[rng.random(n) < 0.3] = 0xFFFFFFFF
    planes = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    iplane = rng.integers(0, 1 << 31, n, dtype=np.int32)
    words = rng.integers(0, 1 << 32, n, dtype=np.int64)

    jlane, _ = jray_sort.sort_by_key(jnp.asarray(key),
                                     [jnp.asarray(p) for p in planes], chunk)
    want_keys = key[np.asarray(jlane)]
    tops = [torch.as_tensor(p) for p in planes] + [torch.as_tensor(iplane),
                                                   torch.as_tensor(words)]
    lane, out = ray_sort.sort_by_key(torch.as_tensor(key.astype(np.int64)),
                                     tops, chunk)
    np.testing.assert_array_equal(key[lane.numpy()], want_keys)
    assert (np.diff(want_keys.reshape(-1, chunk).astype(np.int64), axis=1)
            >= 0).all()
    for src, got in zip(tops, out):
        assert torch.equal(got, src[lane])
    assert torch.equal(lane // chunk, torch.arange(n) // chunk)
    back = ray_sort.unsort_by_lane(lane, out, chunk)
    for src, got in zip(tops, back):
        assert torch.equal(got, src)


RESOLUTIONS = [(512, 384), (1920, 1080), (800, 600), (64, 64), (128, 64),
               (640, 480), (100, 100), (320, 240), (1280, 720), (96, 96)]


@pytest.mark.parametrize("w,h", RESOLUTIONS)
def test_sorted_route_matches_jax(w, h):
    # the JAX package pads the fused path's lanes (wavefront.py:651-662) and
    # then asks _ray_sort_ok; the port decides on the same padded count
    import spt_tpu.ops.pallas_bounce as pb

    n = w * h
    natively = n % 128 == 0 and pb._tile_rows(n // 128) > 0
    j_pad = 0 if natively else -n % (64 * 128)
    assert twf.sort_padding(n) == j_pad
    mesh = types.SimpleNamespace(accel=object())
    for kw in ({}, {"ray_sort": False}, {"max_depth": 1},
               {"ray_sort_stages": 0}):
        jcfg = jconfig.RenderConfig(width=w, height=h, **kw)
        tcfg = tconfig.RenderConfig(width=w, height=h, **kw)
        assert (twf._ray_sort_ok(tcfg, mesh, n + j_pad)
                == jwf._ray_sort_ok(jcfg, mesh, n + j_pad))
        chunk = ray_sort.chunk_size(n + j_pad)
        if chunk:
            assert (twf._condense_plan(tcfg, n + j_pad, chunk)
                    == jwf._condense_plan(jcfg, n + j_pad, chunk))
    small = types.SimpleNamespace(accel=None)
    assert not twf._ray_sort_ok(tconfig.RenderConfig(width=w, height=h),
                                small, n + j_pad)
    sorts = twf._ray_sort_ok(tconfig.RenderConfig(width=w, height=h), mesh,
                             n + j_pad)
    # the JAX package's mesh resolution sorts, 1080p never does, and
    # 800x600 only after its padding to 483 328 lanes
    expect = {(512, 384): True, (1920, 1080): False, (800, 600): True,
              (64, 64): True, (320, 240): False, (96, 96): False}
    assert sorts == expect.get((w, h), sorts)


# --- the whole slice ------------------------------------------------------------

def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def _mesh_renderers(w, h, depth, **kw):
    jdesc_, cam = chip_smoke.mesh_scene(jscene, jmaterials, jdesc, 16, 24)
    tdesc_, _ = chip_smoke.mesh_scene(tscene, tmaterials, tdesc, 16, 24)
    pose = dict(cam, aspect_ratio=w / h)
    cfg_kw = dict(dict(width=w, height=h, spp=1, max_depth=depth), **kw)
    from spt_tpu.engine.renderer import Renderer as JaxRenderer

    j = JaxRenderer(jdesc_, jconfig.RenderConfig(**cfg_kw),
                    camera=jcamera.Camera(**pose), multi_device=False)
    t = Renderer(tdesc_, tconfig.RenderConfig(**cfg_kw),
                 camera=tcamera.Camera(**pose), device=CPU)
    return j, t


def test_mesh_slice_matches_jax_renderer():
    import bench as jbench
    from spt_tpu_torch import bench as tbench

    j, t = _mesh_renderers(64, 64, 4)
    assert j.scene.accel is not None and t.scene.accel is not None
    assert cuda_bounce._accel_mode(t.scene) == "resident"
    twf.SORTED_SAMPLES.clear()
    j.render_frames(4)
    t.render_frames(4)
    assert sum(twf.SORTED_SAMPLES.values()) == 4
    want, got = j.hdr_image(), t.hdr_image()
    assert got.shape == (64, 64, 3) and np.isfinite(got).all()
    assert _rel_rmse(got, want) < 0.01
    rays = t.last_stats.rays_per_bounce.numpy()
    assert int(rays[0]) == 4 * 64 * 64
    np.testing.assert_allclose(rays, np.asarray(j.last_stats.rays_per_bounce),
                               rtol=5e-3)
    # the sorted frame's telemetry counts rays as bench.py does
    n_shadow = tbench.shadow_rays_per_surface_lane(t)
    assert n_shadow == jbench.shadow_rays_per_surface_lane(j) == 1
    assert tbench.count_rays(t.last_stats, n_shadow) == jbench.count_rays(
        types.SimpleNamespace(rays_per_bounce=rays), j.cfg, n_shadow)


def test_regen_matches_jax_renderer():
    j, t = _mesh_renderers(32, 24, 4, integrator="regen", spp=2)
    j.render_frames(2)
    t.render_frames(2)
    assert _rel_rmse(t.hdr_image(), j.hdr_image()) < 0.01
    np.testing.assert_allclose(t.last_stats.rays_per_bounce.numpy(),
                               np.asarray(j.last_stats.rays_per_bounce),
                               rtol=5e-3)
    assert cuda_trace.CLOSEST_LAUNCHES == cuda_trace.ANY_LAUNCHES == 0


def test_renderer_defaults_to_the_card():
    desc = tscene.build_default_scene()
    cfg = tconfig.RenderConfig(width=16, height=8)
    if torch.cuda.is_available():
        assert Renderer(desc, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Renderer(desc, cfg)
