"""The mesh path's kernel wrappers of spt_tpu_torch, without JAX.

- On the CPU: each wrapper (closest_hit, any_hit, fused_bounce, the
  resident fused_frame, sort_chunks) runs its plain version and launches
  nothing; fused_frame hands back missed as bool and the rays per bounce
  as (max_depth,) int64 in every accel mode, equal to the plain version's
  per-lane bounce totals; fused_bounce hands back the RNG words as int64
  and the flags and missed as bool in every accel mode, and the kernels
  are handed the path state's own RNG and flag tensors, unconverted; the
  resident tables have the layout the kernels read; a scene past the
  stream tier's cluster limit raises, naming why, and none other: more
  than 32 spheres beside a mesh, or more than 192 primitives without an
  accel, flatten and render (the unfused route).
- On a CUDA card (marker ``cuda``; skipped without one): each kernel against
  its plain version on the same tensors, on the procedural mesh scene of
  chip_smoke.py.  Gates: closest_hit kind and t (1e-4) and any_hit flags on
  >= 99.9 % of lanes (the kernel walks clusters in its own octant's order,
  so only exact ties may resolve otherwise); fused_bounce every plane bit
  for bit (three bounces of the camera rays, and the edge lanes below at
  bounce 3) and fused_frame every plane bit for bit with the rays per
  bounce exact, both also on all-dead, 2 %-scattered and ragged lanes and
  on live counts that give each warp 3 or 20 lanes (run one at a time)
  (chip_smoke.FRAME_EDGES), with every live lane queued (both are built
  with --fmad=false and evaluate in the plain version's order, and a path's
  result does not depend on the thread that runs it); sort_chunks keys,
  lane ids and every plane bit for bit equal to
  its plain version's (a stable torch.sort), at chunks 2 to 32 768 on
  random, all-dead, all-equal, sorted and reversed keys with 0 or 16
  planes, one launch a call.  Run there with
  ``python -m pytest --noconftest tests/test_torch_mesh_kernels.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.camera import default_camera  # noqa: E402
from spt_tpu_torch.engine.renderer import Renderer  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.lights import default_lights  # noqa: E402
from spt_tpu_torch.ops import bvh as tbvh  # noqa: E402
from spt_tpu_torch.ops import cuda_bounce, cuda_sort, cuda_trace  # noqa: E402
from spt_tpu_torch.ops.vec3 import Vec3  # noqa: E402

CPU = torch.device("cpu")


def _mesh(dev, w, h, cluster_size=64, **kw):
    """(cfg, scene, lights, primary PathState) of chip_smoke's mesh scene."""
    desc, cfg, cam = chip_smoke.port_mesh_scene(**kw)
    cfg = cfg.replace(width=w, height=h)
    cam.set_aspect_ratio(w / h)
    scene = tscene.flatten_scene(desc, dev, cluster_size=cluster_size)
    return cfg, scene, default_lights(dev), ttr.gen_primary(cfg, cam.rays(dev), 1)


# --- CPU: wrappers, layouts, refusals ------------------------------------------

def test_wrappers_on_cpu_run_the_plain_versions():
    cfg, scene, lights, ps = _mesh(CPU, 32, 24, stacks=8, slices=12)
    assert cuda_bounce._accel_mode(scene) == "resident"
    counts = (cuda_bounce.LAUNCHES, cuda_bounce.BOUNCE_LAUNCHES,
              cuda_trace.CLOSEST_LAUNCHES, cuda_trace.ANY_LAUNCHES,
              cuda_sort.LAUNCHES)
    a = scene.accel
    hit = cuda_trace.closest_hit(a, scene, ps.origin, ps.direction, 0.0, 1e30)
    ref = cuda_trace.closest_hit_reference(a, scene, ps.origin, ps.direction,
                                           0.0, 1e30)
    assert torch.equal(hit.t, ref.t) and torch.equal(hit.kind, ref.kind)
    assert int(torch.isfinite(hit.t).sum()) > 0
    blk = cuda_trace.any_hit(a, scene, ps.origin, ps.direction, 1e-4, 2.0)
    assert torch.equal(blk, cuda_trace.any_hit_reference(
        a, scene, ps.origin, ps.direction, 1e-4, 2.0))
    nb, missed = cuda_bounce.fused_bounce(cfg, scene, lights, ps, 0, False)
    rb, rmissed = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps, 0,
                                                     False)
    assert torch.equal(missed, rmissed) and torch.equal(nb.rng, rb.rng)
    fr = cuda_bounce.fused_frame(cfg, scene, lights, ps, start_bounce=1)
    assert fr[4].tolist()[0] == 0 and int(fr[4][1]) == int(ps.alive.sum())
    key = torch.randint(0, 2 ** 32, (4096,), dtype=torch.int64)
    sk, lane, out = cuda_sort.sort_chunks(key, [key], 2048)
    assert torch.equal(out[0], sk) and torch.equal(key[lane], sk)
    assert counts == (cuda_bounce.LAUNCHES, cuda_bounce.BOUNCE_LAUNCHES,
                      cuda_trace.CLOSEST_LAUNCHES, cuda_trace.ANY_LAUNCHES,
                      cuda_sort.LAUNCHES)


def _frame_scene(monkeypatch, mode):
    """(cfg, scene, lights, primary PathState) at 16x12 depth 4 in an accel
    mode: the default scene (None), or the reduced mesh scene, instanced
    grid or baked grid with the resident tier's limits lowered under their
    triangle counts (the instanced and stream gates)."""
    if mode is None:
        cfg = chip_smoke.port_mesh_scene()[1].replace(width=16, height=12)
        cam = default_camera(16, 12)
        scene = tscene.flatten_scene(tscene.build_default_scene(), CPU)
        return cfg, scene, default_lights(CPU), ttr.gen_primary(
            cfg, cam.rays(CPU), 1)
    build = {"resident": chip_smoke.port_mesh_scene,
             "instanced": chip_smoke.port_inst_scene,
             "stream": chip_smoke.port_stream_scene}[mode]
    desc, cfg, cam = build(stacks=8, slices=12)
    if mode != "resident":
        n = sum(m.triangle_count for m in desc.meshes)
        if mode == "instanced":
            n = tscene.flatten_scene(desc, CPU).num_triangles
        monkeypatch.setattr(tbvh, "MAX_RESIDENT_TRIS", n - 1)
        if mode == "stream":
            monkeypatch.setattr(cuda_bounce, "MAX_ACCEL_TRIS", n - 1)
    cfg = cfg.replace(width=16, height=12)
    cam.set_aspect_ratio(16 / 12)
    scene = tscene.flatten_scene(desc, CPU)
    return cfg, scene, default_lights(CPU), ttr.gen_primary(cfg, cam.rays(CPU), 1)


@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("mode", [None, "resident", "instanced", "stream"])
def test_fused_frame_on_cpu_returns_the_kernels_dtypes(monkeypatch, mode,
                                                       start):
    # every form hands back missed as bool and the rays per bounce as
    # (max_depth,) int64, as the kernels do; the counts are those of the
    # plain version's per-lane bounce totals
    cfg, scene, lights, ps = _frame_scene(monkeypatch, mode)
    assert cuda_bounce._accel_mode(scene) == mode
    before = cuda_bounce.LAUNCHES
    out = cuda_bounce.fused_frame(cfg, scene, lights, ps, start_bounce=start)
    assert cuda_bounce.LAUNCHES == before
    n = ps.num_paths
    assert out[3].dtype == torch.bool and out[3].shape == (n,)
    assert out[4].dtype == torch.int64 and out[4].shape == (cfg.max_depth,)
    counts = torch.zeros(n, dtype=torch.int32)
    for b in range(start, cfg.max_depth):
        counts += ps.alive.to(torch.int32)
        ps, _ = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps, b,
                                                   b == cfg.max_depth - 1)
    assert torch.equal(out[4], cuda_bounce.rays_from_counts(
        counts, cfg.max_depth, start))
    assert int(out[4][start]) == n and not out[4][:start].any()


@pytest.mark.parametrize("bounce", [0, 2])
@pytest.mark.parametrize("mode", [None, "resident", "instanced", "stream"])
def test_fused_bounce_on_cpu_returns_the_kernels_dtypes(monkeypatch, mode,
                                                        bounce):
    # every form hands back the RNG words as int64 and alive, emission_ok
    # and missed as bool, as the kernels write them, equal to the plain
    # version's
    cfg, scene, lights, ps = _frame_scene(monkeypatch, mode)
    assert cuda_bounce._accel_mode(scene) == mode
    for b in range(bounce):
        ps, _ = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps, b,
                                                   False)
    before = cuda_bounce.BOUNCE_LAUNCHES
    got, missed = cuda_bounce.fused_bounce(cfg, scene, lights, ps, bounce,
                                           False)
    assert cuda_bounce.BOUNCE_LAUNCHES == before
    want, wmissed = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps,
                                                       bounce, False)
    n = ps.num_paths
    assert got.rng.dtype == torch.int64 and got.rng.shape == (n,)
    for t in (got.alive, got.emission_ok, missed):
        assert t.dtype == torch.bool and t.shape == (n,)
    assert torch.equal(missed, wmissed)
    for x, y in zip(got, want):
        for a, b in zip(*((x, y) if isinstance(x, tuple) else ((x,), (y,)))):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert 0 < int(got.alive.sum()) < n


@pytest.mark.parametrize("mode", [None, "resident"])
def test_kernel_inputs_hand_over_the_path_state_as_it_is(monkeypatch, mode):
    # the RNG words and flags reach the kernels as the port holds them
    # (int64, bool): the pointers handed over are the tensors' own, so the
    # wrapper launches no conversion; a strided flag plane is refused
    cfg, scene, lights, ps = _frame_scene(monkeypatch, mode)
    ptrs, _, keep = cuda_bounce._kernel_inputs(cfg, scene, lights, ps,
                                               "fused_bounce")
    state = (ps.rng, ps.alive, ps.emission_ok)
    assert ptrs[12:15] == [t.data_ptr() for t in state]
    assert all(any(k is t for k in keep) for t in state)
    strided = torch.zeros(2 * ps.num_paths, dtype=torch.bool)[::2]
    with pytest.raises(ValueError, match="alive must be a contiguous"):
        cuda_bounce._kernel_inputs(cfg, scene, lights,
                                   ps._replace(alive=strided), "fused_bounce")


def test_resident_tables_layout():
    # the kernels read this buffer by fixed row widths: spheres, materials,
    # lights, then the cluster boxes and the octant keys' bits
    cfg, scene, lights, _ = _mesh(CPU, 8, 8, stacks=8, slices=12)
    a = scene.accel
    buf = cuda_bounce._pack_tables(scene, lights, nee_on=False,
                                   mode="resident")
    assert buf.numel() == cuda_bounce._table_words(scene, lights, False,
                                                   "resident")
    s, m, n_l, c = (scene.num_spheres, scene.materials.count, lights.count,
                    a.num_clusters)
    off = s * 5 + m * 12 + n_l * 11
    assert torch.equal(buf[:s * 5].reshape(s, 5)[:, :3], scene.sph_center)
    boxes = buf[off:off + c * 6].reshape(c, 6)
    assert torch.equal(boxes[:, :3], a.cluster_lo)
    assert torch.equal(boxes[:, 3:], a.cluster_hi)
    keys = buf[off + c * 6:].contiguous().view(torch.int32).reshape(8, c)
    assert torch.equal(keys, a.cl_okey[:, :, 0])
    # every octant's keys rank the clusters 0..C-1 (the kernel inverts them)
    ranks = torch.sort(keys >> 16, dim=1).values
    assert torch.equal(ranks, torch.arange(c, dtype=torch.int32).expand(8, c))
    assert cuda_bounce._flags(cfg, scene, False, "resident") & 128 == 0
    assert cuda_bounce.explain_decline(cfg, scene, lights) is None


def test_only_a_mesh_past_the_cluster_cap_raises(monkeypatch):
    big = tscene.SceneDesc()
    big.add_material(tscene.Material())
    big.add_instance(big.add_mesh(tscene.create_sphere_mesh(stacks=80,
                                                            slices=80)))
    # the stream tier takes it (K8); past MAX_STREAM_CLUSTERS it raises
    assert cuda_bounce._accel_mode(tscene.flatten_scene(big, CPU)) == "stream"
    monkeypatch.setattr(tbvh, "MAX_STREAM_CLUSTERS", 192)
    with pytest.raises(NotImplementedError, match="MAX_STREAM_CLUSTERS"):
        tscene.flatten_scene(big, CPU)
    monkeypatch.undo()
    # two instances of one 6400-triangle mesh take the instanced tier now
    inst = tscene.SceneDesc()
    inst.add_material(tscene.Material())
    mid = inst.add_mesh(tscene.create_sphere_mesh(stacks=40, slices=80))
    inst.add_instance(mid)
    inst.add_instance(mid, tscene.desc.translate(np.eye(4, dtype=np.float32),
                                                 [2.0, 0.0, 0.0]))
    assert cuda_bounce._accel_mode(tscene.flatten_scene(inst, CPU)) == "instanced"
    inst.add_instance(inst.add_mesh(tscene.create_sphere_mesh(stacks=40,
                                                              slices=80)))
    assert cuda_bounce._accel_mode(tscene.flatten_scene(inst, CPU)) == "stream"
    # more than 32 spheres beside a mesh, and more than 192 primitives
    # without an accel, flatten and render through the unfused route
    balls = tscene.SceneDesc()
    balls.add_material(tscene.Material())
    balls.add_instance(balls.add_mesh(tscene.create_sphere_mesh(8, 16)))
    for i in range(33):
        balls.add_sphere((i, 0.0, 0.0), 0.4, 0)
    only = tscene.SceneDesc()
    only.add_material(tscene.Material())
    for i in range(200):
        only.add_sphere((i, 0.0, 0.0), 0.4, 0)
    cfg = tconfig.RenderConfig(width=16, height=8, spp=1, max_depth=2)
    for desc, accel, why in ((balls, True, "MAX_ACCEL_SPHERES"),
                             (only, False, "no cluster accel")):
        r = Renderer(desc, cfg, camera=default_camera(16, 8), device=CPU)
        assert (r.scene.accel is not None) == accel
        assert cuda_bounce._accel_mode(r.scene) is None
        assert why in cuda_bounce.explain_decline(cfg, r.scene, r.lights)
        r.render_frames(1)
        assert np.isfinite(r.hdr_image()).all()
        assert int(r.last_stats.rays_per_bounce[0]) == 16 * 8
    # an accel past the resident tier takes the stream route, up to
    # MAX_STREAM_CLUSTERS clusters
    _, scene, _, _ = _mesh(CPU, 8, 8, stacks=8, slices=12)
    monkeypatch.setattr(cuda_bounce, "MAX_ACCEL_TRIS", 64)
    assert cuda_bounce._accel_mode(scene) == "stream"
    monkeypatch.setattr(tbvh, "MAX_STREAM_CLUSTERS", 0)
    with pytest.raises(NotImplementedError, match="MAX_STREAM_CLUSTERS"):
        cuda_bounce._accel_mode(scene)


def test_sorted_frame_pads_like_the_jax_package():
    # 40x30 = 1200 lanes do not tile: the sorted frame runs on 8192 padded
    # lanes and the image keeps the first 1200
    cfg, scene, lights, ps = _mesh(CPU, 40, 30, stacks=8, slices=12)
    assert twf.sort_padding(1200) == 8192 - 1200
    twf.SORTED_SAMPLES.clear()
    from spt_tpu_torch.env import make_procedural_environment

    env = make_procedural_environment(CPU)
    rad, stats = twf._wavefront_masked(cfg, scene, env, lights, ps)
    assert sum(twf.SORTED_SAMPLES.values()) == 1
    ref, rstats = twf._wavefront_masked(cfg.replace(ray_sort=False), scene,
                                        env, lights, ps)
    assert rad.shape == (1200, 3)
    np.testing.assert_allclose(rad.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(stats.rays_per_bounce, rstats.rays_per_bounce)


# --- the card --------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cluster_tracer_matches_plain_on_card(cuda_device):
    cfg, scene, _, ps = _mesh(cuda_device, 256, 192)
    a = scene.accel
    g = torch.Generator().manual_seed(3)
    n = 256 * 192
    ro = (torch.rand((n, 3), generator=g) * 3.0 - 1.5).to(cuda_device)
    rd = torch.randn((n, 3), generator=g)
    rd = (rd / rd.norm(dim=1, keepdim=True)).to(cuda_device)
    for o, d in ((ps.origin, ps.direction),
                 (Vec3(*ro.unbind(1)), Vec3(*rd.unbind(1)))):
        o = Vec3(*(c.contiguous() for c in o))
        d = Vec3(*(c.contiguous() for c in d))
        before = cuda_trace.CLOSEST_LAUNCHES
        k = cuda_trace.closest_hit(a, scene, o, d, 0.0, 1e30)
        assert cuda_trace.CLOSEST_LAUNCHES == before + 1
        p = cuda_trace.closest_hit_reference(a, scene, o, d, 0.0, 1e30)
        torch.cuda.synchronize()
        both = torch.isfinite(k.t) & torch.isfinite(p.t)
        off = ((k.kind != p.kind) | (torch.isfinite(k.t) != torch.isfinite(p.t))
               | (both & ((k.t - p.t).abs() > 1e-4)))
        assert float(off.float().mean()) <= 1e-3
        # a third of the lanes with an empty interval, which count blocked
        tmax = torch.where(torch.arange(n, device=cuda_device) % 3 == 0,
                           0.0, 2.0)
        kb = cuda_trace.any_hit(a, scene, o, d, 1e-4, tmax)
        pb = cuda_trace.any_hit_reference(a, scene, o, d, 1e-4, tmax)
        torch.cuda.synchronize()
        assert float((kb != pb).float().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("case", [None, *chip_smoke.FRAME_EDGES])
def test_fused_bounce_matches_plain_on_card(cuda_device, case):
    # every plane bit for bit: three bounces of the camera rays, and the
    # edge lanes (chip_smoke.FRAME_EDGES) at bounce 3, the last of depth 4,
    # with every live lane queued and the warps' take as the case says
    cfg, scene, lights, ps = _mesh(cuda_device, 256, 192)
    if case is None:
        calls = [(bounce, False) for bounce in range(3)]
    else:
        grid = chip_smoke.bounce_grid(torch, cfg, scene, lights, ps)
        ps, start = chip_smoke.frame_edge(torch, np, case, ps, grid)
        calls = [(start, start == cfg.max_depth - 1)]
    for bounce, is_last in calls:
        before = cuda_bounce.BOUNCE_LAUNCHES
        k, km = cuda_bounce.fused_bounce(cfg, scene, lights, ps, bounce,
                                         is_last)
        assert cuda_bounce.BOUNCE_LAUNCHES == before + 1
        p, pm = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps,
                                                   bounce, is_last)
        torch.cuda.synchronize()
        for name, (a, b) in chip_smoke._state_planes(torch, k, km, p,
                                                     pm).items():
            assert a.dtype == b.dtype and chip_smoke._same_bits(
                torch, a, b), name
        assert chip_smoke.frame_counters(torch, k.rng)[0] == int(
            ps.alive.sum())
        if case is not None and case.startswith("take"):
            assert chip_smoke.frame_take(torch, k.rng) == chip_smoke.edge_take(
                case)
        ps = p


@pytest.mark.cuda
@pytest.mark.parametrize("start,cluster_size,case", [
    (0, 64, None), (3, 64, None), (0, 8, None),
    *((None, 64, case) for case in chip_smoke.FRAME_EDGES)])
def test_resident_fused_frame_matches_plain_on_card(cuda_device, start,
                                                    cluster_size, case):
    # cluster_size 8: 784 clusters, whose tables need the shared-memory
    # opt-in above 48 KiB, and one 8-row sub-block per cluster; the edge
    # cases (chip_smoke.FRAME_EDGES) start at bounce 3
    cfg, scene, lights, ps = _mesh(cuda_device, 256, 192, cluster_size)
    if case is not None:
        grid = chip_smoke.frame_grid(torch, cfg, scene, lights, ps)
        ps, start = chip_smoke.frame_edge(torch, np, case, ps, grid)
    before = cuda_bounce.LAUNCHES
    k = cuda_bounce.fused_frame(cfg, scene, lights, ps, start_bounce=start)
    assert cuda_bounce.LAUNCHES == before + 1
    p = cuda_bounce.fused_frame_reference(cfg, scene, lights, ps,
                                          start_bounce=start)
    torch.cuda.synchronize()
    same = chip_smoke.frame_bits_equal(torch, k, p)
    assert all(same.values()), same
    assert chip_smoke.frame_counters(torch, k[4])[0] == int(ps.alive.sum())
    if case is not None and case.startswith("take"):
        assert chip_smoke.frame_take(torch, k[4]) == chip_smoke.edge_take(case)


def _sort_keys(chunk, pattern, g):
    """(4 * chunk,) int64 keys holding uint32 values: random with 40 % dead
    lanes and a long run of one key, all dead, all equal, or few distinct
    values (so, many ties) already sorted or reversed within each chunk."""
    n = 4 * chunk
    if pattern == "random":
        key = torch.randint(0, 2 ** 32, (n,), generator=g, dtype=torch.int64)
        key[torch.rand(n, generator=g) < 0.4] = 0xFFFFFFFF
        key[: n // 8] = 5  # long runs of equal keys
        return key
    if pattern in ("dead", "equal"):
        return torch.full((n,), 0xFFFFFFFF if pattern == "dead" else 0x5EED,
                          dtype=torch.int64)
    few = torch.randint(0, 2 ** 32, (max(2, chunk // 16),), generator=g,
                        dtype=torch.int64)
    key = few[torch.randint(0, few.numel(), (n,), generator=g)]
    key = torch.sort(key.reshape(-1, chunk), dim=1).values
    return (key if pattern == "sorted" else key.flip(1)).reshape(n)


def _sort_planes(n, count, g):
    """`count` planes: float32, int32 and int64 in turn."""
    planes = []
    for i in range(count):
        if i % 3 == 0:
            planes.append(torch.randn(n, generator=g))
        elif i % 3 == 1:
            planes.append(torch.randint(-2 ** 31, 2 ** 31, (n,), generator=g,
                                        dtype=torch.int64).to(torch.int32))
        else:
            planes.append(torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g,
                                        dtype=torch.int64))
    return planes


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [0, 16])
@pytest.mark.parametrize("pattern", ["random", "dead", "equal", "sorted",
                                     "reversed"])
@pytest.mark.parametrize("chunk", [2, 256, 2048, 8192, 32768])
def test_sort_chunks_matches_torch_sort_on_card(cuda_device, chunk, pattern,
                                                planes):
    # the sort is stable: keys, lane ids and every plane bit for bit equal
    # to the plain version's stable torch.sort and gathers, in one launch
    g = torch.Generator().manual_seed(chunk)
    key = _sort_keys(chunk, pattern, g)
    ops = [a.to(cuda_device) for a in _sort_planes(key.shape[0], planes, g)]
    key = key.to(cuda_device)
    before = cuda_sort.LAUNCHES
    sk, lane, out = cuda_sort.sort_chunks(key, ops, chunk)
    assert cuda_sort.LAUNCHES == before + 1
    rk, rl, ro = cuda_sort.sort_chunks_reference(key, ops, chunk)
    torch.cuda.synchronize()
    assert torch.equal(sk, rk)
    assert torch.equal(lane, rl)
    for got, want in zip(out, ro):
        if got.dtype.is_floating_point:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_mesh_renderer_runs_the_sorted_kernel_path_on_card(cuda_device):
    desc, cfg, cam = chip_smoke.port_mesh_scene(stacks=16, slices=24)
    r = Renderer(desc, cfg, camera=cam, device=cuda_device)
    # the replays' conditional bodies count on the device: launch_counts
    # folds them into the counters, before the counts are taken and after
    twf.launch_counts()
    twf.SORTED_SAMPLES.clear()
    counts = (cuda_bounce.LAUNCHES, cuda_bounce.BOUNCE_LAUNCHES)
    r.render_frames(2)
    torch.cuda.synchronize()
    twf.launch_counts()
    assert sum(twf.SORTED_SAMPLES.values()) == 2
    assert cuda_bounce.LAUNCHES == counts[0] + 2
    assert cuda_bounce.BOUNCE_LAUNCHES == counts[1] + 6
    img = r.hdr_image()
    assert np.isfinite(img).all() and img.max() > 0
    assert int(r.last_stats.rays_per_bounce[0]) == 2 * cfg.width * cfg.height
