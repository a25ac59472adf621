"""The fused_frame kernel module of spt_tpu_torch.

- On the CPU: ``cuda_bounce.fused_frame_reference`` (the kernel's plain
  PyTorch version) against ``spt_tpu.ops.pallas_bounce.fused_frame`` run
  through the Pallas interpreter, from the same primary rays.  Tolerance:
  radiance, direction and throughput at rtol 1e-4 / atol 1e-5 on >= 99.5 %
  of lanes (over four bounces a lane may take the other side of a branch on
  a last-bit difference of the frameworks' CPU rsqrt/sin/cos), and
  rays_per_bounce exact.
- On a CUDA card (marker ``cuda``; skipped without one): the CUDA kernel
  against its plain version on the same tensors, every plane bit for bit
  and the rays per bounce exact, on every RenderConfig toggle the kernel
  reads and on the lanes the small form's refill has to get right (a
  ragged count, all dead, a start at max_depth, a handful of long paths);
  fused_bounce's small form likewise, every returned plane bit for bit, on
  three scenes over three bounces and on the lanes its persistent
  grid-stride loop has to get right (``chip_smoke.SMALL_BOUNCE_EDGES`` and
  more lanes than one round of the grid).
- The whole-frame form (``cuda_bounce.whole_frame``): on the CPU, which
  frames take it (``wavefront._whole_frame_ok``), that a CPU StaticStep
  packs no tables ahead and that ``frame_tables`` packs what a launch
  packs; on the card, its accumulation after three frames byte for byte
  with the split frame's (``frame_chain``: fused_frame and the PyTorch code
  around it) at 1920x1080 on the whole frame and each of four bands, in
  both placements of the tables, with and without the pixel jitter, from a
  frame index about to wrap; a card StaticStep packs its tables once and
  launches the form once a frame.
- On the CPU, fused_bounce's small form: ``fused_bounce_reference`` against
  ``spt_tpu.ops.pallas_bounce.fused_bounce`` in interpret mode, at bounce 0
  and at bounce 1 as the last with every third lane dead; the RNG words,
  alive and missed bit-exact, the float planes at the tolerance above.
  Run there with
  ``python -m pytest --noconftest tests/test_torch_fused_frame.py -m cuda``
  (JAX is imported only by the CPU tests, and tests/conftest.py imports
  JAX, so the flag lets the card tests run where JAX is not installed).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch import env as tenv  # noqa: E402
from spt_tpu_torch.camera import Camera, default_camera  # noqa: E402
from spt_tpu_torch.engine import state as state_mod  # noqa: E402
from spt_tpu_torch.engine.renderer import StaticStep, frame_chain  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.lights import LightManager, default_lights  # noqa: E402
from spt_tpu_torch.ops import cuda_bounce  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def interpret_pallas(monkeypatch):
    """spt_tpu's Pallas modules, with pallas_call in interpret mode (as
    tests/test_pallas.py runs them)."""
    pytest.importorskip("jax")
    import jax.experimental.pallas as pl

    import spt_tpu.ops.pallas_bounce as pb

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pb.pl, "pallas_call", patched)
    return pb


def _jax_workload(name, w, h, depth):
    from spt_tpu.camera import Camera as JaxCamera
    from spt_tpu.camera import default_camera as jax_default_camera
    from spt_tpu.config import RenderConfig
    from spt_tpu.lights import LightManager as JaxLightManager
    from spt_tpu.lights import default_lights as jax_default_lights
    from spt_tpu.scene import (build_cornell_box_scene, build_default_scene,
                               flatten_scene)

    cfg = RenderConfig(width=w, height=h, spp=1, max_depth=depth)
    if name == "cornell":
        cam = JaxCamera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                        fov_degrees=50.0, aspect_ratio=w / h).rays()
        return cfg, flatten_scene(build_cornell_box_scene()), JaxLightManager().device(), cam
    return (cfg, flatten_scene(build_default_scene()), jax_default_lights(),
            jax_default_camera(w, h).rays())


def _stack(v):
    return np.stack([np.asarray(c) for c in v], -1)


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_reference_matches_pallas_fused_frame(interpret_pallas, name):
    from spt_tpu.integrators import transport as jtr

    from spt_tpu_torch import interop

    jcfg, js, jl, cam = _jax_workload(name, 32, 32, 4)
    ps = jtr.gen_primary(jcfg, cam, 1)
    want = interpret_pallas.fused_frame(jcfg, js, jl, ps)

    tcfg = tconfig.RenderConfig(width=32, height=32, spp=1, max_depth=4)
    got = cuda_bounce.fused_frame_reference(
        tcfg, interop.scene(js, CPU), interop.lights(jl, CPU),
        interop.path_state(ps, CPU))
    for g, w in zip(got[:3], want[:3]):
        g = torch.stack(list(g), -1).numpy()
        w = _stack(w)
        ok = (np.abs(g - w) <= 1e-5 + 1e-4 * np.abs(w)).all(-1)
        assert ok.mean() >= 0.995, f"{(~ok).sum()} lanes off"
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert (got[3].numpy() == np.asarray(want[3])).mean() >= 0.995
    assert int(got[4][0]) == 32 * 32


@pytest.mark.parametrize("name", ["default", "cornell"])
@pytest.mark.parametrize("bounce", [0, 1])
def test_small_bounce_reference_matches_pallas_fused_bounce(interpret_pallas,
                                                            name, bounce):
    # fused_bounce's small form (the compact path's bounce 0) against the
    # Pallas kernel itself: at bounce 0 with every lane alive, and at bounce
    # 1 as the last bounce with every third lane dead.  The RNG words and
    # the flags bit-exact; the float planes at fused_frame's tolerance
    from spt_tpu.integrators import transport as jtr

    from spt_tpu_torch import interop

    jcfg, js, jl, cam = _jax_workload(name, 32, 32, 4)
    ps = jtr.gen_primary(jcfg, cam, 1)
    is_last = bounce == 1
    if is_last:
        ps = ps._replace(alive=ps.alive & (np.arange(32 * 32) % 3 != 0))
    assert interpret_pallas._accel_mode(js) is None
    want, wmissed = interpret_pallas.fused_bounce(jcfg, js, jl, ps, bounce,
                                                  is_last)

    tcfg = tconfig.RenderConfig(width=32, height=32, spp=1, max_depth=4)
    ts = interop.scene(js, CPU)
    assert cuda_bounce._accel_mode(ts) is None
    before = cuda_bounce.BOUNCE_LAUNCHES
    got, gmissed = cuda_bounce.fused_bounce_reference(
        tcfg, ts, interop.lights(jl, CPU), interop.path_state(ps, CPU),
        bounce, is_last)
    assert cuda_bounce.BOUNCE_LAUNCHES == before
    for g, w in zip((got.origin, got.direction, got.throughput, got.radiance),
                    (want.origin, want.direction, want.throughput,
                     want.radiance)):
        g = torch.stack(list(g), -1).numpy()
        w = _stack(w)
        ok = (np.abs(g - w) <= 1e-5 + 1e-4 * np.abs(w)).all(-1)
        assert ok.mean() >= 0.995, f"{(~ok).sum()} lanes off"
    assert got.rng.dtype == torch.int64
    np.testing.assert_array_equal(
        got.rng.numpy(), np.asarray(want.rng, np.uint32).astype(np.int64))
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    np.testing.assert_array_equal(gmissed.numpy(), np.asarray(wmissed))
    dead = ~np.asarray(ps.alive)
    assert dead.sum() == (342 if is_last else 0)
    assert not gmissed.numpy()[dead].any() and not got.alive.numpy()[dead].any()


def test_wrapper_on_cpu_runs_the_plain_version():
    cfg = tconfig.RenderConfig(width=16, height=8, max_depth=3)
    scene = tscene.flatten_scene(tscene.build_default_scene(), CPU)
    lights = default_lights(CPU)
    ps = ttr.gen_primary(cfg, default_camera(16, 8).rays(CPU), 0)
    before = cuda_bounce.LAUNCHES
    a = cuda_bounce.fused_frame(cfg, scene, lights, ps)
    b = cuda_bounce.fused_frame_reference(cfg, scene, lights, ps)
    assert cuda_bounce.LAUNCHES == before
    for x, y in zip(a[:3], b[:3]):
        for cx, cy in zip(x, y):
            assert torch.equal(cx, cy)
    assert torch.equal(a[4], b[4])


def test_start_bounce_zeroes_earlier_counts():
    cfg = tconfig.RenderConfig(width=16, height=8, max_depth=4)
    scene = tscene.flatten_scene(tscene.build_default_scene(), CPU)
    ps = ttr.gen_primary(cfg, default_camera(16, 8).rays(CPU), 0)
    rays = cuda_bounce.fused_frame(cfg, scene, default_lights(CPU), ps,
                                   start_bounce=2)[4]
    assert rays.tolist()[:2] == [0, 0] and int(rays[2]) == 16 * 8


def test_pack_tables_layout():
    # the CUDA kernel reads this buffer by fixed row widths; check the
    # layout where the kernel itself cannot run
    scene = tscene.flatten_scene(tscene.build_cornell_box_scene(), CPU)
    lm = LightManager()
    lm.add_point_light((1.0, 2.0, 3.0), (0.5, 0.25, 1.0), 4.0)
    lights = lm.device(CPU, pad_multiple=2)
    cfg = tconfig.RenderConfig()
    buf = cuda_bounce._pack_tables(scene, lights, nee_on=True)
    assert buf.dtype == torch.float32 and buf.is_contiguous()
    assert buf.numel() == cuda_bounce._table_words(scene, lights, True)
    # the small layout: triangle rows of 12 words and sphere rows of 8, so
    # that each starts on a 16-byte boundary; the padding words are zero
    t, s, m = scene.num_triangles, scene.num_spheres, scene.materials.count
    tri = buf[:t * 12].reshape(t, 12)
    assert torch.equal(tri[:, 0:3], scene.tri_v0)
    assert torch.equal(tri[:, 3:6], scene.tri_e1)
    assert torch.equal(tri[:, 6:9], scene.tri_e2)
    assert torch.equal(tri[:, 9].contiguous().view(torch.int32), scene.tri_mat)
    assert (tri[:, 10:] == 0).all()
    sph = buf[t * 12:t * 12 + s * 8].reshape(s, 8)
    assert torch.equal(sph[:, 0:3], scene.sph_center)
    assert torch.equal(sph[:, 3], scene.sph_radius)
    assert torch.equal(sph[:, 4].contiguous().view(torch.int32), scene.sph_mat)
    assert (sph[:, 5:] == 0).all()
    off = t * 12 + s * 8
    assert off % 4 == 0
    mat = buf[off:off + m * 12].reshape(m, 12)
    assert torch.equal(mat[:, 6].contiguous().view(torch.int32),
                       scene.materials.mat_type)
    assert torch.equal(mat[:, 7:10], scene.materials.emission)
    assert (mat[:, 11].contiguous().view(torch.int32) == -1).all()
    off += m * 12
    lt = buf[off:off + 2 * 11].reshape(2, 11)
    assert lt[:, 0].contiguous().view(torch.int32).tolist() == [2, 0]
    assert lt[0, 7] == 4.0 and lt[0, 1:4].tolist() == [1.0, 2.0, 3.0]
    em = buf[off + 22:].reshape(-1, 13)
    assert torch.equal(em[:, 12], scene.emitters.area)
    assert cuda_bounce._flags(cfg, scene, True) == 0b0000111


def test_explain_decline_names_the_cap():
    desc = tscene.SceneDesc()
    for i in range(cuda_bounce.MAX_MATERIALS + 1):
        desc.add_material(tscene.Material(base_color=(0.5, 0.5, i * 0.01)))
    desc.add_sphere((0, 0, 0), 1.0, 0)
    scene = tscene.flatten_scene(desc, CPU)
    cfg = tconfig.RenderConfig()
    reason = cuda_bounce.explain_decline(cfg, scene, default_lights(CPU))
    assert reason is not None and "materials" in reason
    ok = tscene.flatten_scene(tscene.build_default_scene(), CPU)
    assert cuda_bounce.explain_decline(cfg, ok, default_lights(CPU)) is None


def _whole_case(case):
    """(cfg, scene, env, lights, start_bounce) of a frame that takes the
    whole-frame form ("default") or of one that does not (the others)."""
    cfg = tconfig.RenderConfig(width=32, height=16, spp=1, max_depth=6)
    desc, lights = tscene.build_default_scene(), default_lights(CPU)
    env = tenv.make_procedural_environment(CPU)
    start = 0
    if case == "hdr":
        env = tenv.make_hdr_environment(tenv.synthetic_equirect(16), CPU)
    elif case == "mesh":
        desc, cfg, _ = chip_smoke.port_mesh_scene(stacks=12, slices=16)
        lights = default_lights(CPU)
    elif case in ("compact", "regen", "megakernel"):
        cfg = cfg.replace(integrator=case)
    elif case == "spp2":
        cfg = cfg.replace(spp=2)
    elif case == "start1":
        start = 1
    scene = tscene.flatten_scene(desc, CPU)
    return cfg, scene, env, lights, start


@pytest.mark.parametrize("case, whole", [
    ("default", True), ("hdr", False), ("mesh", False), ("compact", False),
    ("regen", False), ("megakernel", False), ("spp2", False),
    ("start1", False)])
def test_whole_frame_ok_takes_the_masked_small_sky_frame_only(case, whole):
    # masked, spp 1, from bounce 0, a small scene, the procedural sky: an
    # HDR map (K2), a mesh accel, the other integrators, spp > 1 and a
    # start past bounce 0 run the split frame
    cfg, scene, env, lights, start = _whole_case(case)
    if case == "mesh":
        assert cuda_bounce._accel_mode(scene) == "resident"
    assert twf._whole_frame_ok(cfg, scene, env, lights, start) is whole


def _count_packs(monkeypatch) -> list:
    """The calls of ``cuda_bounce._pack_tables`` from here on, recorded."""
    calls = []
    pack = cuda_bounce._pack_tables

    def counted(*a, **kw):
        calls.append(a)
        return pack(*a, **kw)

    monkeypatch.setattr(cuda_bounce, "_pack_tables", counted)
    return calls


def _packed_once(monkeypatch, cfg, scene, env, lights, dev):
    """A StaticStep built and run three frames on `dev`, the tables it
    packed counted -> (step, the number of packs)."""
    calls = _count_packs(monkeypatch)
    step = StaticStep(cfg, scene, env, lights, dev)
    step.load(default_camera(cfg.width, cfg.height).rays(dev), step.state)
    for _ in range(3):
        step.frame()
    return step, len(calls)


def test_static_step_packs_the_tables_once(monkeypatch):
    # the whole-frame form (on the card) reads tables packed when the step
    # is built, not in every (captured) frame, and they are the ones a
    # launch packs; a CPU step runs the split frame and packs nothing
    # ahead (the card's count: ..._once_on_card)
    cfg, scene, env, lights, _ = _whole_case("default")
    assert twf._whole_frame_ok(cfg, scene, env, lights)
    step, packs = _packed_once(monkeypatch, cfg, scene, env, lights, CPU)
    assert not step.whole and step.tables is None and packs == 0
    # the packing a launch does; compared as words: an int column of -1 is
    # a NaN as a float
    fresh = cuda_bounce.frame_tables(cfg, scene, lights)
    assert torch.equal(fresh.view(torch.int32), cuda_bounce._pack_tables(
        scene, lights, scene.emitters is not None, None).view(torch.int32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused_frame kernel has no CPU mode")
    return torch.device("cuda", 0)


# Card cases: every RenderConfig toggle the kernel reads, point lights,
# shading normals and starts past bounce 0 (cornell at depth 8).
CARD_CASES = [
    ("default", {}, 0), ("cornell", {}, 0),
    ("default", "gpu_parity", 0), ("cornell", "gpu_parity", 0),
    ("default", {"metal_mirror": True}, 0),
    ("cornell", {"cpu_transparency": True, "direct_light_dielectric": True}, 0),
    ("cornell", {"nee": False, "rr_after": 0}, 0),
    ("smooth_point", {}, 0), ("smooth_point", "gpu_parity", 0),
    ("default", {}, 2), ("cornell", {}, 2),
]

# Lanes the small form's refill has to get right: a count that is no
# multiple of a warp, a block or the kernel's chunk of lanes; every lane
# dead; a start at max_depth, where no bounce runs; and only a handful of
# long paths alive among dead lanes.
EDGE_CASES = ["ragged", "all_dead", "start_at_depth", "few_long"]


def _card_workload(name, preset, dev, w, h):
    if preset == "gpu_parity":
        cfg = tconfig.GPU_PARITY.replace(width=w, height=h)
    else:
        cfg = tconfig.RenderConfig(width=w, height=h, **preset)
    if name == "cornell":
        cam = Camera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                     fov_degrees=50.0, aspect_ratio=w / h)
        return (cfg.replace(max_depth=8), tscene.build_cornell_box_scene(),
                LightManager().device(dev), cam)
    desc = tscene.build_default_scene()
    lights = default_lights(dev)
    if name == "smooth_point":
        mid = desc.add_mesh(tscene.create_sphere_mesh(stacks=6, slices=8,
                                                      radius=1.0))
        desc.add_instance(mid, tscene.desc.translate(
            np.eye(4, dtype=np.float32), [0.0, 2.5, 0.5]), material_id=7)
        lm = LightManager()
        lm.add_directional_light([-0.5, -1.0, 0.3], [1.0, 0.95, 0.8], 2.0)
        lm.add_point_light([0.0, 4.0, 2.0], [1.0, 0.8, 0.6], 20.0)
        lights = lm.device(dev, pad_multiple=4)
    return cfg, desc, lights, default_camera(w, h)


def _assert_bit_equal(k, p, start):
    """The kernel's five results against the plain version's: radiance,
    direction and throughput bit for bit, missed_ever and rays_per_bounce
    equal."""
    for a, b in zip(k[:3], p[:3]):
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert torch.equal(k[3], p[3])
    assert k[4].dtype == p[4].dtype == torch.int64
    assert torch.equal(k[4], p[4])
    assert not k[4][:start].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name,preset,start", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, name, preset, start):
    # same lanes through the kernel and its plain version on the card; both
    # round op for op alike (--fmad=false, no fast math), and a path's
    # arithmetic does not depend on the thread that runs it: bit for bit
    w = h = 256
    cfg, desc, lights, cam = _card_workload(name, preset, cuda_device, w, h)
    scene = tscene.flatten_scene(desc, cuda_device)
    if name == "smooth_point":
        assert scene.tri_ns is not None
    ps = ttr.gen_primary(cfg, cam.rays(cuda_device), 2)
    before = cuda_bounce.LAUNCHES
    k = cuda_bounce.fused_frame(cfg, scene, lights, ps, start_bounce=start)
    assert cuda_bounce.LAUNCHES == before + 1
    p = cuda_bounce.fused_frame_reference(cfg, scene, lights, ps,
                                          start_bounce=start)
    torch.cuda.synchronize()
    _assert_bit_equal(k, p, start)
    assert int(k[4][start]) == w * h


def _lane_bounces(cfg, scene, lights, ps):
    """Bounces each lane's path runs from bounce 0 (the plain version)."""
    counts = torch.zeros(ps.num_paths, dtype=torch.int32, device=ps.rng.device)
    for b in range(cfg.max_depth):
        counts += ps.alive.to(torch.int32)
        ps, _ = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps, b,
                                                   b == cfg.max_depth - 1)
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_edge_lanes_match_plain_on_card(cuda_device, case):
    cfg, desc, lights, cam = _card_workload("cornell", {}, cuda_device, 256, 256)
    scene = tscene.flatten_scene(desc, cuda_device)
    ps = ttr.gen_primary(cfg, cam.rays(cuda_device), 3)
    start = 0
    if case == "ragged":
        n = 256 * 256 - 77
        ps = type(ps)(*(type(f)(*(c[:n].contiguous() for c in f))
                        if isinstance(f, tuple) else f[:n].contiguous()
                        for f in ps))
    elif case == "all_dead":
        ps = ps._replace(alive=torch.zeros_like(ps.alive))
    elif case == "start_at_depth":
        start = cfg.max_depth
    else:
        longest = torch.topk(_lane_bounces(cfg, scene, lights, ps), 5).indices
        alive = torch.zeros_like(ps.alive)
        alive[longest] = True
        ps = ps._replace(alive=alive)
    k = cuda_bounce.fused_frame(cfg, scene, lights, ps, start_bounce=start)
    p = cuda_bounce.fused_frame_reference(cfg, scene, lights, ps,
                                          start_bounce=start)
    torch.cuda.synchronize()
    _assert_bit_equal(k, p, start)
    live = {"ragged": 256 * 256 - 77, "all_dead": 0, "start_at_depth": 0,
            "few_long": 5}[case]
    assert int(k[4].max()) == live


def _assert_state_bits(k, p):
    """Two fused_bounce results (PathState, missed) bit for bit: every float
    plane, the int64 RNG words, the flags and missed."""
    (ks, km), (ps_, pm) = k, p
    for a, b in zip(ks, ps_):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert x.dtype == y.dtype and x.shape == y.shape
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y)
    assert km.dtype == pm.dtype == torch.bool
    assert torch.equal(km, pm)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default", "cornell", "smooth_point"])
def test_small_fused_bounce_matches_plain_on_card(cuda_device, name):
    # fused_bounce's small form reads the same small table layout: three
    # bounces, every returned plane bit for bit
    cfg, desc, lights, cam = _card_workload(name, {}, cuda_device, 128, 128)
    scene = tscene.flatten_scene(desc, cuda_device)
    ps = ttr.gen_primary(cfg, cam.rays(cuda_device), 1)
    for bounce in range(3):
        before = cuda_bounce.BOUNCE_LAUNCHES
        k, km = cuda_bounce.fused_bounce(cfg, scene, lights, ps, bounce, False)
        assert cuda_bounce.BOUNCE_LAUNCHES == before + 1
        p, pm = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps,
                                                   bounce, False)
        torch.cuda.synchronize()
        _assert_state_bits((k, km), (p, pm))
        ps = p


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.SMALL_BOUNCE_EDGES + ("rounds",))
def test_small_fused_bounce_edges_match_plain_on_card(cuda_device, case):
    # the lanes the small form's persistent grid-stride loop has to get
    # right (chip_smoke.SMALL_BOUNCE_EDGES from 128x128: all dead, a third
    # dead at random, 128 * 128 - 77 lanes, 1, 33, is_last at bounce 3),
    # and 1024x1024 lanes, more than one round of any grid the SMs hold at
    # once; every returned plane bit for bit
    w = h = 1024 if case == "rounds" else 128
    cfg, desc, lights, cam = _card_workload("cornell", {}, cuda_device, w, h)
    scene = tscene.flatten_scene(desc, cuda_device)
    ps = ttr.gen_primary(cfg, cam.rays(cuda_device), 4)
    if case == "rounds":
        bounce, is_last = 0, False
        assert chip_smoke.grid_rounds(torch, ps.num_paths) > 1
    else:
        ps, bounce, is_last = chip_smoke.small_bounce_edge(torch, np, case, ps)
    n = {"ragged": 128 * 128 - 77, "one": 1, "n33": 33}.get(case)
    assert n is None or ps.num_paths == n
    before = cuda_bounce.BOUNCE_LAUNCHES
    k = cuda_bounce.fused_bounce(cfg, scene, lights, ps, bounce, is_last)
    assert cuda_bounce.BOUNCE_LAUNCHES == before + 1
    p = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps, bounce,
                                           is_last)
    torch.cuda.synchronize()
    _assert_state_bits(k, p)
    if case == "all_dead":
        assert not k[1].any() and not k[0].alive.any()


# The whole-frame form against the split frame on the card: the default
# scene at depth 6 and cornell under the procedural sky at depth 8, the
# whole 1920x1080 frame and each of its four bands, the tables in shared
# and in global memory, the pixel jitter on and off.
WHOLE_CARD_CASES = [(name, band, in_global, jitter)
                    for name in ("default", "cornell")
                    for band in (None, 0, 1, 2, 3)
                    for in_global in (False, True)
                    for jitter in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,band,in_global,jitter", WHOLE_CARD_CASES)
def test_whole_frame_matches_split_frame_on_card(cuda_device, name, band,
                                                 in_global, jitter):
    # three frames from the same state, from a frame index about to wrap
    # (the int32 epoch passes 2**31 - 1): the accumulation byte for byte,
    # the counters and the rays per bounce equal
    w, h = 1920, 1080
    cfg, desc, lights, cam = _card_workload(name, {"jitter": jitter},
                                            cuda_device, w, h)
    scene = tscene.flatten_scene(desc, cuda_device)
    env = tenv.make_procedural_environment(cuda_device)
    assert twf._whole_frame_ok(cfg, scene, env, lights)
    row0, rows = (0, h) if band is None else (band * h // 4, h // 4)
    rays = cam.rays(cuda_device)
    st = state_mod.init_state(w * rows, cuda_device)
    st.frame_index.fill_(2 ** 31 - 2)
    want, wstats = frame_chain(cfg, scene, env, lights, rays,
                               state_mod.RenderState(*(t.clone() for t in st)),
                               3, row0, rows)
    cam_buf = torch.cat([rays.position, rays.forward, rays.right, rays.up,
                         rays.half_width.reshape(1),
                         rays.half_height.reshape(1)])
    tables = cuda_bounce.frame_tables(cfg, scene, lights)
    total = torch.zeros(cfg.max_depth, dtype=torch.int64, device=cuda_device)
    for _ in range(3):
        total += cuda_bounce.whole_frame(cfg, scene, lights, cam_buf, st.accum,
                                         st.frame_index, tables, row0,
                                         _in_global=in_global)
        state_mod.count_(st, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(st.accum.view(torch.int32), want.accum.view(torch.int32))
    assert torch.equal(st.sample_count, want.sample_count)
    assert torch.equal(st.frame_index, want.frame_index)
    assert int(st.frame_index) == -2 ** 31 + 1
    assert torch.equal(total, wstats.rays_per_bounce)
    assert int(total[0]) == 3 * w * rows


@pytest.mark.cuda
@pytest.mark.parametrize("jitter", [True, False])
def test_static_step_packs_the_tables_once_on_card(cuda_device, monkeypatch,
                                                   jitter):
    # the default 1080p step on the card takes its frames whole: its tables
    # packed once when it is built (the ones a launch packs), one shared
    # whole_frame launch a frame and no split one, the state after three
    # frames run eagerly bit for bit as frame_chain leaves it
    w, h = 1920, 1080
    cfg, desc, lights, cam = _card_workload("default", {"jitter": jitter},
                                            cuda_device, w, h)
    scene = tscene.flatten_scene(desc, cuda_device)
    env = tenv.make_procedural_environment(cuda_device)
    before = twf.launch_counts()
    step, packs = _packed_once(monkeypatch, cfg, scene, env, lights,
                               cuda_device)
    torch.cuda.synchronize()
    grew = {k: v - before.get(k, 0) for k, v in twf.launch_counts().items()
            if v != before.get(k, 0)}
    assert step.whole and packs == 1
    assert grew == {(cuda_bounce, "WHOLE_LAUNCHES"): 3}
    fresh = cuda_bounce._pack_tables(scene, lights,
                                     scene.emitters is not None, None)
    assert torch.equal(step.tables.view(torch.int32), fresh.view(torch.int32))
    want, _ = frame_chain(cfg, scene, env, lights, cam.rays(cuda_device),
                          state_mod.init_state(w * h, cuda_device), 3)
    for a, b in zip(step.state, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
