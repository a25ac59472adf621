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
  ragged count, all dead, a start at max_depth, a handful of long paths).
  Run there with
  ``python -m pytest --noconftest tests/test_torch_fused_frame.py -m cuda``
  (JAX is imported only by the CPU tests, and tests/conftest.py imports
  JAX, so the flag lets the card tests run where JAX is not installed).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.camera import Camera, default_camera  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
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
        for a, b in zip(k, p):
            for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
                if x.dtype == torch.float32:
                    x, y = x.view(torch.int32), y.view(torch.int32)
                assert torch.equal(x, y)
        assert torch.equal(km, pm)
        ps = p
