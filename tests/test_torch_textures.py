"""Textures in spt_tpu_torch (the packed table and its sampler, K6) against
spt_tpu.

On the CPU the same materials, texture coordinates and path states (made
with numpy from a seed) go through the JAX function and its port.  Gates,
each with its reason:

- choose_tex_res, build_texture_table, unpack_color / unpack_mr and the
  flattened texture coordinates: bit-exact (numpy host code and integer
  unpacking copied across; the port keeps one texel per row where the JAX
  package tiles (8, 128) blocks, so the tables compare through
  interop.textures);
- sample_texture_v: within 1e-6 on >= 99.9 % of lanes (the frameworks may
  round floor() of a uv a few ulps from an integer apart), exactly 1 on
  lanes with tex_id < 0;
- one textured shade_core bounce: the gates of tests/test_torch_transport.py
  (rng, alive and missed equal on >= 99.9 % of lanes, no lane's radiance
  off by more than 0.01);
- the checker of tests/test_textures.py:_quad_scene through the port's
  small form: its quadrants reach the film, and the image is within 1 %
  relative RMSE of the JAX Renderer's.

The plain BRDF's diffuse term (1 - metallic) / pi is a true float32
division: bit for bit numpy's on the CPU, and on a card the same as on the
CPU (PyTorch's CUDA kernels multiply by the reciprocal of a Python-scalar
divisor, which the kernels and the JAX package do not).

On a CUDA card (marker ``cuda``; skipped without one) the textured small
and resident forms of fused_frame and fused_bounce against their plain
versions (every plane of fused_bounce and fused_frame's radiance bit for
bit), and evaluate_brdf_v against its CPU result bit for bit.  Run
there with
``python -m pytest --noconftest tests/test_torch_textures.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from spt_tpu_torch import camera as tcamera  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import lights as tlights  # noqa: E402
from spt_tpu_torch import materials as tmaterials  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.ops import cuda_bounce  # noqa: E402
from spt_tpu_torch.scene import desc as tdesc  # noqa: E402

CPU = torch.device("cpu")


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from spt_tpu import camera, config, lights, materials, scene
    from spt_tpu.integrators import transport
    from spt_tpu.scene import desc
    return dict(jax=jax, jnp=jnp, camera=camera, config=config, lights=lights,
                materials=materials, scene=scene, transport=transport,
                desc=desc)


def _materials(mod, case):
    """Material lists of either package that exercise every branch of the
    table build: point sampling, the blocked mean, the area average of a
    size that is no multiple, metallicRoughness alone, and enough textures
    to drop the resolution to 128."""
    rng = np.random.default_rng(3)

    def img(h, w):
        return rng.uniform(0, 1, (h, w, 3)).astype(np.float32)

    mats = {
        "point": [mod.Material(base_color_texture=img(64, 64))],
        "blocked": [mod.Material(base_color_texture=img(512, 512)),
                    mod.Material([0.5, 0.5, 0.5])],
        "area": [mod.Material([0.3, 0.3, 0.3]),
                 mod.Material(base_color_texture=img(300, 200),
                              metallic_roughness_texture=img(90, 400))],
        "mr_only": [mod.Material(metallic_roughness_texture=img(256, 256))],
        "many": [mod.Material(base_color_texture=img(32, 48))
                 for _ in range(5)],
    }
    return mats[case]


@pytest.mark.parametrize("case", ["point", "blocked", "area", "mr_only",
                                  "many"])
def test_texture_table_bit_exact(case):
    from spt_tpu_torch import interop

    j = _jax()
    jid, jtab = j["materials"].build_texture_table(_materials(j["scene"], case))
    tid, ttab = tmaterials.build_texture_table(_materials(tscene, case))
    np.testing.assert_array_equal(tid, np.asarray(jid))
    np.testing.assert_array_equal(ttab.numpy(),
                                  interop.textures(jtab, CPU).numpy())
    assert tmaterials.tex_res_of(ttab) == j["materials"].tex_res_of(jtab)
    n = len([i for i in tid if i >= 0])
    assert tmaterials.choose_tex_res(n) == j["materials"].choose_tex_res(n)
    dm = tmaterials.build_device_materials(_materials(tscene, case), CPU)
    np.testing.assert_array_equal(dm.tex_id.numpy(), np.asarray(jid))


def test_unpack_bit_exact():
    j = _jax()
    p = np.random.default_rng(1).integers(-2 ** 31, 2 ** 31, 4096,
                                          dtype=np.int64).astype(np.int32)
    for tf, jf in ((tmaterials.unpack_color, j["materials"].unpack_color),
                   (tmaterials.unpack_mr, j["materials"].unpack_mr)):
        for g, w in zip(tf(torch.from_numpy(p)), jf(j["jnp"].asarray(p))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_texture_matches_jax():
    from spt_tpu_torch import interop

    j = _jax()
    _, jtab = j["materials"].build_texture_table(_materials(j["scene"],
                                                            "many"))
    ttab = interop.textures(jtab, CPU)
    rng = np.random.default_rng(2)
    n = 8192
    uv = rng.uniform(-2.0, 3.0, (2, n)).astype(np.float32)
    uv[:, :256] = np.round(uv[:, :256] * 4) / 4  # texel and tile seams
    tex_id = rng.integers(-1, 5, n).astype(np.int32)
    want = j["transport"].sample_texture_v(
        jtab, j["jnp"].asarray(tex_id), j["jnp"].asarray(uv[0]),
        j["jnp"].asarray(uv[1]))
    got = ttr.sample_texture_v(ttab, torch.from_numpy(tex_id),
                               torch.from_numpy(uv[0]),
                               torch.from_numpy(uv[1]))
    for g, w in zip((*got[0], got[1], got[2]), (*want[0], want[1], want[2])):
        g, w = g.numpy(), np.asarray(w)
        assert (np.abs(g - w) <= 1e-6).mean() >= 0.999
        assert (g[tex_id < 0] == 1.0).all()
        assert (g[tex_id >= 0] < 1.0).any()


def test_textured_shade_core_bounce_matches():
    from spt_tpu_torch import interop

    j = _jax()
    jd, cam = chip_smoke.inst_grid_scene(j["scene"], j["materials"],
                                         j["desc"], 8, 12)
    js = j["scene"].flatten_scene(jd)
    assert js.textures is not None and js.inst is None
    jl = j["lights"].default_lights()
    jcfg = j["config"].RenderConfig(width=64, height=48, spp=1, max_depth=4)
    tcfg = tconfig.RenderConfig(width=64, height=48, spp=1, max_depth=4)
    jtr = j["transport"]
    ps = jtr.gen_primary(jcfg, j["camera"].Camera(
        **cam, aspect_ratio=64 / 48).rays(), 2)
    ts, tl = interop.scene(js, CPU), interop.lights(jl, CPU)
    assert ts.textures is not None and ts.tri_uv is not None
    for bounce in range(2):
        hit = jtr.trace_bounce(js, ps)
        want, want_missed = jtr.shade_core(jcfg, js, jl, ps, hit, bounce,
                                           False)
        tps = interop.path_state(ps, CPU)
        thit = ttr.trace_bounce(ts, tps)
        assert thit.uvx is not None
        textured = (thit.kind.numpy() == 1) & (
            ts.materials.tex_id.numpy()[thit.mat_id.numpy()] >= 0)
        assert textured.sum() > (100 if bounce == 0 else 10)
        got, got_missed = ttr.shade_core(tcfg, ts, tl, tps, thit, bounce,
                                         False)
        assert (got.rng.numpy().astype(np.uint32)
                == np.asarray(want.rng)).mean() >= 0.999
        assert (got.alive.numpy() == np.asarray(want.alive)).mean() >= 0.999
        assert (got_missed.numpy() == np.asarray(want_missed)).mean() >= 0.999
        drad = np.abs(torch.stack(list(got.radiance), -1).numpy()
                      - np.stack([np.asarray(c) for c in want.radiance],
                                 -1)).max(-1)
        assert (drad > 0.01).sum() == 0
        ps = want


# --- the small textured form -------------------------------------------------------

def _checker():
    """tests/test_textures.py:_checker: quadrants R, G, B, W."""
    tex = np.zeros((64, 64, 3), np.float32)
    tex[:32, :32] = [1, 0, 0]
    tex[:32, 32:] = [0, 1, 0]
    tex[32:, :32] = [0, 0, 1]
    tex[32:, 32:] = [1, 1, 1]
    return tex


def _quad_desc(mod):
    """tests/test_textures.py:_quad_scene in either package."""
    sd = mod.SceneDesc()
    sd.add_material(mod.Material(base_color=[1.0, 1.0, 1.0], roughness=1.0,
                                 ior=1.0, base_color_texture=_checker()))
    sd.add_instance(sd.add_mesh(mod.MeshData(
        positions=[[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
        indices=[[0, 1, 2], [0, 2, 3]], normals=[[0, 0, 1]] * 4,
        texcoords=[[0, 1], [1, 1], [1, 0], [0, 0]], material_id=0)))
    return sd


def _rel_rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def test_quad_checker_reaches_film_through_the_small_form():
    from spt_tpu.engine.renderer import Renderer as JaxRenderer
    from spt_tpu_torch.engine.renderer import Renderer

    j = _jax()
    kw = dict(width=64, height=64, spp=1, max_depth=1, jitter=False,
              shadow_rays=False)
    pose = dict(position=(0, 0, 2.5), target=(0, 0, 0), fov_degrees=60.0,
                aspect_ratio=1.0)
    jlm, tlm = j["lights"].LightManager(), tlights.LightManager()
    for lm in (jlm, tlm):
        lm.add_directional_light((0.0, 0.0, -1.0), (1.0, 1.0, 1.0), 3.0)
    jr = JaxRenderer(_quad_desc(j["scene"]), j["config"].RenderConfig(**kw),
                     lights=jlm.device(), camera=j["camera"].Camera(**pose),
                     multi_device=False)
    tr = Renderer(_quad_desc(tscene), tconfig.RenderConfig(**kw),
                  lights=tlm.device(CPU), camera=tcamera.Camera(**pose),
                  device=CPU)
    assert cuda_bounce._accel_mode(tr.scene) is None
    assert tr.scene.textures is not None
    assert cuda_bounce._flags(tr.cfg, tr.scene, False) & cuda_bounce._TEXTURED
    jr.render_frames(1)
    tr.render_frames(1)
    img = tr.hdr_image()
    h, w = img.shape[:2]
    for (y, x), ch in (((h // 4, w // 4), 0), ((h // 4, 3 * w // 4), 1),
                       ((3 * h // 4, w // 4), 2)):
        assert int(np.argmax(img[y, x])) == ch and img[y, x].max() > 1e-4
    br = img[3 * h // 4, 3 * w // 4]
    assert br.min() > 0.5 * br.max() > 5e-4
    assert _rel_rmse(img, jr.hdr_image()) < 0.01


def test_diffuse_scale_divides_as_numpy_float32():
    from spt_tpu_torch.ops import sampling

    m = np.random.default_rng(5).uniform(0.0, 1.0, 65536).astype(np.float32)
    want = (np.float32(1.0) - m) / np.float32(np.pi)
    got = sampling.diffuse_scale(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# --- the card ------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the textured kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)


def _textured_mesh(dev, w, h):
    """chip_smoke's resident mesh scene with material 0 textured as the
    instanced grid's."""
    desc, cfg, cam = chip_smoke.port_mesh_scene()
    base, mr = chip_smoke._checker_texture(np, np.random.default_rng(0))
    desc.materials[0] = tscene.Material([1.0, 1.0, 1.0], roughness=1.0,
                                        metallic=1.0, base_color_texture=base,
                                        metallic_roughness_texture=mr)
    cfg = cfg.replace(width=w, height=h)
    cam.set_aspect_ratio(w / h)
    scene = tscene.flatten_scene(desc, dev)
    return cfg, scene, tlights.default_lights(dev), ttr.gen_primary(
        cfg, cam.rays(dev), 1)


def _textured_quad(dev, w, h):
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=3)
    cam = tcamera.Camera(position=(0.3, 0.2, 2.5), target=(0, 0, 0),
                         fov_degrees=60.0, aspect_ratio=w / h)
    scene = tscene.flatten_scene(_quad_desc(tscene), dev)
    return cfg, scene, tlights.default_lights(dev), ttr.gen_primary(
        cfg, cam.rays(dev), 1)


def _agree(k, p, share=0.999):
    if k.dtype.is_floating_point:
        off = ~((k == p) | ((k - p).abs() <= 1e-3))
    else:
        off = k != p
    return float(off.float().mean()) <= 1 - share


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["small", "resident"])
def test_textured_fused_kernels_match_plain_on_card(cuda_device, form):
    make = _textured_quad if form == "small" else _textured_mesh
    cfg, scene, lights, ps = make(cuda_device, 256, 192)
    assert cuda_bounce._accel_mode(scene) == (None if form == "small"
                                             else "resident")
    assert scene.textures is not None
    before = cuda_bounce.LAUNCHES
    k = cuda_bounce.fused_frame(cfg, scene, lights, ps)
    assert cuda_bounce.LAUNCHES == before + 1
    p = cuda_bounce.fused_frame_reference(cfg, scene, lights, ps)
    torch.cuda.synchronize()
    for a, b in zip(k[:3], p[:3]):
        for x, y in zip(a, b):
            assert _agree(x, y)
    assert _agree(k[3], p[3])
    assert torch.equal(k[4], p[4])
    # radiance bit for bit: the plain BRDF divides by pi as the kernels do
    assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(k[0], p[0]))
    kb, km = cuda_bounce.fused_bounce(cfg, scene, lights, ps, 0, False)
    pb, pm = cuda_bounce.fused_bounce_reference(cfg, scene, lights, ps, 0,
                                                False)
    torch.cuda.synchronize()
    # fused_bounce: every plane bit for bit
    for name, (x, y) in chip_smoke._state_planes(torch, kb, km, pb,
                                                 pm).items():
        assert x.dtype == y.dtype and chip_smoke._same_bits(torch, x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("textured", [False, True])
def test_brdf_on_card_equals_cpu_bit_for_bit(cuda_device, textured):
    """evaluate_brdf_v at fractional metallic values, on the card and on the
    CPU.  Every v + l is (0, 0, 1) exactly (v.z a multiple of 1/64), so the
    half vector's rsqrt, the one operation the two devices may round apart,
    takes 1 on both; the rest are float32 adds, multiplies, true divisions,
    square roots and clamps, which both round alike."""
    from spt_tpu_torch.ops import sampling
    from spt_tpu_torch.ops.vec3 import Vec3

    rng = np.random.default_rng(6)
    n = 65536
    nrm = rng.normal(size=(3, n))
    nrm = (nrm / np.linalg.norm(nrm, axis=0)).astype(np.float32)
    v = rng.uniform(-1.0, 1.0, (3, n)).astype(np.float32)
    v[2] = rng.integers(1, 64, n) / np.float32(64.0)
    l = np.stack([-v[0], -v[1], np.float32(1.0) - v[2]])
    roughness = rng.uniform(0.02, 1.0, n).astype(np.float32)
    metallic = rng.uniform(0.05, 0.95, n).astype(np.float32)
    base = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    if textured:
        # the multipliers the texture sampler gives: 10-bit colour and
        # 16-bit metallic / roughness steps, bilinearly blended
        img, mr = chip_smoke._checker_texture(np, rng, res=64)
        mats = [tscene.Material([1.0, 1.0, 1.0], base_color_texture=img,
                                metallic_roughness_texture=mr)] * 2
        _, table = tmaterials.build_texture_table(mats)
        rgb, rough_m, metal_m = ttr.sample_texture_v(
            table, torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)),
            *(torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))
              for _ in range(2)))
        base = base * np.stack([c.numpy() for c in rgb])
        roughness = np.clip(roughness * rough_m.numpy(), 0.02, 1.0)
        metallic = metallic * metal_m.numpy()
    ior = rng.choice(np.float32([1.0, 1.5, 2.4]), n)

    def run(dev):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

        out = sampling.evaluate_brdf_v(Vec3(*t(nrm)), Vec3(*t(v)),
                                       Vec3(*t(l)), Vec3(*t(base)),
                                       t(metallic), t(roughness), t(ior))
        return torch.stack(list(out), -1).cpu()

    got, want = run(cuda_device), run(CPU)
    assert float((want != 0).float().mean()) > 0.25
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_untextured_lanes_keep_their_colour_beside_textured_ones():
    """The port samples as transport.sample_texture_v does: a lane whose
    material has no texture takes multipliers of 1.  The JAX package's
    in-kernel sampler (pallas_bounce.py:548-600), which its fused kernels
    use, leaves such a lane's colour taps at 0 whenever its (8, 128) lane
    tile holds a textured hit, so those kernels shade untextured materials
    black beside textured ones; the port keeps them (ROADMAP section 3).
    The JAX sampler runs here in a one-tile Pallas kernel of the test's own
    (interpret mode) on lanes half textured, half not."""
    import jax.experimental.pallas as pl
    from spt_tpu.ops import pallas_bounce as pb
    from spt_tpu_torch import interop

    j = _jax()
    jnp = j["jnp"]
    _, jtab = j["materials"].build_texture_table(_materials(j["scene"],
                                                            "many"))
    rng = np.random.default_rng(4)
    tex_id = np.where(rng.uniform(size=(8, 128)) < 0.5, -1,
                      rng.integers(0, 5, (8, 128))).astype(np.int32)
    uv = rng.uniform(0.0, 1.0, (2, 8, 128)).astype(np.float32)

    def kernel(tex_ref, tid_ref, u_ref, v_ref, *outs):
        sample = pb._make_texture_sampler(tex_ref, jtab.shape[0])
        rgb, rough, metal = sample(None, tid_ref[...], u_ref[...], v_ref[...])
        for ref, val in zip(outs, (*rgb, rough, metal)):
            ref[...] = val

    planes = pl.pallas_call(
        kernel, interpret=True,
        out_shape=[j["jax"].ShapeDtypeStruct((8, 128), jnp.float32)] * 5,
    )(jnp.asarray(jtab).reshape(-1, 8, 128), jnp.asarray(tex_id),
      jnp.asarray(uv[0]), jnp.asarray(uv[1]))
    got = ttr.sample_texture_v(interop.textures(jtab, CPU),
                               torch.from_numpy(tex_id.reshape(-1)),
                               torch.from_numpy(uv[0].reshape(-1)),
                               torch.from_numpy(uv[1].reshape(-1)))
    textured = tex_id.reshape(-1) >= 0
    for g, w in zip((*got[0], got[1], got[2]), planes):
        g, w = g.numpy(), np.asarray(w).reshape(-1)
        np.testing.assert_allclose(g[textured], w[textured], atol=1e-6)
        assert (g[~textured] == 1.0).all()
    # the JAX kernel's colour taps on the untextured lanes: all zero
    for w in planes[:3]:
        assert (np.asarray(w).reshape(-1)[~textured] == 0.0).all()
