"""The equirect environment sampler (K2) and the .hdr IO of spt_tpu_torch
against spt_tpu.

On the CPU the same maps and directions (made with numpy from a seed) go
through the JAX function and its port.  Gates, each with its reason:

- ``io.hdr`` / ``io.cubemap_cross`` (numpy host code copied across):
  bit for bit against ``spt_tpu.io``, files byte for byte, round trips both
  ways, adaptive-RLE scanlines included;
- ``load_environment``: the same map as the JAX package's, for an equirect
  and a cross file;
- the sampler's plain version (``environment_color_v`` on a CPU tensor,
  ``cuda_env.env_sample_reference``) against
  ``pallas_env.sample_equirect_pallas`` in interpret mode and against the
  JAX ``environment_color_v`` on a 64x128 map, on random directions plus
  the poles and the u seam, with `need` masks: on the `need` lanes (the JAX
  Pallas kernel gives 0 outside them) >= 99 % of lanes within 1e-5 (rtol
  and atol, tests/test_env_pallas.py's gate) and every lane within 5e-4:
  the frameworks' CPU atan2 / acos may round a texel coordinate one ulp
  apart, which moves the blend by up to the texel step (up to 16 here)
  times that ulp (7.6e-6 at x ~ 100);
- the hdr config through the .hdr round trip: the Renderer against the JAX
  Renderer, hdr_image relative RMSE < 1 %.

On the CPU also: the map in the kernel's texel layout
(``env.equirect_texels``) holds the map's bits, odd widths and a one-row
map included, and every environment is made in it.  On a CUDA card (marker ``cuda``; skipped without one) the
kernel against its plain version, bit for bit, on maps of even, odd and
one-row shape, at the poles and the u seam, with `need` None, all false
and random.  Run there with
``python -m pytest --noconftest tests/test_torch_env.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from spt_tpu_torch import env as tenv  # noqa: E402
from spt_tpu_torch import interop  # noqa: E402
from spt_tpu_torch.io import cubemap_cross as tcross  # noqa: E402
from spt_tpu_torch.io import hdr as thdr  # noqa: E402
from spt_tpu_torch.ops import cuda_env  # noqa: E402
from spt_tpu_torch.ops.vec3 import Vec3  # noqa: E402

CPU = torch.device("cpu")


def _jax():
    """The JAX modules the comparisons need (imported per test, so that the
    file also collects and runs its card tests where JAX is absent)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from spt_tpu import env
    from spt_tpu.io import cubemap_cross, hdr
    from spt_tpu.ops import pallas_env
    from spt_tpu.ops.vec3 import Vec3 as JVec3
    return dict(jnp=jnp, env=env, hdr=hdr, cross=cubemap_cross,
                pallas_env=pallas_env, JVec3=JVec3)


def _dirs(n, seed):
    """n random unit directions, then the poles and both sides of the u seam
    (theta = +-pi at x < 0, z = -+0), 1024 lanes a block."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    special = np.array([[0, 1, 0], [0, -1, 0], [-1, 0, 1e-6], [-1, 0, -1e-6],
                        [-1, 0, 0], [1, 0, 0], [0, 0, 1], [0, 0, -1]],
                       np.float32)
    return np.concatenate([d, np.tile(special, (128, 1))])


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)))


def _jv(j, a):
    return j["JVec3"](*(j["jnp"].asarray(a[:, k]) for k in range(3)))


def _np3(v):
    return np.stack([np.asarray(c) for c in v], -1)


def _agree(got, want):
    """>= 99 % of lanes within 1e-5 (rtol and atol) in every channel, and
    every lane within 5e-4 (module docstring)."""
    assert got.shape == want.shape
    close = np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want)
    assert close.all(-1).mean() >= 0.99
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def _map(seed, h=64, w=128):
    """A 64x128 map of random radiance with a few texels past the clamp."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32)
    img[rng.uniform(size=(h, w)) < 0.05] *= 4.0
    return img


# --- io ---------------------------------------------------------------------------

def _rle_file(path, rows):
    """An adaptive-RLE .hdr of (h, w, 4) uint8 RGBE rows: runs where a
    channel repeats, literals elsewhere."""
    h, w, _ = rows.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            f.write(bytes([2, 2, w >> 8, w & 0xFF]))
            for ch in range(4):
                vals, x = rows[y, :, ch], 0
                while x < w:
                    run = 1
                    while x + run < w and run < 127 and vals[x + run] == vals[x]:
                        run += 1
                    if run > 2:
                        f.write(bytes([128 + run, int(vals[x])]))
                        x += run
                    else:
                        n = min(w - x, 128)
                        f.write(bytes([n]) + bytes(int(v) for v in vals[x:x + n]))
                        x += n


@pytest.mark.parametrize("shape", [(16, 32), (3, 4)])
def test_hdr_write_read_match_jax(tmp_path, shape):
    j = _jax()
    rng = np.random.default_rng(7)
    img = (rng.uniform(0, 50, shape + (3,)) ** 2).astype(np.float32)
    img[0, 0] = 0.0
    mine, theirs = tmp_path / "port.hdr", tmp_path / "jax.hdr"
    thdr.write_hdr(str(mine), img)
    j["hdr"].write_hdr(str(theirs), img)
    assert mine.read_bytes() == theirs.read_bytes()
    # round trips both ways, bit for bit against the JAX reader
    for p in (mine, theirs):
        got, want = thdr.read_hdr(str(p)), j["hdr"].read_hdr(str(p))
        assert got.dtype == np.float32 and got.shape == shape + (3,)
        np.testing.assert_array_equal(got, want)
    back = thdr.read_hdr(str(mine))
    assert np.all(np.abs(back - img) <= img.max(-1, keepdims=True) / 256 + 1e-4)


def test_hdr_rle_scanlines_match_jax(tmp_path):
    j = _jax()
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 256, (4, 40, 4)).astype(np.uint8)
    rows[:, 5:30] = rows[:, 5:6]           # runs in every channel
    rows[..., 3] = rng.integers(120, 140, (4, 40))
    rows[1, :, 3] = 0                      # a row of zero exponents
    p = tmp_path / "rle.hdr"
    _rle_file(str(p), rows)
    got, want = thdr.read_hdr(str(p)), j["hdr"].read_hdr(str(p))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_array_equal(got, thdr._rgbe_to_float(rows))


def test_hdr_rejects_what_jax_rejects(tmp_path):
    j = _jax()
    bad = tmp_path / "bad.hdr"
    bad.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    for reader in (thdr.read_hdr, j["hdr"].read_hdr):
        with pytest.raises(ValueError, match="not a Radiance HDR file"):
            reader(str(bad))
    flip = tmp_path / "flip.hdr"
    flip.write_bytes(b"#?RADIANCE\n\n+Y 1 +X 1\n" + bytes(4))
    for reader in (thdr.read_hdr, j["hdr"].read_hdr):
        with pytest.raises(ValueError, match="resolution line"):
            reader(str(flip))


def test_detect_layout_and_cross_match_jax():
    j = _jax()
    for w, h in ((128, 64), (64, 48), (100, 100), (2, 1), (4, 3), (0, 0)):
        assert thdr.detect_layout(w, h) == j["hdr"].detect_layout(w, h)
    rng = np.random.default_rng(9)
    cross = rng.uniform(0, 3, (3 * 8, 4 * 8, 3)).astype(np.float32)
    for out_height in (None, 12):
        got = tcross.cross_to_equirect(cross, out_height)
        want = j["cross"].cross_to_equirect(cross, out_height)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for name, face in tcross.extract_faces(cross).items():
        np.testing.assert_array_equal(face, j["cross"].extract_faces(cross)[name])


@pytest.mark.parametrize("layout", ["equirect", "cross"])
def test_load_environment_matches_jax(tmp_path, layout):
    j = _jax()
    img = (_map(10, 12, 16) if layout == "cross" else _map(10, 16, 32))
    p = str(tmp_path / f"{layout}.hdr")
    thdr.write_hdr(p, img)
    got = tenv.load_environment(p, CPU)
    want = j["env"].load_environment(p)
    assert got.enabled and bool(np.asarray(want.enabled))
    assert got.image.shape[1] == 2 * got.image.shape[0]
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
    assert got.intensity == pytest.approx(float(np.asarray(want.intensity)))
    assert got.max_clamp == pytest.approx(float(np.asarray(want.max_clamp)))
    # the JAX environment crosses to the port unchanged
    np.testing.assert_array_equal(interop.environment(want, CPU).image.numpy(),
                                  got.image.numpy())
    # no path: the procedural sky, as the JAX package's fallback
    assert not tenv.load_environment(None, CPU).enabled
    assert not bool(np.asarray(j["env"].load_environment(None).enabled))


# --- the sampler's plain version ----------------------------------------------------

def test_plain_sampler_matches_pallas_env():
    """The port's taps and blend against pallas_env's kernel (interpret):
    on the `need` lanes the same sample, outside them the JAX kernel's 0."""
    j = _jax()
    img = _map(11)
    d = _dirs(2048, 12)
    n = d.shape[0]
    need = np.random.default_rng(13).uniform(size=n) < 0.6
    need[2048:] = True                     # the poles and the seam
    jd = _jv(j, d)
    jd = j["JVec3"](*(c / j["jnp"].sqrt(jd.x * jd.x + jd.y * jd.y + jd.z * jd.z)
                      for c in jd))
    want = _np3(j["pallas_env"].sample_equirect_pallas(
        j["jnp"].asarray(img), jd, j["jnp"].asarray(need), interpret=True))
    got = _np3(tenv.sample_equirect_v(torch.from_numpy(img),
                                      tenv.v3.safe_normalize(_tv(d))))
    _agree(got[need], want[need])
    np.testing.assert_array_equal(want[~need], 0.0)


@pytest.mark.parametrize("with_need", [False, True])
def test_environment_color_matches_jax(with_need):
    j = _jax()
    img = _map(14)
    d = _dirs(1024, 15) * np.float32(2.5)  # not normalized: both normalize
    need = np.random.default_rng(16).uniform(size=d.shape[0]) < 0.5
    tenv_ = tenv.make_hdr_environment(img, CPU)
    jenv_ = j["env"].make_hdr_environment(img)
    before = cuda_env.LAUNCHES
    got = _np3(tenv.environment_color_v(
        tenv_, _tv(d), torch.from_numpy(need) if with_need else None))
    want = _np3(j["env"].environment_color_v(
        jenv_, _jv(j, d), j["jnp"].asarray(need) if with_need else None))
    # a CPU tensor runs the plain version on every lane and launches nothing
    assert cuda_env.LAUNCHES == before
    _agree(got, want)
    assert got.max() == pytest.approx(5.0 * 0.8)  # the clamp x intensity
    ref = _np3(cuda_env.env_sample_reference(tenv_, _tv(d)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("h,w", [(64, 128), (7, 13), (1, 9)])
def test_texel_copy_holds_the_map_bit_for_bit(h, w):
    """The sampler kernel's texel layout: an (H, W, 3) view of an (H, W, 4)
    buffer holding each texel's RGB bits and a zero pad, on odd widths and a
    one-row map too; the plain sampler gives the same through it as through
    the contiguous map, and every environment is made in it."""
    img = torch.from_numpy(_map(23, h, w))
    tex = tenv.equirect_texels(img)
    assert tex.shape == (h, w, 3) and tex.dtype == torch.float32
    assert tex.stride() == (4 * w, 4, 1) and tenv.has_texel_layout(tex)
    assert not tenv.has_texel_layout(img)
    assert torch.equal(tex.contiguous().view(torch.int32), img.view(torch.int32))
    whole = tex.as_strided((h, w, 4), (4 * w, 4, 1))
    assert torch.equal(whole[..., 3], torch.zeros(h, w))
    d = tenv.v3.safe_normalize(_tv(_dirs(1024, 24)))
    a = _np3(tenv.sample_equirect_v(img, d))
    b = _np3(tenv.sample_equirect_v(tex, d))
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    made = tenv.make_hdr_environment(img.numpy(), CPU).image
    assert tenv.has_texel_layout(made)
    assert torch.equal(made.contiguous().view(torch.int32), img.view(torch.int32))
    assert tenv.has_texel_layout(tenv.make_procedural_environment(CPU).image)


def test_jitted_jax_divides_by_a_constant_as_a_reciprocal_multiply():
    """Why the port's taps may multiply by 1 / (2 pi): the JAX package runs
    env._equirect_taps jitted, and XLA rewrites the division by the
    constant into that multiply (eager JAX and PyTorch on the CPU divide
    truly, PyTorch on the card multiplies)."""
    j = _jax()
    import jax

    jnp = j["jnp"]
    t = np.random.default_rng(25).uniform(-np.pi, np.pi, 10 ** 6).astype(np.float32)
    got = np.asarray(jax.jit(lambda x: (x + jnp.pi) / (2.0 * jnp.pi))(t))
    s = t + np.float32(np.pi)
    np.testing.assert_array_equal(got, s * (np.float32(1.0) / np.float32(2.0 * np.pi)))
    assert (got != s / np.float32(2.0 * np.pi)).mean() > 0.1


def test_procedural_env_ignores_need():
    env = tenv.make_procedural_environment(CPU)
    d = _tv(_dirs(64, 17))
    need = torch.zeros(d.x.shape[0], dtype=torch.bool)
    a, b = tenv.environment_color_v(env, d), tenv.environment_color_v(env, d, need)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- the hdr config through the .hdr round trip ---------------------------------------

def test_hdr_config_through_the_file_matches_jax(tmp_path):
    """bench.py's hdr config (bench.py:70-94) at 48x32 d3: the synthetic map
    written as .hdr and loaded back by each package."""
    j = _jax()
    from spt_tpu import camera as jcamera, config as jconfig
    from spt_tpu import lights as jlights, scene as jscene
    from spt_tpu.engine.renderer import Renderer as JaxRenderer
    from spt_tpu_torch import camera as tcamera, config as tconfig
    from spt_tpu_torch import lights as tlights, scene as tscene
    from spt_tpu_torch.engine.renderer import Renderer

    p = str(tmp_path / "sunsky.hdr")
    thdr.write_hdr(p, tenv.synthetic_equirect(32))
    kw = dict(width=48, height=32, spp=1, max_depth=3)
    pose = dict(position=(0, 2.0, 6.0), target=(0, 1.0, 0.0),
                fov_degrees=50.0, aspect_ratio=1.5)
    jlm, tlm = jlights.LightManager(), tlights.LightManager()
    for lm in (jlm, tlm):
        lm.add_directional_light((0.4, -1.0, -0.3), (1.0, 0.95, 0.9), 1.0)
    jr = JaxRenderer(jscene.build_hdr_glass_scene(), jconfig.RenderConfig(**kw),
                     env=j["env"].load_environment(p), lights=jlm.device(),
                     camera=jcamera.Camera(**pose), multi_device=False)
    tr = Renderer(tscene.build_hdr_glass_scene(), tconfig.RenderConfig(**kw),
                  env=tenv.load_environment(p, CPU), lights=tlm.device(CPU),
                  camera=tcamera.Camera(**pose), device=CPU)
    jr.render_frames(2)
    tr.render_frames(2)
    got, want = tr.hdr_image(), jr.hdr_image()
    assert np.isfinite(got).all() and got.max() > 0.0
    rel = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))
    assert rel < 0.01


# --- the card -------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the env_sample kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(256, 512), (33, 67), (1, 9)])
@pytest.mark.parametrize("need_kind", ["none", "all_false", "random"])
def test_env_kernel_matches_plain_on_card(cuda_device, h, w, need_kind):
    # random directions, then the poles and both sides of the u seam; maps
    # of even, odd and one-row shape; built with --fmad=false in the plain
    # version's order: bit for bit on the need lanes, 0 elsewhere, one
    # launch a call
    env = tenv.make_hdr_environment(_map(18, h, w), cuda_device)
    d = _dirs(1 << 16, 19) * np.float32(1.5)
    n = d.shape[0]
    dv = Vec3(*(c.to(cuda_device) for c in _tv(d)))
    need = {"none": None,
            "all_false": torch.zeros(n, dtype=torch.bool),
            "random": torch.from_numpy(
                np.random.default_rng(20).uniform(size=n) < 0.4)}[need_kind]
    if need is not None:
        need = need.to(cuda_device)
    before = cuda_env.LAUNCHES
    k = torch.stack(list(cuda_env.env_sample(env, dv, need)), -1)
    assert cuda_env.LAUNCHES == before + 1
    p = torch.stack(list(cuda_env.env_sample_reference(env, dv)), -1)
    m = need if need is not None else torch.ones(n, dtype=torch.bool,
                                                 device=cuda_device)
    assert torch.equal(k[m].view(torch.int32), p[m].view(torch.int32))
    assert bool((k[~m] == 0).all())


@pytest.mark.cuda
def test_env_kernel_refuses_bad_inputs_on_card(cuda_device):
    env = tenv.make_hdr_environment(_map(21), cuda_device)
    d = Vec3(*(c.to(cuda_device) for c in _tv(_dirs(64, 22))))
    with pytest.raises(ValueError, match="float32"):
        cuda_env.env_sample(env, Vec3(d.x.double(), d.y, d.z))
    with pytest.raises(ValueError, match="environment map"):
        cuda_env.env_sample(env._replace(image=env.image.cpu()), d)
    # the kernel reads only the texel layout: a map held otherwise is
    # refused, never sampled as 12-byte texels
    with pytest.raises(ValueError, match="texel layout"):
        cuda_env.env_sample(env._replace(image=env.image.contiguous()), d)
