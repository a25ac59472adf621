"""spt_tpu_torch RNG and primary rays against spt_tpu, bit for bit.

The port carries uint32 RNG words as int64 masked to 32 bits; every wang
hash chain must equal the JAX package's exactly (tolerance: none), because
the per-lane RNG stream is what makes the two packages trace the same paths.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from spt_tpu.camera import default_camera as jax_default_camera  # noqa: E402
from spt_tpu.config import GPU_PARITY as JAX_GPU_PARITY  # noqa: E402
from spt_tpu.config import RenderConfig as JaxConfig  # noqa: E402
from spt_tpu.integrators import transport as jtr  # noqa: E402
from spt_tpu.ops import rng as jrng  # noqa: E402

from spt_tpu_torch import interop  # noqa: E402
from spt_tpu_torch.config import GPU_PARITY, RenderConfig  # noqa: E402
from spt_tpu_torch.integrators import transport as ttr  # noqa: E402
from spt_tpu_torch.ops import rng as trng  # noqa: E402

N = 1 << 20
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def words():
    return np.random.default_rng(7).integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.as_tensor(words.astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


def test_wang_hash_bit_exact(words):
    want = np.asarray(jrng.wang_hash(jnp.asarray(words)))
    np.testing.assert_array_equal(_np(trng.wang_hash(_t(words))), want)


@pytest.mark.parametrize("frame", [0, 1, 977, 2 ** 31 + 5])
def test_seed_paths_bit_exact(words, frame):
    pixel = words[:4096]
    want = np.asarray(jrng.seed_paths(jnp.asarray(pixel), frame))
    np.testing.assert_array_equal(_np(trng.seed_paths(_t(pixel), frame)), want)
    # the render state's frame counter rides in as a 0-d int32 tensor
    if frame < 2 ** 31:
        got = trng.seed_paths(_t(pixel), torch.tensor(frame, dtype=torch.int32))
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("sample", [0, 3, 4095])
def test_seed_samples_bit_exact(words, sample):
    want = np.asarray(jrng.seed_samples(jnp.asarray(words), sample))
    np.testing.assert_array_equal(_np(trng.seed_samples(_t(words), sample)), want)


def test_next_float_chain_bit_exact(words):
    js, ts = jnp.asarray(words), _t(words)
    for _ in range(3):
        js, ju = jrng.next_float(js)
        ts, tu = trng.next_float(ts)
        np.testing.assert_array_equal(_np(ts), np.asarray(js))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    js, j1, j2 = jrng.next_float2(js)
    ts, t1, t2 = trng.next_float2(ts)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


def test_kernel_bit_pattern_round_trips(words):
    # the CUDA kernels take the words as the port holds them, int64, and
    # read each as its low 32 bits (csrc/spt_queue.cuh load_path), writing
    # them back zero-extended: every word the port's chains make lies in
    # [0, 2**32), where that round trip gives the word itself
    for held in (_t(words), trng.wang_hash(_t(words)),
                 trng.next_float(_t(words))[0]):
        assert held.dtype == torch.int64
        assert int(held.min()) >= 0 and int(held.max()) < 2 ** 32
        low = held.numpy().astype(np.uint32)
        np.testing.assert_array_equal(low.astype(np.int64), held.numpy())
    np.testing.assert_array_equal(_t(words).numpy().astype(np.uint32), words)


@pytest.mark.parametrize("preset,sample", [
    ("default", 0), ("default", 2), ("gpu_parity", 0)])
def test_gen_primary_matches(preset, sample):
    # rng exact; directions at atol 1e-6 (float32 camera math, same order)
    jcfg = JaxConfig(width=96, height=64, spp=4 if sample else 1)
    tcfg = RenderConfig(width=96, height=64, spp=4 if sample else 1)
    if preset == "gpu_parity":
        jcfg = JAX_GPU_PARITY.replace(width=96, height=64)
        tcfg = GPU_PARITY.replace(width=96, height=64)
    cam = jax_default_camera(96, 64).rays()
    want = jtr.gen_primary(jcfg, cam, 5, sample)
    got = ttr.gen_primary(tcfg, interop.camera_rays(cam, CPU), 5, sample)
    np.testing.assert_array_equal(_np(got.rng), np.asarray(want.rng))
    for a, b in zip(got.direction, want.direction):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    for a, b in zip(got.origin, want.origin):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(got.alive.all()) and bool(got.emission_ok.all())


def test_camera_basis_matches():
    # the host camera is copied numpy: its device snapshot is identical
    from spt_tpu.camera import Camera as JaxCamera
    from spt_tpu_torch.camera import Camera

    jc = JaxCamera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                   fov_degrees=50.0, aspect_ratio=1.5)
    tc = Camera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                fov_degrees=50.0, aspect_ratio=1.5)
    for c in (jc, tc):
        c.process_mouse(20.0, -5.0)
        c.set_aspect_ratio(16 / 9)
    jr, tr = jc.rays(), tc.rays(CPU)
    for f in tr._fields:
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)))
