"""The chunked ray sort of spt_tpu_torch (K5) against spt_tpu's Pallas sort.

On the CPU ``cuda_sort.sort_chunks`` runs its plain version (a stable
torch.sort per chunk and a gather per plane).  The same keys and planes,
made with numpy from a seed, go through it and through
``spt_tpu.ops.pallas_sort.sort_chunks`` in interpret mode, two chunks of
2048 or 8192 lanes: uint32 keys with 40 % dead lanes (0xFFFFFFFF) and long
runs of equal keys, or one chunk all dead and one all equal; float32,
int32 and int64 planes (the Pallas kernel takes 4-byte planes only, so the
int64 plane goes through the port alone).  Gates, exact throughout (a sort
moves bits and computes none):

- the sorted keys of both equal numpy's per chunk;
- every plane of both holds its key's own payload: out[i] is the input
  plane at the lane now at i;
- the port's lane ids equal numpy's argsort(kind="stable") per chunk, as
  the CUDA kernel's do on the card (tests/test_torch_mesh_kernels.py); the
  Pallas kernel's bitonic network is not stable, so its lane order is held
  only to be a permutation of each chunk.

The card's own check of the kernel is
``test_sort_chunks_matches_torch_sort_on_card`` in
tests/test_torch_mesh_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from spt_tpu_torch.ops import cuda_sort  # noqa: E402

DEAD = 0xFFFFFFFF


def _keys(chunk, pattern, rng):
    n = 2 * chunk
    if pattern == "dead_and_equal":
        return np.concatenate([np.full(chunk, DEAD, np.uint32),
                               np.full(chunk, 0x00C0FFEE, np.uint32)])
    key = rng.integers(0, DEAD, n, dtype=np.uint64).astype(np.uint32)
    for c0 in (0, chunk):   # long runs of equal keys in each chunk
        key[c0 + 100:c0 + 100 + chunk // 4] = 5
        key[c0 + chunk // 2:c0 + chunk // 2 + chunk // 4] = rng.choice(
            np.uint32([7, 0x08000000, 0x3FFFFFFF]), chunk // 4)
    key[rng.uniform(size=n) < 0.4] = DEAD
    return key


@pytest.mark.parametrize("chunk,pattern", [(2048, "random"), (8192, "random"),
                                           (2048, "dead_and_equal")])
def test_sort_chunks_matches_pallas_sort(chunk, pattern):
    jnp = pytest.importorskip("jax.numpy")
    from spt_tpu.ops import pallas_sort

    rng = np.random.default_rng(chunk + len(pattern))
    key = _keys(chunk, pattern, rng)
    n = key.shape[0]
    f32 = rng.standard_normal(n).astype(np.float32)
    i32 = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    i64 = rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)
    lane32 = np.arange(n, dtype=np.int32)
    order = (np.argsort(key.reshape(2, chunk), axis=1, kind="stable")
             + np.arange(0, n, chunk)[:, None]).reshape(n)

    sk, lane, (of, oi, ol) = cuda_sort.sort_chunks(
        torch.from_numpy(key.astype(np.int64)),
        [torch.from_numpy(f32), torch.from_numpy(i32), torch.from_numpy(i64)],
        chunk)
    np.testing.assert_array_equal(sk.numpy(), key[order].astype(np.int64))
    np.testing.assert_array_equal(lane.numpy(), order)
    np.testing.assert_array_equal(of.numpy().view(np.int32),
                                  f32[order].view(np.int32))
    np.testing.assert_array_equal(oi.numpy(), i32[order])
    np.testing.assert_array_equal(ol.numpy(), i64[order])

    jk, (jf, ji, jl) = pallas_sort.sort_chunks(
        jnp.asarray(key), [jnp.asarray(f32), jnp.asarray(i32),
                           jnp.asarray(lane32)], chunk, interpret=True)
    jk, jf, ji, jl = (np.asarray(a) for a in (jk, jf, ji, jl))
    np.testing.assert_array_equal(jk, key[order])
    for c0 in (0, chunk):
        np.testing.assert_array_equal(np.sort(jl[c0:c0 + chunk]),
                                      np.arange(c0, c0 + chunk))
    np.testing.assert_array_equal(key[jl], jk)
    np.testing.assert_array_equal(jf.view(np.int32), f32[jl].view(np.int32))
    np.testing.assert_array_equal(ji, i32[jl])
