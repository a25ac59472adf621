"""Wavefront ray sorting: chunk-local lane reordering for trace coherence.

The counterpart of ``spt_tpu.ops.ray_sort`` (ray_sort.py:37-177) in its
default layout: a uint32 key — dead lanes last, live lanes by direction
octant then origin Morton code — and a sort of the lane planes by that key
within fixed chunks.  uint32 words are held in int64 tensors, as the port
holds its RNG words.

- ``sort_by_key`` goes to ``cuda_sort.sort_chunks``: the hand-written
  chunked sort (stable) on a CUDA tensor, its plain PyTorch version on a
  CPU one.
- ``unsort_by_lane`` is an inverse-permutation scatter within each chunk
  (``out[lane_id[i]] = x[i]``): lane ids are all distinct, so it computes
  what the JAX package's second sort keyed on lane id computes.

Not ported: the ``SPT_SORT_KEY`` layouts, ``SPT_SORT_CHUNK`` and
``SPT_NO_PALLAS_SORT``.
"""

from __future__ import annotations

import torch

from spt_tpu_torch.ops import cuda_sort
from spt_tpu_torch.ops.vec3 import Vec3

DEAD_KEY = 0xFFFFFFFF


def chunk_size(n: int) -> int:
    """Largest supported sort chunk dividing n (0 = sorting unavailable)."""
    for c in (8192, 4096, 2048):
        if n % c == 0 and n > c:
            return c
    return 0


def _spread(x: torch.Tensor) -> torch.Tensor:
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def sort_key(direction: Vec3, origin: Vec3, alive: torch.Tensor,
             lo: torch.Tensor, inv_extent: torch.Tensor) -> torch.Tensor:
    """(N,) int64 holding uint32 keys: octant[3] | morton[27]; dead lanes
    DEAD_KEY.  `lo`/`inv_extent`: (3,) scene bounds for origin
    quantization."""
    octant = ((direction.x < 0).to(torch.int64) * 4
              + (direction.y < 0).to(torch.int64) * 2
              + (direction.z < 0).to(torch.int64))

    def q(v, i):
        f = torch.clamp((v - lo[i]) * inv_extent[i], 0.0, 1.0)
        return (f * 1023.0).to(torch.int64)

    morton = (_spread(q(origin.x, 0)) | (_spread(q(origin.y, 1)) << 1)
              | (_spread(q(origin.z, 2)) << 2))
    key = (octant << 27) | (morton >> 5)
    return torch.where(alive, key, DEAD_KEY)


def sort_by_key(key: torch.Tensor, operands, chunk: int):
    """Sort the (N,) operand tensors by `key` within `chunk`-lane chunks.

    Returns (lane_id, sorted_operands): lane_id[i] (int64) is the pre-sort
    position of the lane now at i.  The sort is stable: lanes of equal keys
    keep their order, in the CUDA kernel's radix sort as in the plain
    version's torch.sort, so a sorted frame is reproducible lane for lane."""
    _, lane_id, out = cuda_sort.sort_chunks(key, list(operands), chunk)
    return lane_id, out


def unsort_by_lane(lane_id: torch.Tensor, operands, chunk: int):
    """Inverse of sort_by_key: each value goes back to lane lane_id[i]."""
    n = lane_id.shape[0]
    if n % chunk:
        raise ValueError(f"{n} lanes are not a multiple of the chunk {chunk}")
    out = []
    for x in operands:
        y = torch.empty_like(x)
        y[lane_id] = x
        out.append(y)
    return out
