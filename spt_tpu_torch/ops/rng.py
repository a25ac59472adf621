"""Counter-based per-lane RNG, bit-exact with ``spt_tpu.ops.rng``.

The reference's stateless wang_hash chains (wf_math.h:35-49,
device_programs.cu:112-125), seeded per pixel and frame.  The state is a
uint32 word per lane, carried here as ``int64`` masked with
``& 0xFFFFFFFF``: torch has no logical ``>>`` on ``uint32`` on the CPU, and
in int64 every product of the hash stays below 2^62, so the arithmetic is
exact.  The CUDA kernel takes the int32 bit pattern of the same words.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def wang_hash(x: torch.Tensor) -> torch.Tensor:
    """Vectorized Wang hash over uint32 words held in int64 (wf_math.h:35-44)."""
    x = x & MASK
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & MASK
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & MASK
    x = x ^ (x >> 15)
    return x


def _u32(v):
    if isinstance(v, int):
        return v & MASK
    return v.to(torch.int64) & MASK


def seed_paths(pixel_index: torch.Tensor, frame_index) -> torch.Tensor:
    """Per-path RNG state for a frame (device_programs.cu:256:
    `wang_hash((pixel + 1) ^ (frameIndex * 9781 + 1))`).  `frame_index` is a
    Python int or an integer tensor (the render state's frame counter)."""
    p = (_u32(pixel_index) + 1) & MASK
    f = (_u32(frame_index) * 9781 + 1) & MASK
    return wang_hash(p ^ f)


def seed_samples(pixel_seed: torch.Tensor, sample_index) -> torch.Tensor:
    """Per-(pixel, sample) state (wf_pt_cpu.cpp:91:
    `wang_hash(pixel_seed ^ (s*9781+1))`)."""
    s = (_u32(sample_index) * 9781 + 1) & MASK
    return wang_hash(_u32(pixel_seed) ^ s)


def next_float(state: torch.Tensor):
    """Advance each lane and return (new_state, uniform in [0,1)).

    Matches rng_next01 (device_programs.cu:122-125): 24 low bits / 2^24,
    converted through int32 as the JAX version does."""
    state = wang_hash(state)
    bits = (state & 0x00FFFFFF).to(torch.int32)
    u = bits.to(torch.float32) * (1.0 / 16777216.0)
    return state, u


def next_float2(state: torch.Tensor):
    state, u1 = next_float(state)
    state, u2 = next_float(state)
    return state, u1, u2
