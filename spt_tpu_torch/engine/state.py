"""Explicit progressive-render state + checkpoint/resume.

The counterpart of ``spt_tpu.engine.state``: (accum, sample_count,
frame_index) as tensors on the render device, reset on camera motion
(GLRenderer.cpp:145-161).  The ``.npz`` checkpoint format is the JAX
package's, so a render started there resumes here and back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RenderState(NamedTuple):
    """Accumulated linear HDR radiance (sums + count)."""

    accum: torch.Tensor         # (N, 3) float32 linear radiance sums
    sample_count: torch.Tensor  # () float32 accumulated samples per pixel
    frame_index: torch.Tensor   # () int32 — RNG epoch

    @property
    def num_pixels(self) -> int:
        return self.accum.shape[0]


def init_state(num_pixels: int, device) -> RenderState:
    return RenderState(
        accum=torch.zeros((num_pixels, 3), dtype=torch.float32, device=device),
        sample_count=torch.zeros((), dtype=torch.float32, device=device),
        frame_index=torch.zeros((), dtype=torch.int32, device=device),
    )


def reset(state: RenderState) -> RenderState:
    """Accumulation reset on camera motion — the frame index keeps
    advancing so the RNG stream never repeats."""
    return RenderState(
        accum=torch.zeros_like(state.accum),
        sample_count=torch.zeros_like(state.sample_count),
        frame_index=state.frame_index,
    )


def accumulate(state: RenderState, radiance: torch.Tensor, spp: float) -> RenderState:
    """Fold one frame's (N, 3) mean radiance (of `spp` samples) into the sums."""
    return RenderState(
        accum=state.accum + radiance * spp,
        sample_count=state.sample_count + spp,
        frame_index=state.frame_index + 1,
    )


def save_checkpoint(path: str, state: RenderState) -> None:
    # through an open handle: np.savez appends ".npz" to a bare path
    with open(path, "wb") as f:
        np.savez(
            f,
            accum=state.accum.cpu().numpy(),
            sample_count=state.sample_count.cpu().numpy(),
            frame_index=state.frame_index.cpu().numpy(),
        )


def load_checkpoint(path: str, device) -> RenderState:
    with np.load(path) as data:
        return RenderState(
            accum=torch.as_tensor(np.asarray(data["accum"], np.float32),
                                  device=device),
            sample_count=torch.as_tensor(
                np.asarray(data["sample_count"], np.float32), device=device),
            frame_index=torch.as_tensor(
                np.asarray(data["frame_index"], np.int32), device=device),
        )
