"""The scalar helpers of ``spt_tpu.ops.math3d`` that the wavefront path uses."""

from __future__ import annotations

import torch


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)); non-positive lanes give exactly 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def smoothstep(edge0: float, edge1: float, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
