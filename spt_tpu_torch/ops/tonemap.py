"""Display transforms (the counterpart of ``spt_tpu.ops.tonemap``).

- Reinhard resolve chain: exposure -> c/(1+c) -> gamma encode
  (device_programs.cu:854-899 __raygen__resolve).
- ACES filmic polynomial (EnvironmentManager.cpp:63-74).
"""

from __future__ import annotations

import torch


def aces(color: torch.Tensor) -> torch.Tensor:
    """ACES filmic fit (a=2.51, b=0.03, c=2.43, d=0.59, e=0.14)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((color * (a * color + b)) / (color * (c * color + d) + e), 0.0, 1.0)


def reinhard(color: torch.Tensor) -> torch.Tensor:
    return color / (1.0 + color)


def gamma_encode(color: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    return torch.pow(torch.clamp(color, min=0.0), 1.0 / gamma)


def resolve(
    accum: torch.Tensor,
    sample_count: torch.Tensor,
    exposure: float = 2.2,
    gamma: float = 2.2,
    tonemap: str = "reinhard",
) -> torch.Tensor:
    """accum/count -> display [0,1] (device_programs.cu:854-899).

    `accum` is (..., 3) linear HDR sums; `sample_count` is (...,) or scalar.
    """
    inv = torch.where(sample_count > 0,
                      1.0 / torch.clamp(sample_count, min=1e-30), 0.0)
    c = torch.clamp(accum * inv[..., None], min=0.0)
    c = c * exposure
    if tonemap == "reinhard":
        c = reinhard(c)
    elif tonemap == "aces":
        c = aces(c)
    elif tonemap != "none":
        raise ValueError(f"unknown tonemap {tonemap!r}")
    c = gamma_encode(c, gamma)
    return torch.clamp(c, 0.0, 1.0)
