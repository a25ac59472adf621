"""Per-stage timing and ray-throughput telemetry.

The counterpart of ``spt_tpu.utils.timing``: wall-clock stage timing that
waits for the device, and rays/s accounting from the wavefront's
per-bounce live counts.  A stage's `block_on` tensor names the device to
wait for: on the card the stage ends with ``torch.cuda.synchronize`` of
that tensor's device (kernels are queued, so only a sync proves they ran),
on the CPU nothing needs waiting for.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch


def _wait_for(t) -> None:
    for x in (t if isinstance(t, (tuple, list)) else (t,)):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)


class StageTimer:
    """Accumulating wall-clock timer per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _wait_for(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total*1000:9.2f} ms total "
                         f"({total/n*1000:8.2f} ms x {n})")
        return "\n".join(lines)


class RayThroughput:
    """Rays/s accounting from WavefrontStats (+1 shadow ray per surviving
    surface lane per light: a lower bound, as bench.count_rays)."""

    def __init__(self, n_lights: int = 1):
        self.n_lights = n_lights
        self.total_rays = 0
        self.t0 = time.perf_counter()
        self._frames: List[int] = []

    def add_frame(self, stats) -> None:
        rays = np.asarray(torch.as_tensor(stats.rays_per_bounce).cpu(),
                          np.int64)
        n = int(rays.sum())
        if self.n_lights and rays.size > 1:
            n += int(rays[1:].sum()) * self.n_lights
        self.total_rays += n
        self._frames.append(n)

    @property
    def mrays_per_sec(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.total_rays / max(dt, 1e-9) / 1e6

    def report(self) -> str:
        return (f"{self.total_rays/1e6:.2f} Mrays over {len(self._frames)} "
                f"frames -> {self.mrays_per_sec:.1f} Mrays/s")
