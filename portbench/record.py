"""What a run records for the metric readers, and the sums they share.

The harness (``portbench/run.py``) fills a ``RunRecord``: one ``Job`` a
job of the measured window, the set-up spans, and with ``--trace 1`` the
device times of each call into the port (CUDA event pairs) and the path
stats.  The readers in ``portbench/metrics/`` take their numbers from it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Job:
    t_start: float              # host clock: the job starts (the reset)
    t_end: float                # host clock: the image is on the host
    frames: int
    samples: int                # pixels x spp x frames
    epoch: int                  # RNG epoch (frame index) of the first frame
    device_ms: Optional[float] = None   # events around the render calls
    image_ms: Optional[float] = None    # events around image()
    band_ms: Optional[float] = None     # render calls up to the all_reduce
    rays: Optional[np.ndarray] = None   # summed rays_per_bounce


@dataclasses.dataclass
class RunRecord:
    workload: str
    render: dict                # the render settings as run
    world: int                  # cards (ranks) the run uses
    trace: bool
    jobs: List[Job]
    window_s: float
    setup_s: float
    spans: dict                 # set-up spans by name, seconds
    n_shadow: int               # shadow rays a surface-hit lane a bounce
    scene: object = None        # portbench.scenes.SceneData
    device_kind: str = ""
    ranks: list = dataclasses.field(default_factory=list)  # per-rank dicts


def device_idle_pct(run: RunRecord):
    """100 x (1 - device time of the window's calls / window), the mean
    over the ranks; None without event timings.  On a sharded run a
    rank's render time ends where its band reaches the call's all_reduce,
    so the wait for the slowest band counts as idle."""
    if not run.trace or not run.ranks:
        return None
    shares = []
    for rk in run.ranks:
        busy = rk.get("busy_ms")
        if busy is None:
            return None
        shares.append(1.0 - busy / 1e3 / rk["window_s"])
    return 100.0 * float(np.mean(shares))
