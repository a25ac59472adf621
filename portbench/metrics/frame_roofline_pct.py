"""The least time for a frame's work (portbench.work.counts: the larger of
its operations over the card's float32 peak and its bytes over its
memory bandwidth, from portbench/work/peaks.json) over the frame's device
time from the CUDA event pairs around the render calls, in %.  Nothing
when the card is not in the table of peaks or the scene is past the
counts' brute-force rule."""

import json
from pathlib import Path

from portbench.work.counts import frame_work, least_seconds

PEAKS = Path(__file__).resolve().parents[1] / "work" / "peaks.json"


def read(run):
    if not run.trace or any(j.device_ms is None for j in run.jobs):
        return None
    peak = json.loads(PEAKS.read_text()).get(run.device_kind)
    if peak is None:
        return None
    frames = sum(j.frames for j in run.jobs)
    rays = sum(j.rays for j in run.jobs) / frames
    work = frame_work(run.scene, run.render, rays, run.n_shadow)
    if work is None:
        return None
    device_s = sum(j.device_ms for j in run.jobs) / 1e3 / frames
    return 100.0 * least_seconds(work, peak) / device_s
