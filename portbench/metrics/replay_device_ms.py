"""Device ms of one replay of the captured frame: the median, over the
replays of the profiled job, of the port's device stamp after a replay
minus its stamp before it (globaltimer, enqueued outside the graph).  On
several cards rank 0's: its band's frame."""

import numpy as np

from portbench import program_spans


def read(run):
    snap = program_spans.snapshot(run)
    if snap is None:
        return None
    ns = [d for call in program_spans.call_stamps(snap, "render_frames")
          for d in program_spans.replay_ns(call)]
    return float(np.median(ns)) * 1e-6 if ns else None
