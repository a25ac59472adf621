"""Device ms of an image() call: from its first device stamp (before the
gather or the resolve; it runs once the frames queued before it have run)
to its stamp after the readback to the host, the median over the profiled
job's calls (the port's globaltimer stamps).  On several cards rank 0's,
which gathers the bands, resolves and reads back the whole image."""

import numpy as np

from portbench import program_spans


def read(run):
    snap = program_spans.snapshot(run)
    if snap is None:
        return None
    ns = [c[-1].ns - c[0].ns for c in program_spans.call_stamps(snap, "image")]
    return float(np.median(ns)) * 1e-6 if ns else None
