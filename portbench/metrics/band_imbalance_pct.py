"""100 x (the slowest band's device time / the mean band's - 1) over the
window: a rank's band time runs from each render call's start to where it
reaches the call's all_reduce (CUDA events)."""

import numpy as np


def read(run):
    if not run.trace or run.world < 2:
        return None
    bands = [rk.get("band_ms") for rk in run.ranks]
    if any(b is None for b in bands):
        return None
    return 100.0 * (max(bands) / float(np.mean(bands)) - 1.0)
