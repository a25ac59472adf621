"""Path samples (pixels x spp) of every frame the window completed, over
the window's wall time, in millions a second."""


def read(run):
    return sum(j.samples for j in run.jobs) / run.window_s / 1e6
