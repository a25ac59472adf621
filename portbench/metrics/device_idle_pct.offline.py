"""100 x (1 - the device time of the window's calls into the port, from
CUDA event pairs around each call, / the window), on several cards the mean over the ranks."""

from portbench.record import device_idle_pct


def read(run):
    return device_idle_pct(run)
