"""Rays traced a path sample: the window's summed rays_per_bounce (the
port's stats) under the JAX package's count_rays convention, over the
samples."""

from portbench.work.rays import count_rays


def read(run):
    if not run.trace or any(j.rays is None for j in run.jobs):
        return None
    rays = sum(count_rays(j.rays, run.n_shadow) for j in run.jobs)
    return rays / sum(j.samples for j in run.jobs)
