"""Seconds from the process's start to the first timed job: imports, the
kernel library, the scene, the Renderer, the warm-up and the capture of
the frame graph."""


def read(run):
    return run.setup_s
