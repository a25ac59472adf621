"""Host seconds of the benchmark's scene conversion and the Renderer's
constructor (flatten, accel build, upload)."""


def read(run):
    return run.spans.get("scene_build_s")
