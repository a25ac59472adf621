"""Host seconds of the first render_frames call, which warms up and
captures the frame graph, ending in a device sync."""


def read(run):
    return run.spans.get("capture_s")
