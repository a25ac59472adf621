"""Host seconds of the first capture of the frame graph, the port's own
set-up span "capture" (the eager warm-up frame, the relaxed capture, the
global capture and the graph's build): capture_s without that call's
replays and its closing sync.  On several cards rank 0's band."""

from portbench import program_spans


def read(run):
    return program_spans.first_span_s(run, "capture")
