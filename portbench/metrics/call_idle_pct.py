"""100 x (1 - the replays' device time / the calls' device extent) over
the profiled job's render_frames calls: a call's extent runs from its
first device stamp (before the camera's upload) to its last (after the
stats, or on several cards after the all_reduces), its replays' time from
the stamp before each replay to the stamp after it (the port's globaltimer
stamps).  The rest is the device waiting for the host or the other ranks,
and the short copies around the replays.  On several cards rank 0's."""

from portbench import program_spans


def read(run):
    snap = program_spans.snapshot(run)
    if snap is None:
        return None
    calls = program_spans.call_stamps(snap, "render_frames")
    extent = sum(c[-1].ns - c[0].ns for c in calls)
    if extent <= 0:
        return None
    replays = sum(sum(program_spans.replay_ns(c)) for c in calls)
    return 100.0 * (1.0 - replays / extent)
