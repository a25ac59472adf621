"""The port's own spans and device stamps (``spt_tpu_torch.utils.timing``),
as the ``program_span`` readers in ``metrics/`` take them.

The port records its hot-path spans and device stamps only while a
``torch.profiler`` records: in a traced run, the profiled job after the
window (``trace.py``: the profiler's active step, not its warm-up); its
set-up spans always.  A reader takes them from this process once the run
is over, so on several cards they are rank 0's.  Where the run is not
traced, or the port records nothing of the kind (a checkout without the
recorder), there is nothing to read: None.
"""

from __future__ import annotations


def snapshot(run):
    """The port's record (``timing.Snapshot``) of a traced run, or None."""
    if not run.trace:
        return None
    try:
        from spt_tpu_torch.utils.timing import snapshot as take
    except ImportError:
        return None
    return take()


def first_span_s(run, name: str):
    """Seconds of the earliest span called `name`, or None."""
    snap = snapshot(run)
    spans = [s for s in snap.spans if s.name == name] if snap else []
    if not spans:
        return None
    first = min(spans, key=lambda s: s.start_ns)
    return (first.end_ns - first.start_ns) * 1e-9


def call_stamps(snap, name: str) -> list:
    """The device stamps enqueued inside each span called `name` (inside
    it or any span under it), in the order they were enqueued: one list a
    call that has any."""
    parent = {s.id: s.parent for s in snap.spans}
    calls = {s.id: [] for s in snap.spans if s.name == name}
    for st in snap.stamps:
        sid = st.span
        while sid and sid not in calls:
            sid = parent.get(sid, 0)
        if sid:
            calls[sid].append(st)
    return [c for c in calls.values() if c]


def replay_ns(stamps) -> list:
    """Device ns of each replay of a call: from the stamp before it
    ("replay") to the stamp after it."""
    return [b.ns - a.ns for a, b in zip(stamps, stamps[1:])
            if a.label == "replay"]
