"""The device trace of a traced run: ``torch.profiler`` over a stretch of
jobs after the measured window.

``profile(job, n, device)`` runs `n` jobs under the profiler (CPU and
CUDA activities), after one warm-up job, and returns the seconds in which
a device operation ran (the union of the kernels' and copies'
intervals), the stretch's length on the host clock,
the ten device operations that took most time, and the ten longest idle
gaps of the device, each named by the harness's span (a
``record_function`` label ``portbench.*``) the host was in at the gap's
middle.  Annotation ranges on the device (the labels', NCCL's) are left
out: they repeat the kernels they enclose.  Kernels inside the IF and
WHILE bodies of a captured graph do not reach the trace, so on a frame
with conditional nodes ``busy_s`` is a lower bound.
"""

from __future__ import annotations

import time


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(job, n: int, device) -> dict:
    """`job` once under the profiler's warm-up step (it absorbs the
    tracer's start, which on several ranks reaches each at another time
    and would keep the others' collectives spinning), then `n` times in
    the traced step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, schedule

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    traced = []
    with torch.profiler.profile(
            activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda p: traced.extend(p.events())) as prof:
        job()
        torch.cuda.synchronize(device)
        prof.step()
        t0 = time.perf_counter()
        for _ in range(n):
            job()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
        prof.step()
    dev, spans = [], []
    for e in traced:
        label = e.name.startswith("portbench.")
        # annotations (record_function ranges, NCCL's own) repeat the
        # kernels they enclose
        note = (label or e.name.startswith("ProfilerStep")
                or getattr(e, "is_user_annotation", False))
        if e.device_type == DeviceType.CUDA and not note:
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CPU and label:
            spans.append((e.time_range.start, e.time_range.end, e.name))
    merged = _merge([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) * 1e-6
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for (s0, e0), (s1, e1) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        label = "host"
        inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        if inner:
            label = min(inner, key=lambda sp: sp[1] - sp[0])[2]
        gaps.append((label, (s1 - e0) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy, "window_s": window,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
