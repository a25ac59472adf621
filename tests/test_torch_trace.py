"""The port's spans and device stamps (``spt_tpu_torch.utils.timing``) and
the benchmark's readers of them (``portbench/metrics``).

On the CPU: with no profiler, a Renderer's ``render_frames`` and
``image()`` record no hot-path span and reach no stamp; under
``torch.profiler`` they record the span tree (names, parents) and the
stamps in their order, and the profiler's events hold the spans; on a
mesh (a gloo world of one) the "reduce" and "gather" spans; set-up spans
are recorded with no profiler; the stores keep to their bound; the clock
calibration keeps the narrowest bracket (a fake stamp entry); each reader
returns None without a trace or without the recorder, and the value
worked out by hand from a made-up record.  The captured step runs on the
CPU with its graph's replay played by the eager frame, so the call's
spans and stamps are those of the card's path.  On the card (``cuda``
marker): the replays' stamps against CUDA events around the call, and a
stamp's host time inside its sync bracket.
"""

import ctypes
import importlib.util
import socket
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from portbench.record import RunRecord  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.camera import default_camera  # noqa: E402
from spt_tpu_torch.engine import renderer as trenderer  # noqa: E402
from spt_tpu_torch.utils import timing  # noqa: E402
from spt_tpu_torch.utils.timing import Snapshot, Span, Stamp  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _renderer(device=CPU, w=16, h=8, **kw):
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=3)
    return trenderer.Renderer(tscene.build_default_scene(), cfg,
                              camera=default_camera(w, h), device=device,
                              **kw)


class _EagerGraph:
    """A replay played by the step's eager frame."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step.frame()


@pytest.fixture
def captured_on_cpu(monkeypatch):
    """The Renderer takes the captured step on the CPU; its capture keeps
    an eager graph."""
    monkeypatch.setattr(trenderer, "captures", lambda cfg, device: True)

    def capture(self):
        self.graph = _EagerGraph(self.step)

    monkeypatch.setattr(trenderer.CapturedStep, "_capture", capture)


@pytest.fixture
def stamps(monkeypatch):
    """Every stamp that reaches the recorder, as (label, device type)."""
    seen = []
    monkeypatch.setattr(timing.RECORDER, "stamp", lambda label, device:
                        seen.append((label, torch.device(device).type)))
    return seen


@pytest.fixture(autouse=True)
def _empty_store():
    timing.clear()
    yield
    timing.clear()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _tree(spans, names):
    """{name: parent's name} of the spans called one of `names`."""
    by_id = {s.id: s.name for s in spans}
    return {s.name: by_id.get(s.parent) for s in spans if s.name in names}


HOT = {"render_frames", "camera_upload", "load", "replays", "stats",
       "reduce", "image", "gather", "resolve", "readback"}


def test_without_profiler_no_hot_span_and_no_stamp(captured_on_cpu, stamps):
    r = _renderer()
    r.render_frames(1)
    r.render_frames(3)
    img = r.image()
    assert img.shape == (8, 16, 3)
    assert not timing.recording()
    assert not [s for s in timing.snapshot().spans if s.name in HOT]
    assert stamps == []


def test_profiler_records_the_span_tree_and_the_stamps(captured_on_cpu,
                                                       stamps):
    r = _renderer()
    r.render_frames(1)          # the capture, outside the profiler
    with _profile() as prof:
        assert timing.recording()
        r.render_frames(3)
        r.image()
    spans = timing.snapshot().spans
    assert _tree(spans, HOT) == {
        "render_frames": None, "camera_upload": "render_frames",
        "load": "render_frames", "replays": "render_frames",
        "stats": "render_frames", "image": None, "resolve": "image",
        "readback": "image"}
    for s in spans:
        assert s.start_ns <= s.end_ns
    assert [label for label, _ in stamps] == [
        "upload", "load", "replay", "replay", "replay", "stats", "end",
        "image", "readback", "end"]
    assert {dev for _, dev in stamps} == {"cpu"}
    names = {e.name for e in prof.events()}
    assert {"spt.render_frames", "spt.image", "spt.replays",
            "spt.camera_upload", "spt.resolve"} <= names


def test_frame_chain_under_profiler_records_its_spans(stamps):
    r = _renderer()
    with _profile():
        r.render_frames(2)
    spans = timing.snapshot().spans
    assert _tree(spans, HOT) == {"render_frames": None,
                                 "camera_upload": "render_frames"}
    assert [label for label, _ in stamps] == ["upload"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_mesh_records_reduce_and_gather(stamps):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        r = _renderer(multi_device=True)
        assert r.mesh is not None
        with _profile():
            r.render_frames(2)
            r.image()
    finally:
        dist.destroy_process_group()
    snap = timing.snapshot()
    assert _tree(snap.spans, HOT) == {
        "render_frames": None, "camera_upload": "render_frames",
        "reduce": "render_frames", "image": None, "gather": "image",
        "resolve": "image", "readback": "image"}
    assert _tree(snap.spans, {"renderer_init", "mesh", "replicate"}) == {
        "renderer_init": None, "mesh": "renderer_init",
        "replicate": "renderer_init"}
    assert [label for label, _ in stamps] == [
        "upload", "reduce", "end", "image", "readback", "end"]


def test_setup_spans_without_profiler():
    r = _renderer()
    assert r.scene is not None
    spans = timing.snapshot().spans
    assert _tree(spans, {"renderer_init", "flatten", "env_lights", "state",
                         "mesh", "replicate"}) == {
        "renderer_init": None, "flatten": "renderer_init",
        "env_lights": "renderer_init", "state": "renderer_init"}
    with timing.setup_span("library"):
        t0 = time.perf_counter_ns()
        timing.record("compile.a.cu", t0, t0 + 5)
        with timing.setup_span("link"):
            pass
    spans = timing.snapshot().spans
    assert _tree(spans, {"library", "compile.a.cu", "link"}) == {
        "library": None, "compile.a.cu": "library", "link": "library"}
    assert [s.end_ns - s.start_ns for s in spans
            if s.name == "compile.a.cu"] == [5]


class _FakeStamps:
    """Writes the next of `ticks` at the slot's address, as spt_stamp
    writes the globaltimer there."""

    def __init__(self, ticks):
        self.ticks = iter(ticks)
        self.calls = []

    def stamp(self, slot, stream):
        self.calls.append((slot, stream))
        ctypes.c_int64.from_address(slot).value = next(self.ticks)


def test_store_keeps_to_its_bound():
    rec = timing.Recorder(capacity=4, api=_FakeStamps(range(1000, 2000)))
    for i in range(10):
        with rec.open(f"s{i}"):
            pass
    assert [s.name for s in rec.spans] == ["s6", "s7", "s8", "s9"]
    # a card's ring made beforehand, on the CPU: the slots cycle
    rec.rings[0] = torch.zeros(4, dtype=torch.int64)
    rec.offsets[0] = (100, 0)
    for i in range(10):
        rec.stamp(f"t{i}", "cuda:0")
    snap = rec.snapshot()
    assert [s.label for s in snap.stamps] == ["t6", "t7", "t8", "t9"]
    assert [s.ns for s in snap.stamps] == [906, 907, 908, 909]
    assert len(rec.spans) == 4 and rec.rings[0].numel() == 4
    rec.clear()
    assert rec.snapshot().spans == [] and rec.snapshot().stamps == []


def test_calibration_keeps_the_narrowest_bracket():
    # host readings (start, end) of three rounds: brackets 50, 10 and 30 ns
    readings = iter([100, 150, 1000, 1010, 2000, 2030])
    api = _FakeStamps([5125, 6005, 7015])
    offset, width = timing.calibrate(api, torch.zeros(3, dtype=torch.int64),
                                     clock=lambda: next(readings))
    assert (offset, width) == (6005 - 1005, 10)
    assert len(api.calls) == 3


# --- the readers ---------------------------------------------------------------

def _reader(name):
    path = REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(trace):
    return RunRecord(workload="w", render={}, world=1, trace=trace, jobs=[],
                     window_s=1.0, setup_s=1.0, spans={}, n_shadow=1)


def _made_up_snapshot():
    s = 1_000_000_000
    spans = [Span("renderer_init", 1, 0, 0, 2 * s),
             Span("capture", 2, 0, 3 * s, 3 * s + s // 2),
             Span("capture", 3, 0, 9 * s, 11 * s),
             Span("replays", 5, 4, 0, 0), Span("render_frames", 4, 0, 0, 0),
             Span("replays", 7, 6, 0, 0), Span("render_frames", 6, 0, 0, 0),
             Span("image", 8, 0, 0, 0)]
    stamps = [Stamp("upload", 4, 0, 0), Stamp("load", 4, 0, 100),
              Stamp("replay", 5, 0, 150), Stamp("replay", 5, 0, 1150),
              Stamp("stats", 4, 0, 2250), Stamp("end", 4, 0, 2300),
              Stamp("upload", 6, 0, 5000), Stamp("load", 6, 0, 5400),
              Stamp("replay", 7, 0, 5500), Stamp("stats", 6, 0, 6700),
              Stamp("end", 6, 0, 6800),
              Stamp("image", 8, 0, 7000), Stamp("readback", 8, 0, 7500),
              Stamp("end", 8, 0, 8000)]
    return Snapshot(spans, stamps, {0: (0, 0)})


# replays 1000, 1100 and 1200 ns; calls 2300 and 1800 ns long
WANT = {"replay_device_ms": 1100e-6,
        "call_idle_pct": 100.0 * (1.0 - 3300 / 4100),
        "image_device_ms": 1000e-6,
        "renderer_init_s": 2.0,
        "graph_capture_s": 0.5}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_without_trace_or_recorder(name, monkeypatch):
    monkeypatch.setattr(timing, "snapshot", _made_up_snapshot)
    reader = _reader(name)
    assert reader.read(_run(trace=False)) is None
    monkeypatch.delattr(timing, "snapshot")
    assert reader.read(_run(trace=True)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value_from_made_up_record(name, monkeypatch):
    monkeypatch.setattr(timing, "snapshot", _made_up_snapshot)
    assert _reader(name).read(_run(trace=True)) == pytest.approx(
        WANT[name], rel=1e-12)


def test_stamp_readers_none_without_stamps(monkeypatch):
    monkeypatch.setattr(timing, "snapshot", lambda: Snapshot(
        [Span("render_frames", 1, 0, 0, 5)], [], {}))
    for name in ("replay_device_ms", "call_idle_pct", "image_device_ms",
                 "renderer_init_s", "graph_capture_s"):
        assert _reader(name).read(_run(trace=True)) is None, name


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamps are a kernel of the "
                    "port's library")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replay_stamps_within_cuda_events_on_card(cuda_device):
    r = _renderer(cuda_device, 320, 240)
    r.render_frames(2)              # the capture
    torch.cuda.synchronize()
    with _profile():
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        r.render_frames(8)
        e1.record()
    e1.synchronize()
    stamps = timing.snapshot().stamps
    assert [s.label for s in stamps] == (["upload", "load"] + ["replay"] * 8
                                         + ["stats", "end"])
    ns = [s.ns for s in stamps]
    assert ns == sorted(ns)
    replays = [b - a for a, b in zip(ns[2:], ns[3:11])]
    assert len(replays) == 8 and min(replays) > 0
    event_ns = e0.elapsed_time(e1) * 1e6
    # both clocks tick in steps of up to a microsecond
    assert sum(replays) <= ns[-1] - ns[0] <= event_ns + 2000
    assert r.captured_step().graph.launches == 9


@pytest.mark.cuda
def test_stamp_host_time_inside_its_sync_bracket_on_card(cuda_device):
    with _profile():
        timing.stamp("first", cuda_device)      # calibrates the card
        torch.cuda.synchronize()
        h0 = time.perf_counter_ns()
        timing.stamp("x", cuda_device)
        torch.cuda.synchronize()
        h1 = time.perf_counter_ns()
    snap = timing.snapshot()
    offset, width = snap.offsets[cuda_device.index]
    assert 0 < width < 1_000_000
    (got,) = [s.ns for s in snap.stamps if s.label == "x"]
    # the offset is known to half its bracket; the globaltimer ticks in
    # steps of up to a microsecond
    slack = width // 2 + 1000
    assert h0 - slack <= got <= h1 + slack
