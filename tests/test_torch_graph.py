"""The captured frame step (engine/renderer.py ``_captured_step_dyn``) and
the conditionals it holds on the device (integrators/wavefront.py
``_cond``, ``_while_loop``; ops/cuda_graph.py).

On the CPU, where there is no graph: ``StaticStep``, the body the graph
captures, run eagerly on its fixed buffers, against ``frame_chain`` bit
for bit (every plane of the state and the stats), fresh, chained, after a
reset and after a checkpoint load, for every integrator; ``_cond`` taking
each branch of the sorted frame and returning exactly what that branch
returns, both branches returning the same shapes and dtypes; the captured
items laid out as one graph (``cuda_graph.emit`` on a recording fake: the
child graphs in order, two IF nodes a ``_cond``, a WHILE node a loop with
its predicate set before it and at its body's end, a body's forbidden
node refused); a replay's launch counts (one graph launch, the straight
line counted at once, the device-tallied bodies when
``launch_counts`` is read).  On the card (``cuda`` marker):
``Renderer.render_frames``, a captured frame replayed a frame, against
``frame_chain`` bit for bit with every integrator on default 320x240
(compact and regen also on the mesh scene), the sorted mesh frame on the
mesh scene (the condensed branch) and the instanced grid (the full-width
branch), one graph launch a frame, every launch count equal to the eager
chain's (the masked default frame, taken whole, counts one whole_frame
launch a frame where the chain counts its fused_frame launch, and its graph
is one segment of a handful of nodes), and replays that run under
``torch.cuda.set_sync_debug_mode("error")``.
"""

import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import chip_smoke  # noqa: E402
from spt_tpu_torch import config as tconfig  # noqa: E402
from spt_tpu_torch import scene as tscene  # noqa: E402
from spt_tpu_torch.camera import Camera, default_camera  # noqa: E402
from spt_tpu_torch.engine import renderer as trenderer  # noqa: E402
from spt_tpu_torch.engine import state as state_mod  # noqa: E402
from spt_tpu_torch.engine.renderer import (Renderer, StaticStep,  # noqa: E402
                                           captures, frame_chain)
from spt_tpu_torch.integrators import wavefront as twf  # noqa: E402
from spt_tpu_torch.ops import (cuda_bounce, cuda_env, cuda_graph,  # noqa: E402
                               cuda_sort, ray_sort)

CPU = torch.device("cpu")


def _same(a, b):
    """Bit for bit: float tensors compared as their int32 words."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _assert_same_run(got, want):
    (gs, gstats), (ws, wstats) = got, want
    for name, g, w in zip(("accum", "sample_count", "frame_index"), gs, ws):
        assert _same(g, w), name
    assert _same(gstats.rays_per_bounce, wstats.rays_per_bounce)
    assert _same(gstats.bounces_run, wstats.bounces_run)


def _default(w=64, h=48, device=CPU):
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=6)
    return Renderer(tscene.build_default_scene(), cfg,
                    camera=default_camera(w, h), device=device)


def _copy(st):
    return state_mod.RenderState(*(t.clone() for t in st))


def _run(step, rays, st, k):
    """`k` frames of the captured body, run eagerly, as a replay runs it."""
    step.load(rays, st)
    for _ in range(k):
        step.frame()
    return step.state, step.stats()


# --- on the CPU -------------------------------------------------------------------

def test_static_step_matches_frame_chain(tmp_path):
    # the captured body run eagerly: fresh (k = 1 and 3, the second
    # chained on the step's own state), after a reset (whose frame index is
    # the step's own tensor) and after a checkpoint load
    r = _default()
    rays = r.camera.rays(CPU)
    args = (r.cfg, r.scene, r.env, r.lights, rays)
    step = StaticStep(r.cfg, r.scene, r.env, r.lights, CPU)
    st = r.state
    for k in (1, 3):
        want = frame_chain(*args, _copy(st), k)
        got = _run(step, rays, st, k)
        _assert_same_run(got, want)
        assert got[0] is step.state
        st = got[0]
    reset = state_mod.reset(step.state)
    assert reset.frame_index is step.state.frame_index
    want = frame_chain(*args, _copy(reset), 2)
    _assert_same_run(_run(step, rays, reset, 2), want)
    path = str(tmp_path / "ck.npz")
    state_mod.save_checkpoint(path, want[0])
    loaded = state_mod.load_checkpoint(path, CPU)
    want = frame_chain(*args, _copy(loaded), 3)
    _assert_same_run(_run(step, rays, loaded, 3), want)
    with pytest.raises(ValueError, match="pixels"):
        _run(step, rays, state_mod.init_state(10, CPU), 1)


def test_static_step_band_matches_frame_chain():
    # a band of rows (the sharded step's body), k = 2
    r = _default(32, 32)
    rays = r.camera.rays(CPU)
    step = StaticStep(r.cfg, r.scene, r.env, r.lights, CPU, 16, 16)
    st = state_mod.init_state(32 * 16, CPU)
    want = frame_chain(r.cfg, r.scene, r.env, r.lights, rays, _copy(st), 2,
                       16, 16)
    _assert_same_run(_run(step, rays, st, 2), want)


@pytest.mark.parametrize("integrator, w, h, spp", [
    ("compact", 160, 120, 1), ("regen", 64, 48, 2), ("megakernel", 64, 48, 1)])
def test_static_step_matches_frame_chain_each_integrator(integrator, w, h,
                                                         spp):
    # compact at 19 200 lanes, past COMPACT_MIN_LANES, so its chunk loops
    # run; k = 1, then 2 chained on the step's own state
    cfg = tconfig.RenderConfig(width=w, height=h, spp=spp, max_depth=3,
                               integrator=integrator)
    r = Renderer(tscene.build_default_scene(), cfg,
                 camera=default_camera(w, h), device=CPU)
    rays = r.camera.rays(CPU)
    step = StaticStep(r.cfg, r.scene, r.env, r.lights, CPU)
    st = r.state
    for k in (1, 2):
        want = frame_chain(r.cfg, r.scene, r.env, r.lights, rays, _copy(st),
                           k)
        got = _run(step, rays, st, k)
        _assert_same_run(got, want)
        st = got[0]


def test_captures_the_masked_integrator_on_the_card_only():
    # every integrator is captured on the card now, none on the CPU
    cfg = tconfig.RenderConfig(width=8, height=8)
    assert captures(cfg, "cuda") and captures(cfg, torch.device("cuda", 0))
    for integrator in ("masked", "compact", "regen", "megakernel"):
        assert captures(cfg.replace(integrator=integrator), "cuda")
        assert not captures(cfg.replace(integrator=integrator), "cpu")


def test_cond_eager_takes_the_branch_pred_names():
    x = torch.arange(4.0)
    calls = []

    def f(t):
        calls.append("f")
        return t + 1, t.sum()

    def g(t):
        calls.append("g")
        return t * 2, t.max()

    for pred, want in ((True, f(x)), (False, g(x))):
        calls.clear()
        got = twf._cond(torch.tensor(pred), f, g, x)
        assert calls == ["f" if pred else "g"]
        assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", ["condensed", "unsafe_full_width"])
def test_cond_takes_each_branch_of_the_sorted_frame(case, monkeypatch):
    # the sorted-frame cases of tests/test_torch_mesh_frame.py whose flag
    # names each branch: the condense heads hold every live lane of the
    # triangle scene; on Cornell, which fills the frame, even the narrowest
    # head the plan allows (condense_width 1024) does not
    pytest.importorskip("jax")
    from test_torch_mesh_frame import _frame_case

    from spt_tpu_torch import env as tenv
    from spt_tpu_torch import lights as tlights
    from spt_tpu_torch.integrators import transport as ttr

    _, ts, w, h, cam, kw = _frame_case(case, monkeypatch)
    kw = dict(kw, condense_width=1024)
    cfg = tconfig.RenderConfig(width=w, height=h, spp=1, max_depth=4, **kw)
    assert twf._condense_plan(cfg, w * h, ray_sort.chunk_size(w * h))
    seen = []
    cond = twf._cond

    def recording_cond(pred, true_fn, false_fn, *operands):
        out = cond(pred, true_fn, false_fn, *operands)
        taken = true_fn if bool(pred) else false_fn
        seen.append((bool(pred), out, taken(*operands),
                     true_fn(*operands), false_fn(*operands)))
        return out

    monkeypatch.setattr(twf, "_cond", recording_cond)
    ps = ttr.gen_primary(cfg, Camera(**cam).rays(CPU), 0)
    lights = (tlights.LightManager().device(CPU) if case == "unsafe_full_width"
              else tlights.default_lights(CPU))
    twf._wavefront_masked(cfg, ts, tenv.make_procedural_environment(CPU),
                          lights, ps)
    (pred, out, direct, a, b), = seen
    assert pred == (case == "condensed")
    out, direct = list(twf._tensors(out)), list(twf._tensors(direct))
    assert len(out) == len(direct) == 5
    assert all(_same(x, y) for x, y in zip(out, direct))
    # radiance (N), the lane ids and the rays per bounce, in both branches
    a, b = list(twf._tensors(a)), list(twf._tensors(b))
    assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype) for t in b]
    assert [t.shape for t in a] == [(w * h,)] * 4 + [(4,)]


class _Raw:
    """A captured segment's stand-in: raw_cuda_graph() names it, and the
    fake API reads its node count and first forbidden node type."""

    def __init__(self, name, count=2, bad=-1):
        self.name, self.count, self.bad = name, count, bad

    def raw_cuda_graph(self):
        return self


class _RecordingApi:
    def __init__(self):
        self.log, self._n = [], 0

    def _node(self, kind, graph, dep, *rest):
        self._n += 1
        node = f"{kind}{self._n}"
        self.log.append((graph, dep, node, *rest))
        return node

    def nodes(self, raw):
        return raw.count, raw.bad

    def child(self, graph, dep, raw):
        return self._node("child", graph, dep, raw.name)

    def empty(self, graph, dep):
        return self._node("empty", graph, dep)

    def handle(self, graph):
        self._n += 1
        return f"h{self._n}"

    def set_cond(self, graph, dep, handle, pred, negate, taken):
        return self._node("set", graph, dep, handle, pred, negate, taken)

    def conditional(self, graph, dep, handle, kind):
        node = self._node("if" if kind == cuda_graph.IF else "while", graph,
                          dep, handle)
        return node, f"body:{node}"


def test_emit_lays_the_conditionals_out_as_one_chain():
    seg = cuda_graph.Segment
    p, q, q2 = "p", "q", "q2"
    items = [seg(_Raw("A"), {}),
             cuda_graph.Branch(p, False, [seg(_Raw("B"), {})], 0),
             cuda_graph.Branch(p, True, [seg(_Raw("C", count=0), {})], 1),
             cuda_graph.Loop(q, [seg(_Raw("D"), {})], q2, 2),
             seg(_Raw("E", count=0), {})]
    api = _RecordingApi()
    last = cuda_graph.emit(api, "top", items, 1000)
    assert api.log == [
        ("top", None, "child1", "A"),
        ("top", "child1", "set3", "h2", p, False, 1000),
        ("top", "set3", "if4", "h2"),
        ("body:if4", None, "child5", "B"),
        ("top", "if4", "set7", "h6", p, True, 1008),
        ("top", "set7", "if8", "h6"),
        # the false branch captured nothing: its body gets an empty node
        ("body:if8", None, "empty9"),
        ("top", "if8", "set11", "h10", q, False, 1016),
        ("top", "set11", "while12", "h10"),
        ("body:while12", None, "child13", "D"),
        ("body:while12", "child13", "set14", "h10", q2, False, 1016)]
    assert last == "while12"
    with pytest.raises(RuntimeError, match="event_record"):
        cuda_graph.emit(_RecordingApi(), "top", [cuda_graph.Branch(
            p, False, [seg(_Raw("F", bad=7), {})], 0)], 0)


def test_device_graph_refuses_bodies_past_the_node_limit():
    # conditional bodies of ~3 million nodes in all faulted at the graph's
    # second launch on the card (ROADMAP.md section 3, fault 3): a graph
    # past MAX_BODY_NODES raises before it is instantiated; nodes outside
    # the bodies do not count
    class Api(_RecordingApi):
        def create(self):
            return "top"

        def instantiate(self, graph):
            return "exec"

        def destroy(self, graph, exec_):
            pass

    seg, n = cuda_graph.Segment, cuda_graph.MAX_BODY_NODES

    def items(extra):
        return [seg(_Raw("A", count=4 * n), {}),
                cuda_graph.Loop("q", [seg(_Raw("B", count=n // 2), {})],
                                "q2", 0),
                cuda_graph.Branch("p", False, [cuda_graph.Loop(
                    "r", [seg(_Raw("C", count=n - n // 2 + extra), {})],
                    "r2", 2)], 1)]

    assert cuda_graph.DeviceGraph(items(0), None, api=Api()).exec == "exec"
    with pytest.raises(RuntimeError, match=f"hold {n + 1} nodes"):
        cuda_graph.DeviceGraph(items(1), None, api=Api())


def test_segmented_replay_reads_each_decision_and_counts_launches():
    # a replay is one graph launch and reads nothing: the straight line's
    # launches count at once; the device tallies each conditional body's
    # runs (here the condensed and full-width branches and a loop body), and
    # launch_counts reads the tallies of every replay so far when asked
    saved = twf.launch_counts()
    taken = torch.zeros(3, dtype=torch.int64)
    runs = iter([(1, 0, 2), (0, 1, 3)])

    class FakeDeviceGraph:
        def launch(self, device):
            taken.add_(torch.tensor(next(runs)))

    try:
        twf._set_counts({k: 0 for k in saved})
        g = twf.SegmentedGraph(CPU)
        g.graph = FakeDeviceGraph()
        g.counts = {(cuda_bounce, "BOUNCE_LAUNCHES"): 1,
                    (cuda_sort, "LAUNCHES"): 1}
        g.tallies = [{(cuda_sort, "LAUNCHES"): 3, (None, "condensed"): 1},
                     {(cuda_sort, "LAUNCHES"): 2, (None, "full_width"): 1},
                     {(cuda_env, "LAUNCHES"): 1}]
        g._tally = twf._Tally(taken, g.tallies)
        g.replay()
        assert (cuda_bounce.BOUNCE_LAUNCHES, cuda_sort.LAUNCHES,
                cuda_env.LAUNCHES) == (1, 1, 0)
        assert not twf.SORTED_SAMPLES
        g.replay()
        counts = twf.launch_counts()
        assert g.launches == 2
        assert (cuda_bounce.BOUNCE_LAUNCHES, cuda_sort.LAUNCHES,
                cuda_env.LAUNCHES) == (2, 2 + 3 + 2, 5)
        assert dict(twf.SORTED_SAMPLES) == {"condensed": 1, "full_width": 1}
        assert twf.launch_counts() == counts
    finally:
        twf._set_counts(saved)


class _Held:
    """A captured segment's stand-in whose destruction can be watched."""


@pytest.mark.parametrize("capturing", [False, True])
def test_a_graph_let_go_of_during_a_capture_waits_for_its_end(capturing,
                                                                monkeypatch):
    # a SegmentedGraph in a reference cycle, collected while a capture is
    # underway (a garbage collection may run in one), keeps its graphs until
    # the capture ends: destroying a graph would invalidate the capture;
    # outside a capture they go at once
    held = _Held()
    g = twf.SegmentedGraph(CPU)
    g.items.append(cuda_graph.Segment(held, {}))
    g.cycle = g
    gone, dead = weakref.ref(held), weakref.ref(g)
    del g, held
    monkeypatch.setattr(twf, "_SEGMENTED", object() if capturing else None)
    try:
        gc.collect()
        assert dead() is None
        assert (gone() is not None) == capturing
        assert len(twf._DEFERRED) == capturing
    finally:
        twf._DEFERRED.clear()
    assert gone() is None


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step is a CUDA graph "
                    "of the port's kernels")
    return torch.device("cuda", 0)


def _counts_of(fn):
    """The launch counts `fn` adds (launch_counts read after a sync)."""
    torch.cuda.synchronize()
    before = twf.launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in twf._count_delta(twf.launch_counts(),
                                                 before).items() if v}


def _captured_against_chain(r):
    """Renderer.render_frames(1) (the capture), (8) and (1) (replays)
    against frame_chain from the same states, bit for bit, and every launch
    count of both runs equal (the sorted frame's branches, the loop bodies'
    launches), except where the step takes its frames whole
    (``StaticStep.whole``): then the captured run counts one whole_frame
    launch a frame in the tables' placement and nothing else, where the
    chain counts its fused_frame launches; one graph launch a replayed frame; then two more frames
    replayed under sync-debug "error", bit for bit too.  Returns the
    counts the eager chain added (its nonzero ones)."""
    args = (r.cfg, r.scene, r.env, r.lights, r.camera.rays(r.device))
    frames = (1, 8, 1)
    wants = []

    def chain():
        st = r.state
        for k in frames:
            st, stats = frame_chain(*args, st, k)
            wants.append((st, stats))

    eager = _counts_of(chain)

    def captured():
        for k, want in zip(frames, wants):
            r.render_frames(k)
            _assert_same_run((r.state, r.last_stats), want)

    step = r.captured_step()
    whole = (cuda_bounce, "WHOLE_GLOBAL_LAUNCHES" if cuda_bounce.
             tables_in_global(r.cfg, r.scene, r.lights) else "WHOLE_LAUNCHES")
    assert _counts_of(captured) == (
        {whole: sum(frames)} if step.step.whole else eager)
    assert step.graph.launches == sum(frames) - 1
    want = frame_chain(*args, _copy(r.state), 2)
    rays = r.camera.rays(r.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step(rays, r.state, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_same_run(got, want)
    branches = [it for it in step.graph.items
                if isinstance(it, cuda_graph.Branch)]
    assert len(branches) == 2 * r.cfg.spp * bool(
        {k for k in eager if k[0] is None})
    return eager


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["masked", "compact", "regen",
                                        "megakernel"])
def test_captured_step_matches_frame_chain_default_on_card(cuda_device,
                                                           integrator):
    r = _default(320, 240, cuda_device)
    r.cfg = r.cfg.replace(integrator=integrator)
    # 10 frames eager, 10 captured, each run adding these: masked one
    # fused_frame a frame; compact one fused_bounce (bounce 0) and one chunk
    # a later bounce (about 11 000 lanes live after bounce 0, a chunk 19 200
    # wide); regen one iteration a bounce (some lane lives to the last); the
    # megakernel no kernel of the port
    assert _captured_against_chain(r) == {
        "masked": {(cuda_bounce, "LAUNCHES"): 10},
        "compact": {(cuda_bounce, "BOUNCE_LAUNCHES"): 10,
                    ("loop", "chunk"): 50},
        "regen": {("loop", "step"): 60},
        "megakernel": {}}[integrator]
    loops = [it for it in r.captured_step().graph.items
             if isinstance(it, cuda_graph.Loop)]
    # a chunk loop a bounce after the first; one regen loop
    assert len(loops) == {"compact": 5, "regen": 1}.get(integrator, 0)
    step = r.captured_step()
    assert step.step.whole == (integrator == "masked")
    if step.step.whole:
        # the whole-frame form: one segment, its one hand-written kernel and
        # a handful of scalar nodes (the ray counters' zeroing, the stats'
        # add and maximum, the state's two counters), no full-width pass
        nodes = chip_smoke.body_nodes(step.graph.items)
        assert len(nodes) == 1 and isinstance(nodes[0], int)
        assert nodes[0] <= 10, nodes


@pytest.mark.cuda
@pytest.mark.parametrize("scene, integrator, branch", [
    ("mesh", "masked", "condensed"), ("inst", "masked", "full_width"),
    ("mesh", "compact", None), ("mesh", "regen", None)])
def test_captured_step_matches_frame_chain_mesh_on_card(cuda_device, scene,
                                                        integrator, branch):
    make = (chip_smoke.port_mesh_scene if scene == "mesh"
            else chip_smoke.port_inst_scene)
    desc, cfg, cam = make(integrator=integrator)
    r = Renderer(desc, cfg, camera=cam, device=cuda_device)
    branches = {k[1]: v for k, v in _captured_against_chain(r).items()
                if k[0] is None}
    assert branches == ({branch: 10} if branch else {})


@pytest.mark.cuda
def test_a_graph_collected_during_a_capture_leaves_it_whole(cuda_device):
    # a built SegmentedGraph in a reference cycle, collected by a garbage
    # collection inside another capture in the global mode: its built graph
    # is destroyed when that capture ends, and the capture holds (destroyed
    # inside it, the executable invalidates it)
    gc.collect()
    x = torch.zeros(4, device=cuda_device)
    old = twf.SegmentedGraph(cuda_device)
    with old.capture():
        x.add_(1)
    built = weakref.ref(old.graph)
    old.cycle = old
    dead = weakref.ref(old)
    del old
    g = twf.SegmentedGraph(cuda_device)
    with g.capture():
        x.mul_(2)
        gc.collect()
        kept = dead() is None and built() is not None
        x.add_(3)
    assert kept and built() is None and not twf._DEFERRED
    g.replay()
    torch.cuda.synchronize()
    assert x.tolist() == [3.0] * 4


@pytest.mark.cuda
def test_a_capture_that_raises_is_ended(cuda_device):
    # the error propagates, and the stream is out of capture mode: the
    # device takes work again and the next capture holds
    x = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError, match="in the capture"):
        with twf.SegmentedGraph(cuda_device).capture():
            x.add_(1)
            raise ValueError("in the capture")
    assert twf._SEGMENTED is None
    x.add_(2)
    g = twf.SegmentedGraph(cuda_device)
    with g.capture():
        x.mul_(3)
    g.replay()
    torch.cuda.synchronize()
    assert x.tolist() == [6.0] * 4


@pytest.mark.cuda
def test_capture_is_dropped_on_resize_and_toggle(cuda_device):
    r = _default(64, 48, cuda_device)
    r.render_frames(2)
    assert isinstance(r.captured_step(), trenderer.CapturedStep)
    first = r.captured_step()
    r.toggle_integrator()
    r.render_frames(1)                      # the megakernel, captured
    r.toggle_integrator()
    assert r.captured_step() is not first
    r.resize(32, 32)
    r.render_frames(2)
    img = r.hdr_image()
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert r.accumulated_samples == 2
