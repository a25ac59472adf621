"""The captured frame step (engine/renderer.py ``_captured_step_dyn``) and
the sorted frame's ``_cond`` (integrators/wavefront.py).

On the CPU, where there is no graph: ``StaticStep``, the body the graph
captures, run eagerly on its fixed buffers, against ``frame_chain`` bit
for bit (every plane of the state and the stats), fresh, chained, after a
reset and after a checkpoint load; ``_cond`` taking each branch of the
sorted frame and returning exactly what that branch returns, both
branches returning the same shapes and dtypes; a segmented graph's replay
(the graphs in order, the branch the decision names, the launch counts).  On the card (``cuda`` marker): ``Renderer.render_frames``,
a captured frame replayed a frame, against ``frame_chain`` bit for bit on
default 320x240 (one graph a frame), the mesh scene (the condensed branch)
and the instanced grid (the full-width branch; both sorted frames three
graphs a frame around the host's read of the decision), with the branch
counts equal.
"""

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
from spt_tpu_torch.ops import cuda_bounce, cuda_sort, ray_sort  # noqa: E402

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


def test_captures_the_masked_integrator_on_the_card_only():
    cfg = tconfig.RenderConfig(width=8, height=8)
    assert captures(cfg, "cuda") and captures(cfg, torch.device("cuda", 0))
    assert not captures(cfg, "cpu")
    for integrator in ("compact", "regen", "megakernel"):
        assert not captures(cfg.replace(integrator=integrator), "cuda")


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


class _FakeGraph:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def replay(self):
        self.log.append(self.name)


def test_segmented_replay_reads_each_decision_and_counts_launches():
    # the replay of a frame captured in segments: the graphs in order, at a
    # conditional the branch its predicate names (one host read), and the
    # launch counts each graph's capture counted
    saved = twf.launch_counts()
    try:
        twf._set_counts({k: 0 for k in saved})
        log, pred = [], torch.tensor(True)
        g = twf.SegmentedGraph(CPU)
        g.segments = [
            (_FakeGraph(log, "head"), {(cuda_bounce, "BOUNCE_LAUNCHES"): 1,
                                       (cuda_sort, "LAUNCHES"): 1}),
            (pred, (_FakeGraph(log, "condensed"),
                    {(cuda_sort, "LAUNCHES"): 3, (None, "condensed"): 1}),
             (_FakeGraph(log, "full_width"),
              {(cuda_sort, "LAUNCHES"): 2, (None, "full_width"): 1})),
            (_FakeGraph(log, "tail"), {})]
        g.replay()
        pred.fill_(False)
        g.replay()
        assert log == ["head", "condensed", "tail", "head", "full_width",
                       "tail"]
        assert g.launches == 6
        assert cuda_bounce.BOUNCE_LAUNCHES == 2 and cuda_sort.LAUNCHES == 7
        assert dict(twf.SORTED_SAMPLES) == {"condensed": 1, "full_width": 1}
    finally:
        twf._set_counts(saved)


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step is a CUDA graph "
                    "of the port's kernels")
    return torch.device("cuda", 0)


def _captured_against_chain(r):
    """Renderer.render_frames(1) (the capture), (8) and (1) (replays)
    against frame_chain from the same states, bit for bit, and the sorted
    frame's branch counts of both runs equal.  Returns those counts."""
    args = (r.cfg, r.scene, r.env, r.lights, r.camera.rays(r.device))
    frames = (1, 8, 1)
    twf.SORTED_SAMPLES.clear()
    st, wants = r.state, []
    for k in frames:
        st, stats = frame_chain(*args, st, k)
        wants.append((st, stats))
    eager = dict(twf.SORTED_SAMPLES)
    twf.SORTED_SAMPLES.clear()
    for k, want in zip(frames, wants):
        r.render_frames(k)
        _assert_same_run((r.state, r.last_stats), want)
    assert dict(twf.SORTED_SAMPLES) == eager
    graph = r.captured_step().graph
    # one graph a frame, three where the sorted frame decides (the frame
    # up to the decision, the branch, the rest)
    assert graph.launches == 9 * len(graph.segments)
    assert len(graph.segments) == (3 if eager else 1)
    return eager


@pytest.mark.cuda
def test_captured_step_matches_frame_chain_default_on_card(cuda_device):
    r = _default(320, 240, cuda_device)
    before = cuda_bounce.LAUNCHES
    assert _captured_against_chain(r) == {}
    # 10 frames eager, 10 captured: one fused_frame a frame either way
    assert cuda_bounce.LAUNCHES - before == 20


@pytest.mark.cuda
@pytest.mark.parametrize("scene, branch", [("mesh", "condensed"),
                                           ("inst", "full_width")])
def test_captured_step_matches_frame_chain_mesh_on_card(cuda_device, scene,
                                                        branch):
    make = (chip_smoke.port_mesh_scene if scene == "mesh"
            else chip_smoke.port_inst_scene)
    desc, cfg, cam = make()
    r = Renderer(desc, cfg, camera=cam, device=cuda_device)
    branches = _captured_against_chain(r)
    assert branches == {branch: 10}


@pytest.mark.cuda
def test_capture_is_dropped_on_resize_and_toggle(cuda_device):
    r = _default(64, 48, cuda_device)
    r.render_frames(2)
    assert isinstance(r.captured_step(), trenderer.CapturedStep)
    first = r.captured_step()
    r.toggle_integrator()
    r.render_frames(1)                      # the megakernel, eager
    r.toggle_integrator()
    assert r.captured_step() is not first
    r.resize(32, 32)
    r.render_frames(2)
    img = r.hdr_image()
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert r.accumulated_samples == 2
