"""The harness's run, driven on the CPU at a tiny size (the look for a card
skipped: ``run.run_cell`` with device "cpu"), comes out correct on the
port as it is, and not correct with the timed path broken underneath: a
step that leaves the state unchanged, half of the frames left out with
the mean taken over the rest, the gather of the bands left out, the
image altered where it is resolved, and the bright paths' radiance
clamped.  A rank other than 0 that finds a forbidden module after the
window fails the run."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from portbench import run
from portbench.tests.helpers import tiny_root

torch.set_num_threads(2)
SEED = 2_147_483_659


def _run(tmp_path, workload, size=(32, 16), frames=4):
    root = tiny_root(tmp_path, workload, *size, frames)
    return run.run_cell(root, workload, SEED, 0.2, False, "cpu")


def test_a_sound_run_is_correct(tmp_path):
    res = _run(tmp_path, "default-1080p-offline")
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = set(res["metrics"])
    assert "setup_s" in names
    assert list(res)[-1] == "check"
    json.dumps(res)


def _state_unchanged(monkeypatch):
    from spt_tpu_torch.engine import state

    monkeypatch.setattr(state, "accumulate", lambda st, rad, spp: st)
    monkeypatch.setattr(state, "accumulate_", lambda st, rad, spp: st)


def _half_the_frames(monkeypatch):
    from spt_tpu_torch.engine import state

    orig = state.accumulate
    seen = []

    def accumulate(st, rad, spp):
        seen.append(1)
        if len(seen) % 2:
            return orig(st, rad, spp)
        return st._replace(frame_index=st.frame_index + 1)

    monkeypatch.setattr(state, "accumulate", accumulate)


def _image_altered(monkeypatch):
    from spt_tpu_torch.engine import renderer

    orig = renderer.resolve
    monkeypatch.setattr(renderer, "resolve",
                        lambda *a, **kw: orig(*a, **kw) * 0.99)


def _bright_paths_clamped(monkeypatch):
    # a frame's radiance clamped at BRIGHT_CLAMP, which only the brightest
    # pixels of the tiny frame pass
    from spt_tpu_torch.engine import state

    orig, orig_ = state.accumulate, state.accumulate_
    monkeypatch.setattr(state, "accumulate", lambda st, rad, spp: orig(
        st, rad.clamp(max=BRIGHT_CLAMP), spp))
    monkeypatch.setattr(state, "accumulate_", lambda st, rad, spp: orig_(
        st, rad.clamp(max=BRIGHT_CLAMP), spp))


BRIGHT_CLAMP = 0.7


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_frames,
                                   _image_altered, _bright_paths_clamped],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(tmp_path, "default-1080p-offline")
    assert not res["correct"], res["check"]
    assert res["failed"] >= 1
    if fault is _bright_paths_clamped:
        gap = res["check"]["radiance_rel_gap"]
        assert gap["value"] > gap["limit"]


def _ranks(rank, world, root, fault):
    torch.set_num_threads(1)
    if fault:
        from spt_tpu_torch.parallel import sharding

        def no_gather(mesh, accum):
            # each rank keeps its own band where the others' should be
            full = torch.zeros((accum.shape[0] * world, 3), dtype=accum.dtype)
            full[rank * accum.shape[0]:(rank + 1) * accum.shape[0]] = accum
            return full

        sharding.gather_pixels = no_gather
    return run.run_cell(root, "default-1080p-offline-4gpu", SEED, 0.2, False,
                        "cpu", rank, world)


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "no_gather"])
def test_the_bands_gathered(tmp_path, fault):
    from spt_tpu_torch.parallel import launch

    root = tiny_root(tmp_path, "default-1080p-offline-4gpu", 32, 16, 4)
    res = launch.spawn(_ranks, 2, args=(str(root), fault), backend="gloo",
                       timeout=240)[0].value
    assert res["device"]["count"] == 2
    assert res["correct"] is (not fault), res["check"]
    assert np.isfinite(res["metrics"]["msamples_per_s"]["value"])


def _ranks_finish(rank, world, root, stub_rank):
    torch.set_num_threads(1)
    if rank == stub_rank:
        orig = run.Client.job

        def job(self):
            # a module named jax loaded inside the window, on this rank only
            sys.modules.setdefault("jax", types.ModuleType("jax"))
            return orig(self)

        run.Client.job = job
    res = run.run_cell(root, "default-1080p-offline-4gpu", SEED, 0.2, False,
                       "cpu", rank, world)
    return run.finish(res, rank)


@pytest.mark.parametrize("stub_rank", [None, 1], ids=["clean", "jax_on_rank1"])
def test_every_rank_looks_for_forbidden_modules(tmp_path, stub_rank):
    from spt_tpu_torch.parallel import launch

    root = tiny_root(tmp_path, "default-1080p-offline-4gpu", 32, 16, 4)
    codes = [r.value for r in launch.spawn(
        _ranks_finish, 2, args=(str(root), stub_rank), backend="gloo",
        timeout=240)]
    if stub_rank is None:
        assert codes == [0, 0]
    else:
        assert codes == [0, 3]
    assert run.first_failure(codes) == (0 if stub_rank is None else 3)
