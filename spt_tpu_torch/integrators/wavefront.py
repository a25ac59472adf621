"""Wavefront integrator: the depth loop in few kernel launches.

The counterpart of ``spt_tpu.integrators.wavefront``: ``integrator``
"masked" (the default), "compact" and "regen".  A masked sample is
gen_primary, then the depth loop, then the deferred environment term: a
lane dies at most once by missing and keeps its direction and throughput
frozen, so one environment evaluation after the loop replaces one per
bounce.

- The route is chosen once a sample from the scene's counts alone
  (``_fused_ok``, the counterpart of ``_pallas_bounce_ok``): the fused
  kernels unless ``cuda_bounce.explain_decline`` names a reason, the same
  on every device (on the CPU the fused route runs the kernels' plain
  versions).  A declined scene (past 192 primitives without an accel,
  more than 32 spheres beside one, more than 64 materials, more than 32
  NEE emitters) logs its reason once and runs the JAX package's
  ``fused=False`` loop (``transport.bounce_loop`` in a ``_while_loop``):
  ``trace_bounce`` + ``shade_core`` while any lane lives, the environment
  term deferred to after it.  A scene the kernels take whose tables do not
  fit a block's shared memory runs them all the same, its tables read from
  global memory (``cuda_bounce.tables_in_global``).
- Small scenes and mesh scenes whose lane count cannot be sorted: the whole
  loop in ``cuda_bounce.fused_frame``.
- Mesh scenes (a cluster accel: resident, instanced or stream) at a
  sortable lane count (``_ray_sort_ok``, after the JAX package's dead-lane
  padding): ``_fused_mesh_sorted_frame`` — fused_bounce, chunked coherence sorts,
  condense, fused_frame from bounce ``ray_sort_stages``, un-condense,
  unsort.  Sorting only regroups lanes; the image matches the unsorted
  frame to float tolerance.  Whether to condense is decided by ``_cond``,
  the port's ``lax.cond``: eagerly one host read a sample, in a captured
  frame (``SegmentedGraph``) on the device.

The captured frame step (``engine/renderer.StaticStep``) takes a frame
whole on the card where ``_whole_frame_ok`` holds (masked, spp 1, a small
scene the fused kernels take, the procedural sky): one launch of
``cuda_bounce.whole_frame`` from lane index to accumulation, which keeps
the bits of this module's split frame (``render_wavefront``), the one every
other frame and the CPU run.

The compact path (``_wavefront_compact``) bounces every lane once through
``cuda_bounce.fused_bounce`` (through ``trace_bounce`` + ``shade`` on a
declined scene), then packs the live lanes into a queue
(``ops/compaction``) and bounces them in fixed-width chunks through
``transport.trace_bounce`` + ``shade``, the environment applied every
bounce; its chunks, and path regeneration's iterations
(``render_wavefront_regen``), are ``_while_loop``s, the port's
``lax.while_loop``.

Every entry takes a band of rows (``row0``, ``rows``; the whole image by
default), whose lanes carry global pixel indices: ``parallel/sharding``
renders one band a rank, and every decision that depends on the lane count
sees the band's.  Every stage is the kernel for a CUDA tensor and its plain
PyTorch version for a CPU tensor; a kernel that fails to build or launch
raises, and nothing runs in its place.  The JAX
package's block swizzle of the lane -> pixel mapping is not ported (RNG is
seeded per pixel, so the image does not depend on lane order), nor its
``SPT_SORT_ABLATE`` and ``SPT_CONDENSE_CHUNK`` hooks.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import warnings
import weakref
from typing import NamedTuple, Optional, Tuple

import torch

from spt_tpu_torch.camera import CameraRays
from spt_tpu_torch.config import RenderConfig
from spt_tpu_torch.env import Environment, environment_color_v
from spt_tpu_torch.integrators import transport
from spt_tpu_torch.lights import DeviceLights
from spt_tpu_torch.ops import (cuda_bounce, cuda_env, cuda_graph, cuda_sort,
                               cuda_trace, ray_sort)
from spt_tpu_torch.ops.compaction import (compact_gather, compact_indices,
                                          scatter_back)
from spt_tpu_torch.ops import vec3 as v3
from spt_tpu_torch.ops.vec3 import Vec3
from spt_tpu_torch.scene.flatten import DeviceScene
from spt_tpu_torch.utils import timing

# Samples the sorted mesh frame finished, by branch ("full_width" or
# "condensed"), so a run can show which one it took.
SORTED_SAMPLES = collections.Counter()

# The wrappers' launch counters, which a captured graph's replays add to
# (SegmentedGraph).
_LAUNCH_COUNTERS = (
    (cuda_bounce, "LAUNCHES"), (cuda_bounce, "BOUNCE_LAUNCHES"),
    (cuda_sort, "LAUNCHES"), (cuda_env, "LAUNCHES"),
    (cuda_trace, "CLOSEST_LAUNCHES"), (cuda_trace, "ANY_LAUNCHES"),
    (cuda_trace, "INST_CLOSEST_LAUNCHES"), (cuda_trace, "INST_ANY_LAUNCHES"),
    (cuda_trace, "STREAM_CLOSEST_LAUNCHES"),
    (cuda_trace, "STREAM_ANY_LAUNCHES"),
    (cuda_bounce, "GLOBAL_LAUNCHES"), (cuda_bounce, "GLOBAL_BOUNCE_LAUNCHES"),
    (cuda_trace, "CLOSEST_GLOBAL_LAUNCHES"),
    (cuda_trace, "ANY_GLOBAL_LAUNCHES"),
    (cuda_trace, "INST_CLOSEST_GLOBAL_LAUNCHES"),
    (cuda_trace, "INST_ANY_GLOBAL_LAUNCHES"),
    (cuda_trace, "STREAM_CLOSEST_GLOBAL_LAUNCHES"),
    (cuda_trace, "STREAM_ANY_GLOBAL_LAUNCHES"),
    (cuda_bounce, "WHOLE_LAUNCHES"), (cuda_bounce, "WHOLE_GLOBAL_LAUNCHES"))
_BRANCHES = ("condensed", "full_width")

# Runs of each _while_loop body, by the body function's name ("chunk": the
# compact path's chunks, "step": path regeneration's iterations), eager and
# replayed alike; keyed ("loop", name) among the launch counts.
LOOP_RUNS = collections.Counter()
# The condensed sorts' chunk cap (wavefront.py:290's default).
CONDENSE_CHUNK = 32768
# Lanes a row-deal moves together (one 128-lane row).
_DEAL = 128
# Below this many lanes the compact integrator takes the masked path
# (wavefront.py:205).
COMPACT_MIN_LANES = 16384
# The decline reasons _fused_ok has logged.
_ANNOUNCED: set = set()


class WavefrontStats(NamedTuple):
    """Per-bounce telemetry (the frame-0 `rays N -> hits M -> next N'` log,
    OptixBackend.cpp:1690-1695), as device tensors."""

    rays_per_bounce: torch.Tensor   # (max_depth,) int64 — live rays traced
    bounces_run: torch.Tensor       # () int64 — bounces with any live ray


def _queue_width(n: int) -> int:
    """Chunk width of the compact bounce loop (wavefront.py:73-78): about a
    quarter of the lanes, at least 8192, rounded up to a multiple of 1024."""
    w = min(max(8192, n // 4), n)
    return ((w + 1023) // 1024) * 1024 if w >= 1024 else w


def _tile_rows(rows: int) -> int:
    """pallas_bounce._tile_rows: the largest multiple-of-8 divisor of rows
    up to 64, rows itself when it is at most 64, else 0."""
    for cand in range(min(64, rows) // 8 * 8, 0, -8):
        if rows % cand == 0:
            return cand
    return rows if rows <= 64 else 0


def sort_padding(n: int) -> int:
    """Dead lanes the JAX package pads the fused path with
    (wavefront.py:651-655): none when n tiles into (rows, 128) kernel
    blocks, else up to a multiple of 8192."""
    if n % 128 == 0 and _tile_rows(n // 128) > 0:
        return 0
    return -n % (64 * 128)


def _fused_ok(cfg: RenderConfig, scene: DeviceScene,
              lights: DeviceLights) -> bool:
    """Whether a sample runs through the fused kernels (K1, K3), the
    counterpart of ``_pallas_bounce_ok`` (wavefront.py:49-62): from the
    scene's counts alone, before any launch, the same on every device (on
    the CPU the fused route runs the kernels' plain versions).  A scene
    that ``cuda_bounce.explain_decline`` declines logs each distinct
    reason once (``pallas_bounce.announce_decline``, :236-247) and takes
    the unfused bounce.  A scene the kernels take but whose tables do not
    fit a block's shared memory runs them too, reading its tables from
    global memory (``cuda_bounce.tables_in_global``).  Not a fallback: a
    kernel of an accepted scene that fails raises."""
    reason = cuda_bounce.explain_decline(cfg, scene, lights)
    if reason is None:
        return True
    if reason not in _ANNOUNCED:
        _ANNOUNCED.add(reason)
        logging.getLogger("spt_tpu_torch").warning(
            "fused kernels declined (%s); the frame runs the unfused "
            "bounce (trace_bounce + shade_core)", reason)
    return False


def _whole_frame_ok(cfg: RenderConfig, scene: DeviceScene, env: Environment,
                    lights: DeviceLights, start_bounce: int = 0) -> bool:
    """Whether a frame on the card runs whole (``cuda_bounce.whole_frame``):
    the masked integrator at spp 1 from bounce 0, a scene the fused kernels
    take in the small form (no accel mode) and the procedural sky.  From
    the inputs alone, so a CPU test can ask it.  Every other frame (an HDR
    map, a mesh, compact, regen, the megakernel, spp > 1) runs the split
    frame."""
    return (cfg.integrator == "masked" and cfg.spp == 1 and start_bounce == 0
            and not env.enabled and cuda_bounce._accel_mode(scene) is None
            and _fused_ok(cfg, scene, lights))


def _ray_sort_ok(cfg: RenderConfig, scene: DeviceScene, n: int) -> bool:
    """Sort bounce rays: mesh scenes only, a chunkable lane count and at
    least one bounce after the primary (wavefront.py:262-270).  Asked only
    on the fused route, as the JAX package asks it only under ``fused``."""
    return (cfg.ray_sort and cfg.ray_sort_stages > 0
            and scene.accel is not None and cfg.max_depth > 1
            and ray_sort.chunk_size(n) > 0)


def _condense_plan(cfg: RenderConfig, n: int, chunk: int):
    """(wc, m, mp, sort_chunk) for the post-primary condense, or None
    (wavefront.py:273-317): wc lanes gathered from the head of each chunk,
    m = n_chunks * wc condensed lanes, mp = m padded to a power of two, and
    the condensed sorts' chunk."""
    if not cfg.condense:
        return None
    n_chunks = n // chunk
    if cfg.condense_width > 0:
        wc = min(cfg.condense_width, chunk // 2)
    else:
        wc = min(max(1024, (49152 // n_chunks) // 128 * 128), chunk // 2)
    if wc < 1024 or wc % 128:
        return None
    m = n_chunks * wc
    mp = 1 << (m - 1).bit_length()
    if mp >= n:
        return None
    sort_chunk = min(mp, CONDENSE_CHUNK)
    if mp % sort_chunk or (mp // 128) % 8:
        return None
    return wc, m, mp, sort_chunk


def _pack_flags(ps, missed_ever) -> torch.Tensor:
    return (ps.alive.to(torch.int32) | (ps.emission_ok.to(torch.int32) << 1)
            | (missed_ever.to(torch.int32) << 2))


def _zeros3(like: torch.Tensor) -> Vec3:
    z = torch.zeros_like(like)
    return Vec3(z, z, z)


def launch_counts() -> dict:
    """Every wrapper's launch counter, SORTED_SAMPLES' branches and
    LOOP_RUNS, keyed (module, counter name), (None, branch) and ("loop",
    body name).  The launches of a captured
    graph's conditional bodies are tallied on the device
    (SegmentedGraph.replay); they are read here, once for all the replays
    since the last call (one sync), and folded into the counters first."""
    while _PENDING:
        _PENDING.pop().fold()
    return _raw_counts()


def _raw_counts() -> dict:
    counts = {(m, a): getattr(m, a) for m, a in _LAUNCH_COUNTERS}
    counts.update({(None, b): SORTED_SAMPLES[b] for b in _BRANCHES})
    counts.update({("loop", k): v for k, v in LOOP_RUNS.items()})
    return counts


def _set_counts(counts: dict) -> None:
    LOOP_RUNS.clear()
    for (m, a), v in counts.items():
        if m is None or m == "loop":
            tally = SORTED_SAMPLES if m is None else LOOP_RUNS
            if v:
                tally[a] = v
            else:
                tally.pop(a, None)
        else:
            setattr(m, a, v)


def _add_counts(delta: dict) -> None:
    counts = _raw_counts()
    for k, v in delta.items():
        counts[k] = counts.get(k, 0) + v
    _set_counts(counts)


def _count_delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for t in tree:
            yield from _tensors(t)


def _rebuild(tree, leaves):
    """`tree` with its tensors replaced, in order, by those of `leaves`."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    items = [_rebuild(t, leaves) for t in tree]
    return (type(tree)(*items) if hasattr(tree, "_fields")
            else type(tree)(items))


def _own(tree):
    """`tree` with every tensor cloned: buffers a loop may update in place
    without touching its caller's tensors, none of them sharing memory."""
    return _rebuild(tree, (t.clone() for t in _tensors(tree)))


def _assign(carry, new) -> None:
    """Copy the tensors of `new` into those of `carry`, in order (a loop
    body's result into the loop's buffers).  A tensor of `new` that shares
    memory with a buffer other than its own is copied first, so that no
    copy reads what an earlier one wrote."""
    dst, src = list(_tensors(carry)), list(_tensors(new))
    if [(t.shape, t.dtype) for t in dst] != [(t.shape, t.dtype) for t in src]:
        raise ValueError("_while_loop: the body returns tensors of other "
                         "shapes or dtypes than its carry")
    storages = {t.untyped_storage().data_ptr() for t in dst}

    def same(a, b):
        return (a.data_ptr() == b.data_ptr() and a.stride() == b.stride())

    src = [s.clone() if not same(d, s)
           and s.untyped_storage().data_ptr() in storages else s
           for d, s in zip(dst, src)]
    for d, s in zip(dst, src):
        if not same(d, s):
            d.copy_(s)


class _Tally:
    """A captured graph's device tally: `taken[slot]` counts the runs of
    conditional body `slot`, whose launches are `counts[slot]`; `folded`
    what the counters already hold."""

    def __init__(self, taken: torch.Tensor, counts: list):
        self.taken, self.counts = taken, counts
        self.folded = [0] * len(counts)

    def fold(self) -> None:
        runs = self.taken.tolist()
        for slot, n in enumerate(runs):
            if n != self.folded[slot]:
                _add_counts({k: v * (n - self.folded[slot])
                             for k, v in self.counts[slot].items()})
        self.folded = runs


# Tallies replayed since launch_counts last read them.
_PENDING: list = []
# What SegmentedGraphs let go of while a capture was underway (their
# segments' graphs and the built graph): destroying the built graph's
# executable there invalidates a capture in the global mode (it is no
# stream work), so it waits for the capture's end, the segments with it.
_DEFERRED: list = []


def _let_go(owned: list) -> None:
    """A SegmentedGraph's finalizer: `owned` (its items and built graph)
    is destroyed now, or, while a capture is underway (a garbage collection
    may run in one), when that capture ends."""
    if _SEGMENTED is not None:
        _DEFERRED.append(owned)


class SegmentedGraph:
    """Work captured as one CUDA graph with its conditionals on the device:
    the captured frame step's graph (engine/renderer.py).

    What runs inside ``capture`` is captured in segments, each a
    ``torch.cuda.CUDAGraph(keep_graph=True)`` in one private memory pool
    (``pool``).  A ``_cond`` met there ends the segment after its
    predicate and captures each branch as a body of its own (the second
    copying its outputs into the first's, so what follows reads one set of
    buffers; an output of the first that is an operand is cloned first, so
    the copy writes no operand); a ``_while_loop`` ends it after its first
    predicate and captures its body once, with the next predicate at its
    end.  At the end of ``capture`` the segments become one graph
    (``ops/cuda_graph``): child-graph nodes in sequence, two IF nodes a
    ``_cond`` (on the predicate and on its negation), one WHILE node a
    loop, each set from its predicate on the device.  ``replay`` is one
    graph launch and reads nothing.  The pool holds because the nodes run
    in the order they were captured, a body skipped or run again; a loop's
    carry lives in buffers of its own, updated in place (``_while_loop``).

    A wrapper counts its launch where it is recorded, so ``capture`` leaves
    every launch count as it found it and keeps what was counted in the
    graph's straight line (``counts``, added at every replay) and in each
    conditional body (``tallies``, SORTED_SAMPLES too); a replay adds the
    first, and the device counts the runs of each body, which
    ``launch_counts`` reads when asked.  ``launches`` counts the graph
    launches.

    What the object holds of CUDA graphs is destroyed when it dies, or,
    if it dies while a capture is underway, when that capture ends
    (``_let_go``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        # cuda_graph.Segment / Branch / Loop; the segments' graphs hold the
        # pool
        self.items: list = []
        self.pool = None
        self.launches = 0
        self.counts: dict = {}
        self.tallies: list = []     # a conditional body's counts, by slot
        self.graph = None           # the cuda_graph.DeviceGraph
        self._tally = None
        self._items = self.items
        self._mode = "global"
        self._graph = self._counts = None
        self._capturing = False
        self._owned = [self.items]
        weakref.finalize(self, _let_go, self._owned).atexit = False

    @contextlib.contextmanager
    def capture(self, mode: str = "global"):
        """Capture what runs inside (on a side stream, in the given
        cudaStreamCaptureMode) into this object's graph, built at the end;
        a capture in the relaxed mode (the warm-up that is thrown away) is
        not built.  A capture that raises is ended (on its stream, where
        PyTorch ends a capture) before the error propagates, so the stream
        leaves capture mode.  The build is the set-up span "graph_build"
        (utils/timing.py)."""
        global _SEGMENTED
        if _SEGMENTED is not None:
            raise RuntimeError("a SegmentedGraph capture is already underway")
        torch.cuda.synchronize(self.device)
        self.pool, self._mode = torch.cuda.graph_pool_handle(), mode
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        before = launch_counts()
        _SEGMENTED = self
        try:
            with torch.cuda.stream(stream):
                try:
                    self._begin()
                    yield self
                    self._end()
                except BaseException:
                    if self._capturing:
                        self._capturing = False
                        with contextlib.suppress(Exception):
                            self._graph.capture_end()
                    raise
        finally:
            _SEGMENTED = None
            _set_counts(before)
            _DEFERRED.clear()
        current.wait_stream(stream)
        if mode != "relaxed":
            with timing.setup_span("graph_build"):
                self._build()

    def _begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        self._counts = _raw_counts()
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode=self._mode)
        self._capturing = True

    def _end(self) -> None:
        self._capturing = False
        with warnings.catch_warnings():
            # a segment may be empty (a conditional right after another)
            warnings.simplefilter("ignore")
            self._graph.capture_end()
        self._items.append(cuda_graph.Segment(
            self._graph, _count_delta(_raw_counts(), self._counts)))

    def _body(self, fn):
        """(the items captured from fn(), its result), between segments."""
        outer, self._items = self._items, []
        try:
            self._begin()
            out = fn()
            self._end()
            return self._items, out
        finally:
            self._items = outer

    def cond(self, pred, true_fn, false_fn, operands):
        """``_cond`` while this object captures."""
        pred = pred.to(torch.bool)
        self._end()
        inputs = {t.data_ptr() for t in _tensors(operands)}
        leaves = []

        def first():
            out = true_fn(*operands)
            leaves.extend(t.clone() if t.data_ptr() in inputs else t
                          for t in _tensors(out))
            return out

        def second():
            other = list(_tensors(false_fn(*operands)))
            if [(t.shape, t.dtype) for t in other] != [
                    (t.shape, t.dtype) for t in leaves]:
                raise ValueError("_cond: the branches return tensors of "
                                 "different shapes or dtypes")
            for a, b in zip(leaves, other):
                a.copy_(b)

        true_body, outs = self._body(first)
        false_body, _ = self._body(second)
        for negate, body in ((False, true_body), (True, false_body)):
            self._items.append(cuda_graph.Branch(pred, negate, body,
                                                 self._slot()))
        self._begin()
        return _rebuild(outs, iter(leaves))

    def while_loop(self, cond_fn, body_fn, carry):
        """``_while_loop`` while this object captures, on a carry of the
        loop's own buffers."""
        pred = cond_fn(carry).to(torch.bool)
        self._end()

        def body():
            _run_body(body_fn, carry)
            return cond_fn(carry).to(torch.bool)

        items, pred_next = self._body(body)
        self._items.append(cuda_graph.Loop(pred, items, pred_next,
                                           self._slot()))
        self._begin()
        return carry

    def _slot(self) -> int:
        self.tallies.append(None)
        return len(self.tallies) - 1

    def _build(self) -> None:
        """Sum what each part counted, then build the one graph."""
        def walk(items, into):
            for it in items:
                if isinstance(it, cuda_graph.Segment):
                    for k, v in it.counts.items():
                        if v:
                            into[k] = into.get(k, 0) + v
                else:
                    self.tallies[it.slot] = {}
                    walk(it.body, self.tallies[it.slot])

        walk(self.items, self.counts)
        taken = None
        if self.tallies:
            taken = torch.zeros(len(self.tallies), dtype=torch.int64,
                                device=self.device)
            self._tally = _Tally(taken, self.tallies)
        self.graph = cuda_graph.DeviceGraph(self.items, taken)
        self._owned.append(self.graph)

    def replay(self) -> None:
        """One launch of the graph on the current stream: no host read."""
        self.graph.launch(self.device)
        _add_counts(self.counts)
        if self._tally is not None and self._tally not in _PENDING:
            _PENDING.append(self._tally)
        self.launches += 1


_SEGMENTED: Optional[SegmentedGraph] = None


def _cond(pred: torch.Tensor, true_fn, false_fn, *operands):
    """The port's ``jax.lax.cond``: ``true_fn(*operands)`` where the 0-dim
    bool `pred` holds, else ``false_fn(*operands)``; both return tensors of
    the same structure, shapes and dtypes.  Eager (on the CPU, or on the
    card outside a capture) it reads ``bool(pred)``, one sync, and runs the
    branch it names; while a ``SegmentedGraph`` captures, it captures both
    branches as the bodies of two IF nodes, and the device decides at each
    replay.  Both branches must have run once outside the capture (or in a
    capture thrown away, ``capture(mode="relaxed")``) before it."""
    if _SEGMENTED is not None:
        return _SEGMENTED.cond(pred, true_fn, false_fn, operands)
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def _while_loop(cond_fn, body_fn, carry):
    """The port's ``jax.lax.while_loop``: while the 0-dim bool
    ``cond_fn(carry)`` holds, ``carry = body_fn(carry)``; returns the last
    carry.  The carry (a tree of tensors) is first copied into buffers of
    the loop's own, and each body's result is copied into them (``_assign``:
    the same shapes and dtypes), so every run of the body reads and writes
    the same tensors.  Eager (on the CPU, or on the card outside a capture)
    it reads ``bool(cond_fn(carry))`` before each run, one sync; while a
    ``SegmentedGraph`` captures, it captures the body once as the body of a
    WHILE node, and the device decides at each replay.  Each run counts in
    LOOP_RUNS under the body's name."""
    carry = _own(carry)
    if _SEGMENTED is not None:
        return _SEGMENTED.while_loop(cond_fn, body_fn, carry)
    while bool(cond_fn(carry)):
        _run_body(body_fn, carry)
    return carry


def _run_body(body_fn, carry) -> None:
    LOOP_RUNS[body_fn.__name__] += 1
    _assign(carry, body_fn(carry))


def _fused_mesh_sorted_frame(cfg: RenderConfig, scene: DeviceScene,
                             env: Environment, lights: DeviceLights, ps):
    """The depth loop with coherence sorts between bounces
    (wavefront.py:320-624):

        fused_bounce(0)                      # full width, pixel order
        -> row-deal -> sort                  # full width, chunk-local
        -> condense                          # gather chunk heads, narrow sort
        -> fused_bounce(1) -> sort -> ... -> fused_frame(start_bounce=S)
        -> un-condense -> scatter -> unsort -> un-interleave

    Primary misses are settled in pixel order before the first sort, so
    every lane that is dead from then on owes nothing.  The condensed branch
    runs when every live lane sits within the first wc lanes of its chunk
    after the first sort, as the JAX package's lax.cond decides it on the
    device: here through ``_cond``, which reads the flag to the host
    eagerly (one sync a sample) and leaves it on the device in a captured
    frame.  Returns
    ((N,) radiance Vec3 with the environment term applied, rays
    (max_depth,) int64)."""
    n = ps.num_paths
    chunk = ray_sort.chunk_size(n)
    live0 = ps.alive.sum()
    stages = min(cfg.ray_sort_stages, cfg.max_depth - 1)
    a = scene.accel
    lo = a.cluster_lo.min(0).values
    inv_extent = 1.0 / torch.clamp(a.cluster_hi.max(0).values - lo, min=1e-9)

    ps, missed0 = cuda_bounce.fused_bounce(cfg, scene, lights, ps, 0,
                                           cfg.max_depth == 1)
    env0 = environment_color_v(env, ps.direction, need=missed0)
    rad0 = ps.radiance + v3.where(missed0, ps.throughput * env0,
                                  _zeros3(ps.radiance.x))

    # row-dealt chunking: 128-lane rows go round-robin to the sort chunks,
    # so every chunk receives about the same number of survivors
    n_chunks = n // chunk
    g = chunk // _DEAL

    def interleave(x):
        return x.reshape(g, n_chunks, _DEAL).transpose(0, 1).reshape(n)

    def uninterleave(x):
        return x.reshape(n_chunks, g, _DEAL).transpose(0, 1).reshape(n)

    flags0 = interleave(_pack_flags(ps, torch.zeros_like(missed0)))
    o, d, thr = (Vec3(*(interleave(c) for c in v))
                 for v in (ps.origin, ps.direction, ps.throughput))
    ps = transport.PathState(
        origin=o, direction=d, throughput=thr, radiance=_zeros3(o.x),
        rng=interleave(ps.rng), alive=(flags0 & 1) != 0,
        emission_ok=(flags0 & 2) != 0)
    missed_ever = (flags0 & 4) != 0
    orig_lane = torch.arange(n, dtype=torch.int64, device=live0.device)

    def sort_state(ps, missed_ever, lane, chunk_, carry_rad):
        """One coherence sort of the path state and `lane`; the first
        sort's radiance is all zero and is not carried."""
        key = ray_sort.sort_key(ps.direction, ps.origin, ps.alive, lo,
                                inv_extent)
        _, out = ray_sort.sort_by_key(key, [
            lane, *ps.origin, *ps.direction, *ps.throughput,
            *(ps.radiance if carry_rad else ()), ps.rng,
            _pack_flags(ps, missed_ever)], chunk_)
        lane, o, d, thr = out[0], Vec3(*out[1:4]), Vec3(*out[4:7]), Vec3(*out[7:10])
        rad = Vec3(*out[10:13]) if carry_rad else _zeros3(o.x)
        rng, flags = out[-2], out[-1]
        return transport.PathState(
            origin=o, direction=d, throughput=thr, radiance=rad, rng=rng,
            alive=(flags & 1) != 0, emission_ok=(flags & 2) != 0,
        ), (flags & 4) != 0, lane

    ps, missed_ever, orig_lane = sort_state(ps, missed_ever, orig_lane, chunk,
                                            carry_rad=False)

    def rest_of_frame(ps, missed_ever, lane, chunk_):
        """Bounces 1..S-1 with a re-sort after each, then fused_frame, at
        whatever width `ps` has.  Returns (radiance with the deferred env
        applied, lane, rays with entry 0 left zero)."""
        rays_tail = []
        for b in range(1, stages):
            rays_tail.append(ps.alive.sum())
            ps, missed = cuda_bounce.fused_bounce(cfg, scene, lights, ps, b,
                                                  b == cfg.max_depth - 1)
            missed_ever = missed_ever | missed
            ps, missed_ever, lane = sort_state(ps, missed_ever, lane, chunk_,
                                               carry_rad=True)
        rays_tail.append(ps.alive.sum())
        radiance, direction, throughput, missed, rays_f = (
            cuda_bounce.fused_frame(cfg, scene, lights, ps,
                                    start_bounce=stages))
        missed_ever = missed_ever | missed
        env_c = environment_color_v(env, direction, need=missed_ever)
        radiance = radiance + v3.where(missed_ever, throughput * env_c,
                                       _zeros3(radiance.x))
        rays = torch.stack([torch.zeros_like(rays_f[0])] + rays_tail
                           + [rays_f[b] for b in range(stages + 1,
                                                       cfg.max_depth)])
        return radiance, lane, rays

    def full_width(ps, missed_ever, lane):
        SORTED_SAMPLES["full_width"] += 1
        return rest_of_frame(ps, missed_ever, lane, chunk)

    plan = _condense_plan(cfg, n, chunk)
    if plan is None:
        radiance, orig_lane, rays_rest = full_width(ps, missed_ever, orig_lane)
    else:
        wc, m, mp, sort_chunk = plan

        def head(x):
            h = x.reshape(n_chunks, chunk)[:, :wc].reshape(m)
            return torch.nn.functional.pad(h, (0, mp - m)) if mp > m else h

        def condensed(ps, missed_ever, lane):
            SORTED_SAMPLES["condensed"] += 1
            flags_h = head(_pack_flags(ps, missed_ever))
            o_h = Vec3(*(head(c) for c in ps.origin))
            d_h = Vec3(*(head(c) for c in ps.direction))
            key = ray_sort.sort_key(d_h, o_h, (flags_h & 1) != 0, lo,
                                    inv_extent)
            # cl_lane (the condensed array's own lane ids) rides every
            # condensed sort; the un-condense restores gather order, so
            # `lane` never sees the cross-chunk moves
            cl_lane, out = ray_sort.sort_by_key(key, [
                *o_h, *d_h, *(head(c) for c in ps.throughput), head(ps.rng),
                flags_h], sort_chunk)
            o, d, thr = Vec3(*out[0:3]), Vec3(*out[3:6]), Vec3(*out[6:9])
            ps_c = transport.PathState(
                origin=o, direction=d, throughput=thr, radiance=_zeros3(o.x),
                rng=out[9], alive=(out[10] & 1) != 0,
                emission_ok=(out[10] & 2) != 0)
            radiance_c, cl_lane, rays_rest = rest_of_frame(
                ps_c, (out[10] & 4) != 0, cl_lane, sort_chunk)
            back = ray_sort.unsort_by_lane(cl_lane, list(radiance_c),
                                           sort_chunk)

            def scatter(vals):
                # lanes outside the heads are dead with their env term settled
                full = torch.zeros((n_chunks, chunk), dtype=vals.dtype,
                                   device=vals.device)
                full[:, :wc] = vals[:m].reshape(n_chunks, wc)
                return full.reshape(n)

            return Vec3(*(scatter(c) for c in back)), lane, rays_rest

        pos = torch.arange(n, device=live0.device) % chunk
        # gather-safety: every live lane within the first wc of its chunk
        safe = torch.where(ps.alive, pos, -1).max() < wc
        radiance, orig_lane, rays_rest = _cond(safe, condensed, full_width,
                                               ps, missed_ever, orig_lane)

    out = ray_sort.unsort_by_lane(orig_lane, list(radiance), chunk)
    radiance = rad0 + Vec3(*(uninterleave(c) for c in out))
    rays = torch.cat([live0.reshape(1), rays_rest[1:]])
    return radiance, rays


def _wavefront_masked(cfg: RenderConfig, scene: DeviceScene, env: Environment,
                      lights: DeviceLights, ps: transport.PathState):
    """The depth loop of one sample plus the deferred env term
    (wavefront.py:627-707): through the fused kernels where ``_fused_ok``
    holds, else the unfused loop (fused=False): a ``_while_loop`` of
    ``trace_bounce`` + ``shade_core`` over every lane while any lives, its
    trips the bounces run."""
    fused = _fused_ok(cfg, scene, lights)
    n = ps.num_paths
    n_pad = sort_padding(n)
    if fused and _ray_sort_ok(cfg, scene, n + n_pad):
        if n_pad:
            def pad(t):
                return torch.nn.functional.pad(t, (0, n_pad))

            ps = transport.PathState(
                origin=Vec3(*map(pad, ps.origin)),
                direction=Vec3(*map(pad, ps.direction)),
                throughput=Vec3(*map(pad, ps.throughput)),
                radiance=Vec3(*map(pad, ps.radiance)),
                rng=pad(ps.rng), alive=pad(ps.alive),
                emission_ok=pad(ps.emission_ok))
        radiance, rays = _fused_mesh_sorted_frame(cfg, scene, env, lights, ps)
        return (Vec3(*(c[:n] for c in radiance)).to_array(),
                WavefrontStats(rays_per_bounce=rays,
                               bounces_run=(rays > 0).sum()))
    if fused:
        radiance, direction, throughput, missed_ever, rays = (
            cuda_bounce.fused_frame(cfg, scene, lights, ps))
        bounces = (rays > 0).sum()
    else:
        ps, missed_ever, rays, bounces = transport.bounce_loop(
            cfg, scene, lights, ps, while_loop=_while_loop)
        radiance, direction, throughput = (ps.radiance, ps.direction,
                                           ps.throughput)
    env_c = environment_color_v(env, direction, need=missed_ever)
    radiance = radiance + v3.where(missed_ever, throughput * env_c,
                                   _zeros3(radiance.x))
    return radiance.to_array(), WavefrontStats(rays_per_bounce=rays,
                                               bounces_run=bounces)


def _bounce(cfg: RenderConfig, scene: DeviceScene, env: Environment,
            lights: DeviceLights, ps, bounce: int, is_last: bool,
            fused: bool = False):
    """One full bounce with the environment term applied to the lanes that
    missed (wavefront.py:150-158): through fused_bounce (K3) when `fused`,
    else through trace_bounce + shade (the standalone tracers on a mesh
    scene on the card)."""
    if not fused:
        hit = transport.trace_bounce(scene, ps)
        return transport.shade(cfg, scene, env, lights, ps, hit, bounce,
                               is_last)
    new_ps, missed = cuda_bounce.fused_bounce(cfg, scene, lights, ps, bounce,
                                              is_last)
    env_c = environment_color_v(env, ps.direction, need=missed)
    radiance = new_ps.radiance + v3.where(missed, ps.throughput * env_c,
                                          _zeros3(ps.radiance.x))
    return new_ps._replace(radiance=radiance)


def _wavefront_compact(cfg: RenderConfig, scene: DeviceScene,
                       env: Environment, lights: DeviceLights, ps):
    """The compacted depth loop of one sample (wavefront.py:205-259).

    Bounce 0 runs over every lane through fused_bounce (K3: the small form
    on small scenes, the mesh forms on mesh scenes), or through
    trace_bounce + shade on a scene ``_fused_ok`` declines.  Each later bounce
    packs the live lanes into a queue by an exclusive scan and bounces them
    in chunks of ``_queue_width(N)`` lanes, fused=False as the JAX
    package's chunks do.  The queue is padded to a whole number of chunks
    with entries that point past the last lane: they gather a masked-dead
    lane and scatter into a scratch lane, so no chunk slides backwards and
    bounces a lane twice.  As in the JAX package the live count stays on
    the device: the bounces are unrolled (a bounce with no live lane runs
    no chunk), and the chunks are a ``_while_loop`` on a device counter
    (the JAX package's fori_loop over a dynamic chunk count).

    Returns ((N, 3) radiance, stats); rays_per_bounce equals the masked
    path's, and bounces_run counts bounce 0 and every bounce with a live
    lane (a bounce with none ends the path for good)."""
    ps, rays = _compact_loop(cfg, scene, env, lights, ps)
    return ps.radiance.to_array(), WavefrontStats(
        rays_per_bounce=rays, bounces_run=1 + (rays[1:] > 0).sum())


def _compact_loop(cfg: RenderConfig, scene: DeviceScene, env: Environment,
                  lights: DeviceLights, ps):
    """_wavefront_compact's bounces -> (the final PathState, rays per
    bounce (max_depth,) int64)."""
    n = ps.num_paths
    device = ps.rng.device
    rays = torch.zeros(cfg.max_depth, dtype=torch.int64, device=device)
    rays[0].fill_(n)
    ps = _bounce(cfg, scene, env, lights, ps, 0, cfg.max_depth == 1,
                 fused=_fused_ok(cfg, scene, lights))
    w = _queue_width(n)
    pad = torch.full(((n + w - 1) // w * w - n,), n, dtype=torch.int64,
                     device=device)
    lane = torch.arange(w, device=device)
    for bounce in range(1, cfg.max_depth):
        queue, count = compact_indices(ps.alive)
        rays[bounce] = count
        queue = torch.cat([queue, pad])
        is_last = bounce == cfg.max_depth - 1

        def more(carry):
            return carry[0] < count

        def chunk(carry):
            start, ps = carry
            pos = start + lane
            idx = queue[pos]
            sub = compact_gather(ps, idx)
            sub = sub._replace(alive=sub.alive & (pos < count))
            sub = _bounce(cfg, scene, env, lights, sub, bounce, is_last)
            return start + w, scatter_back(sub, idx, ps, count - start)

        start = torch.zeros((), dtype=torch.int64, device=device)
        _, ps = _while_loop(more, chunk, (start, ps))
    return ps, rays


def wavefront_sample(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index,
    sample_index: int = 0,
    row0: int = 0,
    rows: Optional[int] = None,
    compact: bool = False,
) -> Tuple[torch.Tensor, WavefrontStats]:
    """One sample per pixel of the band of `rows` rows from `row0` (the
    whole image by default) -> ((W * rows, 3) radiance, stats).  `compact`
    takes the compacted loop, except below COMPACT_MIN_LANES lanes or at
    depth 1, where the masked path runs (wavefront.py:205).  Every decision
    that depends on the lane count (padding, sort chunk, condense, queue
    width) sees the band's, as in the JAX package (wavefront.py:191)."""
    ps = transport.gen_primary(cfg, camera, frame_index, sample_index,
                               row0, rows)
    if (compact and cfg.max_depth > 1
            and ps.num_paths >= COMPACT_MIN_LANES):
        return _wavefront_compact(cfg, scene, env, lights, ps)
    return _wavefront_masked(cfg, scene, env, lights, ps)


def render_wavefront(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index=0,
    row0: int = 0,
    rows: Optional[int] = None,
    compact: bool = False,
) -> Tuple[torch.Tensor, WavefrontStats]:
    """cfg.spp samples -> ((rows, W, 3) linear radiance, summed stats), for
    the band of `rows` rows from `row0` (the whole image by default).

    Lane scheduling comes from cfg.integrator ("masked" | "compact" |
    "regen"); the `compact` argument is an explicit override for A/B runs,
    as in the JAX package.  Nothing here talks to another process: each
    band of a sharded frame runs it on its own."""
    if rows is None:
        rows = cfg.height
    if cfg.integrator == "regen":
        return render_wavefront_regen(cfg, scene, env, lights, camera,
                                      frame_index, row0, rows)
    if cfg.integrator not in ("masked", "compact"):
        raise ValueError(
            f"integrator={cfg.integrator!r} is not a wavefront integrator "
            "('masked', 'compact' or 'regen'); the megakernel renders "
            "through integrators.megakernel")
    compact = compact or cfg.integrator == "compact"
    device = camera.position.device
    acc = torch.zeros((cfg.width * rows, 3), dtype=torch.float32,
                      device=device)
    rays = torch.zeros(cfg.max_depth, dtype=torch.int64, device=device)
    bounces = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(cfg.spp):
        rad, stats = wavefront_sample(cfg, scene, env, lights, camera,
                                      frame_index, s, row0, rows,
                                      compact=compact)
        acc = acc + rad
        rays = rays + stats.rays_per_bounce
        bounces = torch.maximum(bounces, stats.bounces_run)
    img = (acc / cfg.spp).reshape(rows, cfg.width, 3)
    return img, WavefrontStats(rays_per_bounce=rays, bounces_run=bounces)


def render_wavefront_regen(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index=0,
    row0: int = 0,
    rows: Optional[int] = None,
) -> Tuple[torch.Tensor, WavefrontStats]:
    """Path regeneration (wavefront.py:805-909): the whole cfg.spp budget in
    one loop, over the band of `rows` rows from `row0` (the whole image by
    default).  The moment a lane's path ends, its radiance is retired into
    the lane's accumulator and the lane restarts with its pixel's next
    sample; the sample set and its RNG streams are those of
    render_wavefront.  Every iteration traces through
    ``transport.trace_bounce`` and ``transport.shade`` — on a mesh scene
    the standalone cluster or instanced tracer (``ops/cuda_trace``), with
    no fused kernels and no coherence sorts.  The loop is a ``_while_loop``
    on the device (wavefront.py:868-905's lax.while_loop): it ends when no
    lane of the band is left or after cfg.spp * max_depth iterations."""
    if scene.accel is not None or scene.inst is not None:
        warnings.warn(
            "integrator 'regen' traces mesh scenes without the fused kernels "
            "or the coherence sorts: expect several times the 'masked' "
            "integrator's frame time on this scene", stacklevel=2)
    if rows is None:
        rows = cfg.height
    n = cfg.width * rows
    device = camera.position.device
    sample_idx = torch.zeros(n, dtype=torch.int64, device=device)
    ps = transport.primary_lanes(cfg, camera, frame_index, sample_idx,
                                 cfg.spp > 1, row0, rows)
    accum = _zeros3(ps.radiance.x)
    bounce = torch.zeros(n, dtype=torch.int64, device=device)
    rays = torch.zeros(cfg.max_depth, dtype=torch.int64, device=device)
    depths = torch.arange(cfg.max_depth, device=device)
    it = torch.zeros((), dtype=torch.int64, device=device)

    def more(carry):
        it, ps = carry[:2]
        return (it < cfg.spp * cfg.max_depth) & ps.alive.any()

    def step(carry):
        it, ps, accum, bounce, sample_idx, rays = carry
        was_alive = ps.alive
        rays = rays + ((bounce[None, :] == depths[:, None])
                       & was_alive[None, :]).sum(1)
        hit = transport.trace_bounce(scene, ps)
        ps = transport.shade(cfg, scene, env, lights, ps, hit, bounce=bounce,
                             is_last=bounce >= cfg.max_depth - 1)
        bounce = torch.where(was_alive, bounce + 1, bounce)
        died = was_alive & ~ps.alive
        accum = accum + v3.where(died, ps.radiance, _zeros3(accum.x))
        sample_next = sample_idx + died.to(torch.int64)
        respawn = died & (sample_next < cfg.spp)
        fresh = transport.primary_lanes(cfg, camera, frame_index, sample_next,
                                        cfg.spp > 1, row0, rows)
        ps = transport.PathState(
            origin=v3.where(respawn, fresh.origin, ps.origin),
            direction=v3.where(respawn, fresh.direction, ps.direction),
            throughput=v3.where(respawn, fresh.throughput, ps.throughput),
            radiance=v3.where(respawn, fresh.radiance, ps.radiance),
            rng=torch.where(respawn, fresh.rng, ps.rng),
            alive=ps.alive | respawn,
            emission_ok=ps.emission_ok | respawn,
        )
        bounce = torch.where(respawn, 0, bounce)
        return it + 1, ps, accum, bounce, sample_next, rays

    it, _, accum, _, _, rays = _while_loop(
        more, step, (it, ps, accum, bounce, sample_idx, rays))
    img = accum.to_array() / cfg.spp
    return img.reshape(rows, cfg.width, 3), WavefrontStats(
        rays_per_bounce=rays, bounces_run=it)
