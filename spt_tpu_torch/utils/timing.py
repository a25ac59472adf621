"""The port's spans and device stamps, recorded in this process.

A span is a named stretch of host time (``time.perf_counter_ns``) with an
id and its parent's id: the span that was open when it began (0 at the
top).  A stamp is the device's ``%globaltimer`` (ns), written by a
one-thread kernel (``spt_stamp``, ``csrc/spt_graph.cu``) into a slot of a
ring on the card, enqueued on the current stream between two pieces of
work: two stamps bracket the device time of what was enqueued between
them.  Neither enters a captured graph.

What is recorded, and when:

- hot-path spans (``span``) and every stamp (``stamp``) only while a
  ``torch.profiler`` records (its enabled flag: under a schedule, the
  active steps alone).  Then each span also opens
  ``torch.profiler.record_function("spt.<name>")``, so it appears in the
  profiler's trace on the profiler's clock.  Otherwise a span is one flag
  check and a shared null context, and a stamp one flag check: nothing is
  allocated or launched;
- set-up spans (``setup_span``, ``record``) always: they happen once a
  library, Renderer or capture.

The first stamp on a card allocates its ring and calibrates the card's
clock against the host's: a few rounds of a stamp waited for between two
host clock readings, the narrowest bracket kept (``calibrate``).  Stamps
are read back only by ``snapshot()``, one copy a card, and given on the
host clock.  Spans and stamps are kept in bounded stores (the newest
``CAPACITY`` of each); ``clear()`` empties them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple

import torch

CAPACITY = 8192      # spans kept; stamps kept, and slots of a card's ring
CAL_ROUNDS = 8       # stamps of the calibration

_NULL = contextlib.nullcontext()
_enabled = torch.autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    id: int
    parent: int          # the enclosing span's id, 0 at the top
    start_ns: int        # time.perf_counter_ns()
    end_ns: int


class Stamp(NamedTuple):
    label: str           # what follows it on the stream
    span: int            # the innermost span open when it was enqueued
    device: int          # the card's index
    ns: int              # when it ran, on the host clock (perf_counter_ns)


class Snapshot(NamedTuple):
    spans: List[Span]    # in the order they ended
    stamps: List[Stamp]  # in the order they were enqueued
    offsets: Dict[int, tuple]   # card -> (globaltimer - host ns, bracket ns)


class StampApi:
    """The device side of a stamp: ``spt_stamp`` of the kernel library,
    which writes the globaltimer into the int64 at `slot` on `stream`.  A
    test hands the recorder a fake."""

    def __init__(self):
        from spt_tpu_torch.ops import cuda_lib

        self._check = cuda_lib.check
        self._fn = cuda_lib.build().spt_stamp

    def stamp(self, slot: int, stream: int) -> None:
        self._check(self._fn(slot, stream), "spt_stamp")


def _stream(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.current_stream(device).cuda_stream
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate(api, ticks: torch.Tensor, clock=time.perf_counter_ns) -> tuple:
    """(globaltimer - host clock, the bracket) in ns: len(ticks) rounds of
    a stamp into ``ticks[i]`` waited for between two readings of `clock`;
    the round whose readings lie closest together gives the offset, from
    their midpoint.  The stamps are read in one copy after the rounds."""
    device = ticks.device
    stream = _stream(device)
    brackets = []
    for i in range(ticks.numel()):
        h0 = clock()
        api.stamp(ticks.data_ptr() + 8 * i, stream)
        _sync(device)
        brackets.append((clock() - h0, h0))
    values = ticks.tolist()
    width, h0, i = min((w, h, i) for i, (w, h) in enumerate(brackets))
    return values[i] - (h0 + width // 2), width


class _Open:
    """An open span: pushed on its thread's stack at enter, stored at exit."""

    __slots__ = ("rec", "name", "id", "parent", "start", "label")

    def __init__(self, rec, name):
        self.rec, self.name, self.label = rec, name, None

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(self.rec._ids)
        stack.append(self.id)
        if _enabled():
            self.label = torch.profiler.record_function("spt." + self.name)
            self.label.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.label is not None:
            self.label.__exit__(*exc)
        self.rec._stack().pop()
        self.rec.spans.append(Span(self.name, self.id, self.parent,
                                   self.start, end))
        return False


class Recorder:
    """The bounded stores of spans and stamps, a ring a card, and each
    card's clock offset.  `api` makes the stamps (``StampApi`` by default,
    made at the first stamp)."""

    def __init__(self, capacity: int = CAPACITY, api=None):
        self.capacity = capacity
        self.api = api
        self.spans = collections.deque(maxlen=capacity)
        # (sequence number, card, label, span id): a stamp's slot in its
        # card's ring is its number modulo the capacity, so the records
        # kept hold distinct slots
        self.stamps = collections.deque(maxlen=capacity)
        self.rings: Dict[int, torch.Tensor] = {}
        self.offsets: Dict[int, tuple] = {}
        self._ids = itertools.count(1)
        self._seq = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str) -> _Open:
        return _Open(self, name)

    def record(self, name: str, start_ns: int, end_ns: int) -> None:
        """A span that has ended, under the span open now."""
        stack = self._stack()
        self.spans.append(Span(name, next(self._ids),
                               stack[-1] if stack else 0, start_ns, end_ns))

    def stamp(self, label: str, device) -> None:
        """Enqueue a stamp on `device`'s current stream (a card's only)."""
        device = torch.device(device)
        if device.type != "cuda":
            return
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        ring = self.rings.get(index)
        if ring is None:
            ring = self._enable(torch.device("cuda", index))
        seq = next(self._seq)
        self.api.stamp(ring.data_ptr() + 8 * (seq % self.capacity),
                       _stream(ring.device))
        stack = self._stack()
        self.stamps.append((seq, index, label, stack[-1] if stack else 0))

    def _enable(self, device: torch.device) -> torch.Tensor:
        if self.api is None:
            self.api = StampApi()
        ticks = torch.zeros(CAL_ROUNDS, dtype=torch.int64, device=device)
        self.offsets[device.index] = calibrate(self.api, ticks)
        ring = torch.zeros(self.capacity, dtype=torch.int64, device=device)
        self.rings[device.index] = ring
        return ring

    def snapshot(self) -> Snapshot:
        """What was recorded, each stamp on the host clock: one copy of
        each card's ring, after the card has run what was enqueued."""
        values = {}
        for index, ring in self.rings.items():
            _sync(ring.device)
            values[index] = ring.tolist()
        stamps = [Stamp(label, span, dev,
                        values[dev][seq % self.capacity]
                        - self.offsets[dev][0])
                  for seq, dev, label, span in self.stamps]
        return Snapshot(list(self.spans), stamps, dict(self.offsets))

    def clear(self) -> None:
        self.spans.clear()
        self.stamps.clear()


RECORDER = Recorder()


def recording() -> bool:
    """Whether a torch.profiler records now: hot-path spans and stamps are
    recorded only then."""
    return _enabled()


def span(name: str):
    """A hot-path span: recorded only while a torch.profiler records."""
    if not _enabled():
        return _NULL
    return RECORDER.open(name)


def setup_span(name: str):
    """A set-up span: always recorded."""
    return RECORDER.open(name)


def record(name: str, start_ns: int, end_ns: int) -> None:
    """A set-up span that has ended (work that overlapped others), under
    the span open now."""
    RECORDER.record(name, start_ns, end_ns)


def stamp(label: str, device) -> None:
    """A device stamp on `device`'s current stream, while a torch.profiler
    records; on the CPU nothing."""
    if _enabled():
        RECORDER.stamp(label, device)


def snapshot() -> Snapshot:
    return RECORDER.snapshot()


def clear() -> None:
    RECORDER.clear()
