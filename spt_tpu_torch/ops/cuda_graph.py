"""One CUDA graph from captured segments, with conditional nodes.

The C entries of ``csrc/spt_graph.cu`` through ctypes.  A frame captured
in segments (``integrators/wavefront.SegmentedGraph``: each segment a
``torch.cuda.CUDAGraph(keep_graph=True)``, all in one memory pool) is a
list of items:

- ``Segment``: straight-line work, a child-graph node;
- ``Branch``: an IF node whose body runs when the 0-dim bool ``pred`` is
  true (false where ``negate``) — a ``lax.cond`` is two of them;
- ``Loop``: a WHILE node whose body runs while ``pred`` holds, ``pred``
  computed before the node and ``pred_next`` at the body's end.

``emit`` lays the items out as one chain of nodes, each conditional after
a ``set_cond_kernel`` node that sets its handle from the predicate and
adds one to the body's slot of the device tally ``taken`` when the body
will run.  ``DeviceGraph`` owns the graph and its executable; a replay is
one ``cudaGraphLaunch`` on the current stream.  Every C entry returns its
CUDA error, which ``cuda_lib.check`` raises: nothing falls back.  Nothing
here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import List, NamedTuple

from spt_tpu_torch.ops import cuda_lib

IF, WHILE = 0, 1

# Nodes the conditional bodies of one graph may hold in all.  On an H100
# under CUDA 12.8, bodies of ~3.0 million kernel nodes (two WHILE bodies of
# 1.5 million, or one of 3.0 million) ran right at the graph's first launch
# and faulted with an illegal address at its second, where 2.2 million (two
# of 1.1 million) and 1.7 million in one body ran right at every launch, as
# did 3.0 million outside any conditional (graph_probe.py; ROADMAP.md
# section 3, fault 3).  A graph past it raises before it is instantiated.
MAX_BODY_NODES = 2_200_000

# cudaGraphNodeType values a conditional body may not hold, by name
NODE_TYPES = {3: "host", 6: "wait_event", 7: "event_record",
              8: "ext_semaphore_signal", 9: "ext_semaphore_wait",
              10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op"}


class Segment(NamedTuple):
    graph: object       # torch.cuda.CUDAGraph(keep_graph=True), captured
    counts: dict        # the launch counts its capture counted


class Branch(NamedTuple):
    pred: object        # 0-dim bool tensor
    negate: bool
    body: list
    slot: int           # its entry of the device tally


class Loop(NamedTuple):
    pred: object        # 0-dim bool tensor: whether the body runs first
    body: list
    pred_next: object   # 0-dim bool tensor the body computes: run again
    slot: int


class Api:
    """The C entries, each returning the object it makes (a pointer as an
    int); ``emit`` calls these, a test hands it a recording fake."""

    def __init__(self):
        self.lib = cuda_lib.build()

    def _out(self, fn, what, *args):
        out = ctypes.c_void_p()
        cuda_lib.check(fn(*args, ctypes.byref(out)), what)
        return out.value

    def create(self) -> int:
        return self._out(self.lib.spt_graph_create, "cudaGraphCreate")

    def nodes(self, graph) -> tuple:
        """(node count, type of the first node a body may not hold or
        -1)."""
        count, bad = ctypes.c_int(0), ctypes.c_int(-1)
        cuda_lib.check(self.lib.spt_graph_nodes(graph, ctypes.byref(count),
                                                ctypes.byref(bad)),
                       "cudaGraphGetNodes")
        return count.value, bad.value

    def child(self, graph, dep, child) -> int:
        return self._out(self.lib.spt_graph_add_child,
                         "cudaGraphAddChildGraphNode", graph, dep, child)

    def empty(self, graph, dep) -> int:
        return self._out(self.lib.spt_graph_add_empty, "cudaGraphAddEmptyNode",
                         graph, dep)

    def handle(self, graph) -> int:
        h = ctypes.c_ulonglong(0)
        cuda_lib.check(self.lib.spt_graph_cond_handle(graph, ctypes.byref(h)),
                       "cudaGraphConditionalHandleCreate")
        return h.value

    def set_cond(self, graph, dep, handle, pred, negate, taken) -> int:
        return self._out(self.lib.spt_graph_add_set_cond, "set_cond_kernel",
                         graph, dep, handle, pred.data_ptr(), int(negate),
                         taken)

    def conditional(self, graph, dep, handle, kind) -> tuple:
        node, body = ctypes.c_void_p(), ctypes.c_void_p()
        cuda_lib.check(self.lib.spt_graph_add_conditional(
            graph, dep, handle, kind, ctypes.byref(node), ctypes.byref(body)),
            "cudaGraphAddNode(conditional)")
        return node.value, body.value

    def instantiate(self, graph) -> int:
        return self._out(self.lib.spt_graph_instantiate, "cudaGraphInstantiate",
                         graph)

    def launch(self, exec_, stream) -> None:
        cuda_lib.check(self.lib.spt_graph_launch(exec_, stream),
                       "cudaGraphLaunch")

    def destroy(self, graph, exec_) -> None:
        if exec_:
            self.lib.spt_graph_exec_destroy(exec_)
        if graph:
            self.lib.spt_graph_destroy(graph)


def emit(api, graph, items: List, taken: int, dep=None, body: bool = False,
         held: list = None):
    """Append `items` to `graph` as a chain after the node `dep` (None: the
    graph's first); returns the last node.  `taken` is the address of the
    device tally (unsigned 64-bit words by slot).  In a conditional body
    (`body`) a segment holding a node a body may not hold raises, naming
    its type, and its nodes are added to ``held[0]``; a body left with no
    node gets an empty one."""
    held = [0] if held is None else held
    for it in items:
        if isinstance(it, Segment):
            raw = it.graph.raw_cuda_graph()
            count, bad = api.nodes(raw)
            if body and bad >= 0:
                raise RuntimeError(
                    "a conditional body may hold kernel, memcpy, memset, "
                    "empty, child-graph and conditional nodes only; a "
                    "segment captured into one holds a "
                    f"{NODE_TYPES.get(bad, bad)} node")
            if body:
                held[0] += count
            if count:
                dep = api.child(graph, dep, raw)
            continue
        h = api.handle(graph)
        slot = taken + 8 * it.slot
        if isinstance(it, Branch):
            dep = api.set_cond(graph, dep, h, it.pred, it.negate, slot)
            dep, inner = api.conditional(graph, dep, h, IF)
            if emit(api, inner, it.body, taken, body=True,
                    held=held) is None:
                api.empty(inner, None)
        else:
            dep = api.set_cond(graph, dep, h, it.pred, False, slot)
            dep, inner = api.conditional(graph, dep, h, WHILE)
            last = emit(api, inner, it.body, taken, body=True, held=held)
            api.set_cond(inner, last, h, it.pred_next, False, slot)
    return dep


class DeviceGraph:
    """`items` built into one CUDA graph and instantiated; ``launch``
    replays it on a stream.  The graph holds copies of the segments' graphs,
    whose memory pool (and so every address they use) the caller keeps.
    Conditional bodies past MAX_BODY_NODES in all raise."""

    def __init__(self, items: List, taken, api=None):
        self.api = api or Api()
        self.graph = self.api.create()
        self.exec = None
        self._finalizer = self._destroyer(None)
        held = [0]
        emit(self.api, self.graph, items,
             taken.data_ptr() if taken is not None else 0, held=held)
        if held[0] > MAX_BODY_NODES:
            raise RuntimeError(
                f"the graph's conditional bodies hold {held[0]} nodes, past "
                f"the {MAX_BODY_NODES} whose replays were seen to run "
                "(cuda_graph.MAX_BODY_NODES)")
        self.exec = self.api.instantiate(self.graph)
        self._finalizer.detach()
        self._finalizer = self._destroyer(self.exec)

    def _destroyer(self, exec_):
        # at interpreter exit the process frees them: the runtime may be gone
        f = weakref.finalize(self, self.api.destroy, self.graph, exec_)
        f.atexit = False
        return f

    def launch(self, device) -> None:
        """Replay on `device`'s current stream."""
        self.api.launch(self.exec, cuda_lib.stream_of(device))
