"""Deterministic stream compaction and lane sorting.

The counterpart of ``spt_tpu.ops.compaction``: the reference's wavefront
queues are atomicAdd ticket counters into index buffers
(device_programs.cu:268-273, 538-541, 752-755), non-deterministic in their
order.  Here an exclusive cumsum gives each live lane its output slot and a
scatter builds the queue, so the order is the lanes' own.

The queue is always N lanes long with a live count; its padding points at
lane 0.  Where the JAX package scatters to index N with ``mode="drop"``
and relies on an out-of-range gather clamping to N - 1, the port masks the
scatter and clamps the gather explicitly: torch raises on an index out of
range.  Both stay free of host syncs: a dead or padding lane writes to one
scratch slot past the end, which is then cut off.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compact_indices(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of live lanes, packed to the front.

    Returns (queue (N,) int64, count () int64): queue[:count] are the
    indices where `mask` is True in ascending order; queue[count:] are 0."""
    n = mask.shape[0]
    mask_i = mask.to(torch.int64)
    slots = torch.cumsum(mask_i, 0) - mask_i      # exclusive scan
    count = mask_i.sum()
    # dead lanes target the scratch slot n (the JAX package's mode="drop")
    target = torch.where(mask, slots, n)
    queue = torch.zeros(n + 1, dtype=torch.int64, device=mask.device)
    queue.scatter_(0, target, torch.arange(n, device=mask.device))
    return queue[:n], count


def compact_gather(tree, queue: torch.Tensor):
    """Gather a PathState-like tuple of (N,) / (N, k) tensors into queue
    order.  Queue entries past the last lane (padding that points at lane
    N) read lane N - 1, as JAX's clamped gather does."""
    def take(leaf):
        return leaf[torch.clamp(queue, max=leaf.shape[0] - 1)]

    return _map(take, tree)


def scatter_back(tree_compacted, queue: torch.Tensor, tree_original,
                 mask_count):
    """Inverse of compact_gather: write the first `mask_count` compacted
    lanes back to their home slots, leaving the other lanes untouched.
    Padding slots (>= count) write nothing, so they never clobber lane 0."""
    n = _lanes(tree_original)
    valid = torch.arange(queue.shape[0], device=queue.device) < mask_count
    target = torch.where(valid, queue, n)

    def put(dst, src):
        out = torch.cat([dst, dst[:1]])     # slot n is scratch
        out[target] = src
        return out[:n]

    return _map(put, tree_original, tree_compacted)


def sort_by_key(key: torch.Tensor, *arrays):
    """Stable ascending sort of lane arrays by an int key.  Returns
    (order, *arrays in that order)."""
    order = torch.sort(key, stable=True).indices
    return (order,) + tuple(a[order] for a in arrays)


def live_count(mask: torch.Tensor) -> torch.Tensor:
    """Number of live lanes, as a device tensor."""
    return mask.to(torch.int64).sum()


def _lanes(tree) -> int:
    """Lanes of the first tensor in a tuple/dict tree."""
    if isinstance(tree, torch.Tensor):
        return tree.shape[0]
    first = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return _lanes(first)


def _map(fn, tree, *rest):
    """Apply `fn` leafwise over tensors nested in tuples (NamedTuples keep
    their type) and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree
