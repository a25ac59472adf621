#!/usr/bin/env python3
"""Time the chunked ray sort (K5) on one CUDA card, beside variants of it.

    python3 sort_sweep.py [--batches 1,2,8] [--items 2,8]
                          [--block-keys 512,2048] [--other DIR]

Builds the port's kernels as committed, once per value of ``kPlaneBatch``
(``spt_tpu_torch/csrc/sort_chunks.cu``: the payload planes whose scattered
loads a thread issues together), of ``kItems`` (the keys a thread ranks a
pass) and of ``kBlockKeys`` (the keys a block owns below the cluster's cap
of 16 blocks), once with the scatter of each radix pass
into the owning block's buffer (distributed shared memory) turned into a
store to the block's own buffer ("local": a wrong order, timed only, for
what the remote stores cost), and, with ``--other``, the kernels under
``DIR/spt_tpu_torch/csrc`` (another commit's checkout, e.g. ``git archive``
of the parent unpacked in an ignored directory).  It records one sorted
frame's sort_chunks calls on the mesh scene (condensed), the instanced grid
and the baked grid (full width) (``chip_smoke.mesh_renderer`` /
``inst_renderer`` / ``stream_renderer``), adds random keys with half the
lanes dead at chunks 8192 and 32768 with 14 planes and with none, holds
every variant but "local" and the other checkout's to the plain version
bit for bit there (the other checkout's keys only: its sort need not be
stable), and times every variant in turns, forward then backward
(torch.profiler device time per launch), with torch.sort + gathers (CUDA
events) beside.  Needs ``nvcc`` and one card; prints the card's name and
power limit with every time.  The builds are made by ``sweep_builds.py``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,2,8")
    ap.add_argument("--items", default="2,8")
    ap.add_argument("--block-keys", default="512,2048")
    ap.add_argument("--other", default=None,
                    help="a checkout whose spt_tpu_torch/csrc to time beside")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    import sweep_builds
    from spt_tpu_torch.ops import cuda_lib, cuda_sort

    if not torch.cuda.is_available():
        print("sort_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    cs.log(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)} [{smi}]")
    builds = sweep_builds.Builds(cuda_lib, "sort_sweep", cs.log)
    use = builds.use
    builds.load("committed")
    checked = ["committed"]
    for const, tag, values in (("kPlaneBatch", "batch", args.batches),
                               ("kItems", "items", args.items),
                               ("kBlockKeys", "keys", args.block_keys)):
        for v in (int(x) for x in values.split(",") if x):
            builds.variant(f"{tag}{v}", [sweep_builds.const(const, v)])
            checked.append(f"{tag}{v}")
    # the local scatter leaves slots of garbage: its lane ids are kept in
    # the chunk, so that the gathers stay in bounds
    builds.variant("local", [
        sweep_builds.literal("cluster.map_shared_rank(dst, owner)[pos - owner * tile]",
                             "dst[pos - owner * tile]"),
        sweep_builds.literal("lanes[q] = static_cast<int>(x & 0xffffffffu);",
                             "lanes[q] = static_cast<int>(x & 0xffffffffu) & (chunk - 1);")])
    variants = checked + ["local"]
    if args.other:
        builds.load("other", Path(args.other) / "spt_tpu_torch" / "csrc")
        variants.append("other")

    # the recorded calls of one sorted frame on each scene, then random keys
    jobs = []
    use("committed")
    for label, mk in (("mesh", cs.mesh_renderer), ("instanced grid", cs.inst_renderer),
                      ("baked grid", cs.stream_renderer)):
        r = mk(dev)
        with cs.capture_calls([(cuda_sort, "sort_chunks")]) as calls:
            r.render_frames(1)
            torch.cuda.synchronize()
        jobs.append((label, [a for _, a, _ in calls]))
    g = torch.Generator().manual_seed(11)
    for chunk, n in ((8192, 196608), (32768, 65536)):
        key = torch.randint(0, 2 ** 32, (n,), generator=g, dtype=torch.int64)
        key[torch.rand(n, generator=g) < 0.5] = 0xFFFFFFFF
        ops = [torch.randn(n, generator=g) for _ in range(12)] + [
            torch.arange(n), torch.randint(0, 7, (n,), generator=g, dtype=torch.int32)]
        key, ops = key.to(dev), [a.to(dev) for a in ops]
        jobs.append((f"random keys, chunk {chunk}, 14 planes", [(key, ops, chunk)]))
        jobs.append((f"random keys, chunk {chunk}, no planes", [(key, [], chunk)]))

    for label, calls in jobs:
        # the other checkout's library has another kernel-info entry point:
        # its shapes are not queried
        cuda_sort._FITS.update((dev.index, a[2]) for a in calls)
        for v in checked + (["other"] if args.other else []):
            use(v)
            for key, ops, chunk in calls:
                sk, lane, out = cuda_sort.sort_chunks(key, ops, chunk)
                rk, rl, ro = cuda_sort.sort_chunks_reference(key, ops, chunk)
                ok = torch.equal(sk, rk) and (v == "other" or (
                    torch.equal(lane, rl)
                    and all(cs._same_bits(torch, a, b) for a, b in zip(out, ro))))
                if not ok:
                    cs.log(f"{label} {v}: NOT equal to the plain version")
                    return 1
        times = {v: [] for v in variants}
        for v in variants + variants[::-1]:
            use(v)
            times[v].append(cs.kernel_device_ms(
                torch, lambda: [cuda_sort.sort_chunks(*a) for a in calls],
                "sort_chunks_kernel", iters=10, launches_per_call=len(calls)))
        lib_ms = cs.time_call(
            torch, lambda: [cuda_sort.sort_chunks_reference(*a) for a in calls],
            warmup=2, iters=10) / len(calls)
        shapes = sorted({(a[0].shape[0], a[2], len(a[1])) for a in calls})
        cs.log(f"{label} ({len(calls)} calls; lanes, chunk, planes {shapes}) ms per "
               "launch, forward/backward: "
               + ", ".join(f"{v} {t[0]:.4f}/{t[1]:.4f}" for v, t in times.items())
               + f"; torch.sort + gathers {lib_ms:.4f} [{smi}]")
    cs.log("sort_sweep done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
