#!/usr/bin/env python3
"""Sweep the cluster walk's staging threshold on one CUDA card.

    python3 walk_sweep.py [--thresholds 16,24,32,33] [--other DIR]

Builds the port's kernels once per value of ``kStageMin``
(``spt_tpu_torch/csrc/spt_tracers.cuh``: the lanes that must open one
cluster before the warp stages it in shared memory; 33 never stages) and,
with ``--other``, the kernels under ``DIR/spt_tpu_torch/csrc`` (another
commit's checkout, e.g. ``git archive`` of the parent unpacked in an
ignored directory).  It records one sorted frame's fused_bounce /
fused_frame calls and one regen frame's standalone tracer calls of the
baked grid and the instanced grid (``chip_smoke.stream_renderer`` /
``inst_renderer``), checks every variant's results bit for bit against the
committed build's there and on the textured mesh scene of chip_smoke's
phase 10, and times every variant in turns, forward then backward
(torch.profiler device time per launch).  Needs ``nvcc`` and one
card; prints the card's name and power limit with every time.  The builds
are made by ``sweep_builds.py``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--thresholds", default="16,24,32,33")
    ap.add_argument("--other", default=None,
                    help="a checkout whose spt_tpu_torch/csrc to time beside")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    import sweep_builds
    from spt_tpu_torch.ops import cuda_bounce, cuda_lib, cuda_trace

    if not torch.cuda.is_available():
        print("walk_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    cs.log(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)} [{smi}]")
    builds = sweep_builds.Builds(cuda_lib, "walk_sweep", cs.log)
    use = builds.use
    builds.load("committed")
    variants = []
    for t in (int(x) for x in args.thresholds.split(",")):
        builds.variant(f"T{t}", [sweep_builds.const("kStageMin", t)])
        variants.append(f"T{t}")
    if args.other:
        builds.load("other", Path(args.other) / "spt_tpu_torch" / "csrc")
        variants.append("other")

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for y in x if y is not None for t in flat(y)]

    # the textured resident form, from bounce 0 on the mesh scene with
    # phase 10's checker texture
    import numpy as np

    from spt_tpu_torch import scene as tscene
    from spt_tpu_torch.integrators import transport
    from spt_tpu_torch.lights import default_lights

    desc, mcfg, mcam = cs.port_mesh_scene()
    base, mr = cs._checker_texture(np, np.random.default_rng(0))
    desc.materials[0] = tscene.Material([1.0, 1.0, 1.0], roughness=1.0, metallic=1.0,
                                        base_color_texture=base,
                                        metallic_roughness_texture=mr)
    margs = (mcfg, tscene.flatten_scene(desc, dev), default_lights(dev),
             transport.gen_primary(mcfg, mcam.rays(dev), 0))
    for what, fn, fargs in (
            ("fused_bounce", cuda_bounce.fused_bounce, margs + (0, False)),
            ("fused_frame", cuda_bounce.fused_frame, margs)):
        ref = flat(fn(*fargs))
        for v in variants:
            use(v)
            if not all(torch.equal(x, y) for x, y in zip(flat(fn(*fargs)), ref)):
                cs.log(f"textured resident {what} {v}: NOT bit-equal to the committed build")
            use("committed")
        cs.log(f"textured resident {what} from bounce 0: every variant checked [{smi}]")

    for label, mk, mode, fns in (
            ("stream", cs.stream_renderer, 3, ("stream_closest_hit", "stream_any_hit")),
            ("instanced", cs.inst_renderer, 2, ("inst_closest_hit", "inst_any_hit"))):
        use("committed")
        r = mk(dev)
        with cs.capture_calls([(cuda_bounce, "fused_bounce"),
                               (cuda_bounce, "fused_frame")]) as calls:
            r.render_frames(1)
            torch.cuda.synchronize()
        r = mk(dev, integrator="regen")
        with cs.capture_calls([(cuda_trace, f) for f in fns]) as tcalls:
            r.render_frames(1)
            torch.cuda.synchronize()
        jobs = [("fused_bounce", f"fused_bounce_kernel<{mode}>", cuda_bounce.fused_bounce,
                 [(a, k) for n, a, k in calls if n == "fused_bounce"]),
                ("fused_frame", f"fused_frame_kernel<{mode}>", cuda_bounce.fused_frame,
                 [(a, k) for n, a, k in calls if n == "fused_frame"])]
        for f in fns:
            kind = "true" if f.endswith("any_hit") else "false"
            jobs.append((f, f"{f.split('_')[0]}_trace_kernel<{kind}>",
                         getattr(cuda_trace, f),
                         [(a, k) for n, a, k in tcalls if n == f]))
        for what, kname, fn, mine in jobs:
            use("committed")
            ref = [flat(fn(*a, **k)) for a, k in mine]
            for v in variants:
                use(v)
                got = [flat(fn(*a, **k)) for a, k in mine]
                same = all(torch.equal(x, y) for g, w in zip(got, ref)
                           for x, y in zip(g, w))
                if not same:
                    cs.log(f"{label} {what} {v}: NOT bit-equal to the committed build")
            times = {v: [] for v in variants}
            for v in variants + variants[::-1]:
                use(v)
                times[v].append(cs.kernel_device_ms(
                    torch, lambda: [fn(*a, **k) for a, k in mine], kname, iters=5,
                    launches_per_call=len(mine)))
            cs.log(f"{label} {what} ({len(mine)} calls) ms per launch, forward/backward: "
                   + ", ".join(f"{v} {t[0]:.4f}/{t[1]:.4f}" for v, t in times.items())
                   + f" [{smi}]")
    cs.log("walk_sweep done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
