"""Readings of the numbers that decide ``correct``: the program's over many
seeds and the control's (the reference in bfloat16 shading, put in the
program's place) over a few, at the cell's own size, in one process.

    python3 -m portbench.readings --workload NAME [--seeds 12]
        [--control-seeds 3] [--seconds 1] [--first-seed N]

Each seed sets the RNG epoch and draws the pixels and jobs as a run does;
the window is a short one of whole jobs at the cell's own load.  Prints a
JSON line a seed with the program's numbers and, for the first
``--control-seeds`` seeds, the control's; then the largest of each.  The
limits in ``portbench/checks/<workload>.json`` are set from these
readings (PERF.md gives them).  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.run import ROOT, Client, reference_values, window


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first-seed", type=int, default=2_147_000_000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from portbench import check
    from portbench.spec import Spec

    spec = Spec(ROOT)
    client = Client(spec, args.workload, args.device)
    cs = spec.check(args.workload)
    worst = {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        client.start(seed)
        for _ in range(int(client.traffic.get("warmup_jobs", 1))):
            client.job()
        jobs, kept, radiance, _ = window(client, args.seconds)
        chosen = check.choose_jobs(seed, len(jobs), int(cs["jobs"]))
        picked = [jobs[j] for j in chosen]
        want, want_rad = reference_values(client.data, client.render, picked,
                                          client.keep, args.device)
        got = [kept[j] for j in chosen]
        got_rad = [radiance[j] for j in chosen]
        off = float(cs["off_threshold"])
        row = {"seed": seed, "jobs": len(jobs),
               "program": check.numbers(got, want, off, got_rad, want_rad)}
        if i < args.control_seeds:
            ctl, ctl_rad = reference_values(client.data, client.render,
                                            picked, client.keep, args.device,
                                            shade_dtype=torch.bfloat16)
            row["control"] = check.numbers(ctl, want, off, ctl_rad, want_rad)
        for side in ("program", "control"):
            for k, v in row.get(side, {}).items():
                key = f"{side}.{k}"
                pick = max if side == "program" else min
                worst[key] = pick(worst.get(key, v), v)
        print(json.dumps(row), flush=True)
    print(json.dumps({"largest_program_smallest_control": worst}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
