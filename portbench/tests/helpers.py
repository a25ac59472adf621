"""A copy of the benchmark at a tiny size, for the CPU tests."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _edit(path: Path, **kw) -> None:
    data = json.loads(path.read_text())
    data.update(kw)
    path.write_text(json.dumps(data))


def tiny_root(tmp: Path, workload: str, width: int, height: int,
              frames: int, pixels: int = 64, jobs: int = 2) -> Path:
    """A copy of BENCHMARK.json and portbench/ under `tmp` whose cell
    `workload` renders `width` x `height`, jobs of `frames` frames, and
    checks `pixels` pixels of at most `jobs` jobs."""
    root = Path(tmp) / "bench"
    root.mkdir(parents=True)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfile = root / conf["file"]
    data = json.loads(cfile.read_text())
    data["render"].update(width=width, height=height)
    cfile.write_text(json.dumps(data))
    traffic = json.loads(
        (root / "portbench/traffic" / f"{cell['traffic']}.json").read_text())
    _edit(root / "portbench/traffic" / f"{cell['traffic']}.json",
          job_frames=min(frames, traffic["job_frames"]),
          chain_frames=min(max(frames // 2, 1), traffic["chain_frames"]),
          warmup_jobs=1, profile_jobs=1)
    check = root / "portbench/checks" / f"{workload}.json"
    _edit(check, pixels=pixels,
          jobs=min(jobs, json.loads(check.read_text())["jobs"]))
    return root
