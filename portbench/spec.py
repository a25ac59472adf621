"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` of its entry under ``configs``;
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a cell's comparison (what is compared, and each number's limit):
  ``portbench/checks/<workload>.json``;
- a metric's reader: ``portbench/metrics/<metric>.py``, a module with a
  function ``read(run)`` that returns the metric's value from the run's
  record (``portbench.record.RunRecord``), or None when it finds nothing to
  read.

A cell, configuration, mix or metric is added by adding its files and its
entry in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HARNESS = "portbench"


class Spec:
    def __init__(self, root):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.bench[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        with open(self.root / self._entry("configs", name)["file"]) as f:
            return json.load(f)

    def _data(self, folder: str, name: str) -> dict:
        with open(self.root / HARNESS / folder / f"{name}.json") as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return self._data("traffic", name)

    def check(self, workload: str) -> dict:
        return self._data("checks", workload)

    def metrics(self, workload: str, kind: str) -> list:
        """The entries of `kind` ("end_to_end" or "per_layer") that the cell
        reports: those that list it under ``workloads`` and those without
        the key, whose end-to-end metric the cell reports (or, for an
        end-to-end metric without the key, every cell)."""
        e2e = {m["name"] for m in self.bench["end_to_end"]
               if workload in m.get("workloads", [workload])}
        out = []
        for m in self.bench[kind]:
            if "workloads" in m:
                if workload in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def reader(self, metric: str):
        path = self.root / HARNESS / "metrics" / f"{metric}.py"
        mod_name = "portbench_metric_" + metric.replace(".", "_").replace(
            "-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
