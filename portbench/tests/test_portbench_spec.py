"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
resolves to its files; a cell added as files is found without an edit.

    python -m pytest portbench/tests
"""

import json
import re
import shutil

import pytest

from portbench.spec import Spec
from portbench.tests.helpers import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")


@pytest.mark.parametrize("key", sorted(KEYS))
def test_entries_keep_to_the_contract(key):
    entries = BENCH[key]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) <= KEYS[key], set(e) - KEYS[key]
        assert NAME.match(e["name"]), e["name"]
        if key in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        if key == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0 < e["bound"] <= 0.25
        if key == "per_layer":
            assert _line(e["layer"])
            assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        if key == "workloads":
            assert e["chips"] in (1, 4) and _line(e["why"])
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        if key == "configs":
            assert _line(e["why"]) and _line(e["source"])
            assert all(NAME.match(k) for k in e["reduced"])


def test_every_name_resolves_to_its_files():
    spec = Spec(REPO)
    pairs = set()
    for cell in BENCH["workloads"]:
        pairs.add((cell["config"], cell["traffic"]))
        assert spec.config(cell["config"])["render"]
        assert spec.traffic(cell["traffic"])["job_frames"] >= 1
        limits = spec.check(cell["name"])["limits"]
        assert set(limits) == {"image_mean_abs", "pixels_off_share",
                               "radiance_rel_gap"}
        reported = spec.metrics(cell["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert spec.metrics(cell["name"], "per_layer")
    assert len(pairs) == len(BENCH["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
    used = {c["config"] for c in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]


def test_four_card_cells_are_at_most_a_quarter_or_one():
    four = sum(c["chips"] == 4 for c in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_a_cell_added_as_files_is_found(tmp_path):
    root = tmp_path / "bench"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / "portbench/configs/default.json").read_text())
    conf["name"] = "default-small"
    conf["render"].update(width=64, height=32)
    (root / "portbench/configs/default-small.json").write_text(
        json.dumps(conf))
    traffic = json.loads(
        (REPO / "portbench/traffic/offline_jobs.json").read_text())
    traffic["job_frames"] = 16
    (root / "portbench/traffic/short_jobs.json").write_text(
        json.dumps(traffic))
    (root / "portbench/checks/small-offline.json").write_text(
        (REPO / "portbench/checks/default-1080p-offline.json").read_text())
    (root / "portbench/metrics/jobs_done.py").write_text(
        "def read(run):\n    return len(run.jobs)\n")
    bench["configs"].append({"name": "default-small", "source": "a test",
                             "file": "portbench/configs/default-small.json",
                             "reduced": ["render"], "why": "a test"})
    bench["workloads"].append({"name": "small-offline",
                               "config": "default-small",
                               "traffic": "short_jobs", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "setup_s",
                               "workloads": ["small-offline"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root)
    assert spec.config("default-small")["render"]["width"] == 64
    assert spec.traffic("short_jobs")["job_frames"] == 16
    names = {m["name"] for m in spec.metrics("small-offline", "per_layer")}
    assert {"jobs_done", "scene_build_s", "capture_s"} <= names
    assert "frame_roofline_pct" not in names
    assert spec.reader("jobs_done").read(type("R", (), {"jobs": [1, 2]})) == 2
