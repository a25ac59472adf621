"""Builds of the port's kernels for the sweep scripts (``walk_sweep.py``,
``sort_sweep.py``, ``frame_sweep.py``): the committed sources, variants of
them with some lines rewritten, and another checkout's kernels.

A build is one library of every kernel, built by ``cuda_lib.build`` into
``build/<script>/<name>/`` and made current with ``use``.  A variant copies
``spt_tpu_torch/csrc`` and rewrites it: each (regex, replacement) pair must
match exactly once in all of its files, so a misspelt or a duplicated
constant stops the sweep instead of timing the committed code twice.
"""

from __future__ import annotations

import importlib.util
import re
import shutil
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "spt_tpu_torch" / "csrc"


def const(name: str, value) -> tuple:
    """The (regex, replacement) pair that sets ``constexpr int name``."""
    return rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};"


def literal(old: str, new: str) -> tuple:
    """The (regex, replacement) pair that replaces the text `old`."""
    return re.escape(old), new.replace("\\", "\\\\")


def parse_consts(spec: str) -> list:
    """``NAME:kConst=V[+kConst=V]/...`` -> [(NAME, [pair, ...]), ...]."""
    out = []
    for item in filter(None, spec.split("/")):
        name, subs = item.split(":")
        out.append((name, [const(*s.split("=")) for s in subs.split("+")]))
    return out


def other_wrappers(root: Path, names=("cuda_lib",)) -> dict:
    """Another checkout's ``spt_tpu_torch/ops`` modules `names` (cuda_lib
    first), each loaded as a module of its own whose ``cuda_lib`` is that
    checkout's; every other module they import is this checkout's."""
    mods = {}
    for name in names:
        spec = importlib.util.spec_from_file_location(
            f"other_{name}", Path(root) / "spt_tpu_torch" / "ops" / f"{name}.py")
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        if name != "cuda_lib":
            m.cuda_lib = mods["cuda_lib"]
        mods[name] = m
    return mods


class Builds:
    """Named libraries of this checkout's ``cuda_lib``, built under
    ``build/<tag>/``; `log` prints a line."""

    def __init__(self, cuda_lib, tag: str, log):
        self.cuda_lib = cuda_lib
        self.root = HERE / "build" / tag
        self.log = log
        self.libs = {}

    def load(self, name: str, csrc: Path = SRC, note=None):
        """Builds the sources under `csrc` as `name`; `note(cuda_lib)`
        adds to the log line."""
        cl = self.cuda_lib
        cl._LIB = None
        cl.CSRC = Path(csrc)
        cl.BUILD_ROOT = self.root / name
        t0 = time.perf_counter()
        self.libs[name] = cl.build()
        extra = f"; {note(cl)}" if note else ""
        self.log(f"built {name} in {time.perf_counter() - t0:.1f} s{extra}")
        return self.libs[name]

    def variant(self, name: str, subs, note=None):
        """Builds a copy of the committed sources with each (regex,
        replacement) of `subs` applied where it matches, once in all."""
        d = self.root / f"src_{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(SRC, d)
        files = sorted(d.iterdir())
        for pattern, repl in subs:
            hits = 0
            for p in files:
                txt, n = re.subn(pattern, repl, p.read_text())
                if n:
                    p.write_text(txt)
                    hits += n
            if hits != 1:
                raise RuntimeError(f"{pattern!r} matches {hits} times in {SRC}, "
                                   "not once")
        return self.load(name, d, note)

    def load_other(self, root: Path, names=("cuda_lib",), note=None) -> dict:
        """Another checkout's wrappers (``other_wrappers``), its kernels
        built by its own ``cuda_lib`` (whose C interface may differ from
        this one's) into its own build directory."""
        mods = other_wrappers(root, names)
        t0 = time.perf_counter()
        mods["cuda_lib"].build()
        extra = f"; {note(mods['cuda_lib'])}" if note else ""
        self.log(f"built other in {time.perf_counter() - t0:.1f} s{extra}")
        return mods

    def use(self, name: str):
        self.cuda_lib._LIB = self.libs[name]
