"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the port either: top-level module names are
compared whole, since the port's name begins with the JAX package's."""

import ast

import pytest

from portbench.tests.helpers import REPO

JAX = {"jax", "jaxlib", "flax", "spt_tpu"}
FILES = sorted((REPO / "portbench").rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_the_check_compares_whole_names():
    src = "import spt_tpu_torch\nfrom spt_tpu_torch.ops import rng\n"
    tree = REPO / "portbench" / "tests" / "_probe_names.txt"
    try:
        tree.write_text(src)
        assert top_level_imports(tree) == {"spt_tpu_torch"}
        assert not top_level_imports(tree) & JAX
    finally:
        tree.unlink()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted((REPO / "portbench" / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert not names & (JAX | {"spt_tpu_torch", "portbench"}), names
