"""What the benchmark may import: nothing of JAX or the JAX package anywhere
under portbench/, and nothing of the program in the reference. Each
import's top-level module name is compared whole, since the program's name
begins with the JAX package's."""

import ast
import os

import pytest

from _portbench_common import ROOT

BENCH = os.path.join(ROOT, "portbench")
JAX = {"jax", "jaxlib", "flax", "unav_yolyolva_tpu"}
PROGRAM = "unav_yolyolva_tpu_torch"


def _files(top):
    for d, _, names in os.walk(top):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(d, n)


def top_level_imports(path):
    """Top-level names of every absolute import in a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", list(_files(BENCH)), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", list(_files(os.path.join(BENCH, "reference"))),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_stands_alone(path):
    assert PROGRAM not in top_level_imports(path)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    relative = [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level > 1]
    assert not relative, "the reference imports only within portbench/reference"


def test_the_check_compares_whole_names():
    """The program's name starts with the JAX package's; it is not JAX."""
    assert PROGRAM.split(".")[0] not in JAX
    assert "unav_yolyolva_tpu.models".split(".")[0] in JAX
