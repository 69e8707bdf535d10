"""No module under perfbench/ imports jax, flax or the JAX package
``repro`` (compared by whole top-level names: ``repro_torch`` is the
program), the references import nothing of the program, and a CPU
rehearsal leaves none of them in ``sys.modules``."""
import ast
import json
import subprocess
import sys

import pytest

from perfbench import load

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(load.HERE.rglob("*.py"))


def _top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(load.HERE)))
def test_no_forbidden_import(path):
    assert not set(_top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((load.HERE / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not set(_top_names(path)) & (FORBIDDEN | {"repro_torch",
                                                     "perfbench"})


def test_rehearsal_leaves_no_forbidden_module(tmp_path):
    code = f"""
import json, sys
sys.path[:0] = [{str(load.ROOT)!r}, {str(load.ROOT / 'src')!r}]
from perfbench import run
from perfbench.tests.conftest import SMALL_TRAFFIC, TINY
run.main(["--workload", "mamba2-2.7b.docs", "--seed", "7", "--seconds",
          "0.2", "--out", {str(tmp_path)!r}], device="cpu",
         shrink=dict(TINY["mamba2-2.7b"], dtype="float32"),
         wl_patch=SMALL_TRAFFIC)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    held = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in held and not held & FORBIDDEN
