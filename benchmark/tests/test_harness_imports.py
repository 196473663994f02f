"""What the benchmark may import: no JAX and nothing of the JAX package
anywhere under benchmark/, and nothing of the program in the yardstick
(the reference, the generator, the check, the kernels' counts and the
metrics' readers). Top-level names are compared whole: ``aloam_tpu_torch``
begins with ``aloam_tpu``."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
YARDSTICK = ["reference", "render.py", "check.py", "roofline.py", "kernels",
             "metrics"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module.split(".")[0])
    return out


def _files(*parts):
    for part in parts:
        p = HERE / part
        yield from ([p] if p.is_file() else sorted(p.rglob("*.py")))


@pytest.mark.parametrize("path", list(_files(".")), ids=str)
def test_no_jax_anywhere(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "aloam_tpu"}


@pytest.mark.parametrize("path", list(_files(*YARDSTICK)), ids=str)
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "aloam_tpu_torch" not in _imports(path)


def test_the_runtime_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "aloam_tpu_torch_x", sys)
    assert "aloam_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "aloam_tpu.config", sys)
    assert run.forbidden_modules() == ["aloam_tpu"]
