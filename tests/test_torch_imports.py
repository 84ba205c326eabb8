"""The port stands alone: no file of ``recmodels_tpu_torch/``, not
``chip_smoke.py`` and not ``graft_entry_torch.py`` imports JAX or anything of the JAX package. A static scan:
a runtime ``sys.modules`` check cannot work in a process where JAX is already
imported (the test lane imports it)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "recmodels_tpu_torch").rglob("*.py")
) + ["chip_smoke.py", "graft_entry_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "flax", "recmodels_tpu")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "."  # relative imports stay inside the port
            else:
                yield node.module


def test_port_has_files():
    assert "recmodels_tpu_torch/serve.py" in FILES and len(FILES) > 15


@pytest.mark.parametrize("path", FILES)
def test_no_jax_import(path):
    tree = ast.parse((ROOT / path).read_text(), path)
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"
