"""Import hygiene of the port: no module of ``dilabhelmholtzoct_tpu_torch``
and not ``chip_smoke.py`` imports JAX or the JAX package, and none imports
``triton`` at module level (the CPU hosts that run the tests have none)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "dilabhelmholtzoct_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dilabhelmholtzoct_tpu")


def _imports(tree):
    """(module name, at module level) for every absolute import."""
    out = []

    def visit(node, top):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                out.extend((a.name, top) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module, top))
            visit(child, top and not isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                        ast.Lambda)))

    visit(tree, True)
    return out


def _forbidden(name):
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "dilabhelmholtzoct_tpu_torch/ops/attention.py" in names
    assert "dilabhelmholtzoct_tpu_torch/inference/engine.py" in names


def test_scanner_flags_what_it_should():
    src = ("import jax.numpy as jnp\nfrom dilabhelmholtzoct_tpu.ops import x\n"
           "from dilabhelmholtzoct_tpu_torch.ops import y\nimport triton\n"
           "def f():\n    import triton\n")
    got = _imports(ast.parse(src))
    assert [n for n, _ in got if _forbidden(n)] == [
        "jax.numpy", "dilabhelmholtzoct_tpu.ops"]
    assert ("triton", True) in got and ("triton", False) in got


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_and_no_module_level_triton(path):
    for name, top in _imports(ast.parse(path.read_text(), str(path))):
        assert not _forbidden(name), f"{path.name} imports {name}"
        assert not (top and name.split(".")[0] == "triton"), (
            f"{path.name} imports triton at module level")
