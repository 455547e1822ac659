"""Import hygiene of the port: no module of ``ray_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``ray_tpu``.
``ray_tpu_torch`` shares the prefix, so module names are matched exactly
(``ray_tpu`` or ``ray_tpu.<sub>``), never by prefix."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "ray_tpu")


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
            for alias in node.names:
                yield node.lineno, f"{node.module}.{alias.name}"


def test_matcher_tells_the_port_from_the_jax_package():
    assert _banned("ray_tpu") and _banned("ray_tpu.ops.norms")
    assert _banned("jax") and _banned("jax.numpy")
    assert not _banned("ray_tpu_torch") and not _banned("ray_tpu_torch.ops")
    assert not _banned("jaxtyping")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imported_modules(tree)
           if _banned(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
