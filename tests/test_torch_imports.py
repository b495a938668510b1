"""Import guard: the port and ``chip_smoke.py`` import neither ``jax``,
``ml_dtypes`` nor anything of the JAX package ``repro`` — the card's
machine has none of them."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_banned_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_guard_sees_the_whole_port():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").exists()


def test_the_port_sets_no_xla_flags():
    """The reference's dry-run sets ``XLA_FLAGS`` at import (512 host
    devices); the port's runs on a fake process group and names no XLA
    setting anywhere."""
    assert not [p.name for p in FILES if "XLA_FLAGS" in p.read_text()]
