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


#: the port's tests that import the JAX package
REF_TESTS = [p for p in sorted((ROOT / "tests").glob("test_torch_*.py"))
             if "repro" in {m.split(".")[0] for m in _imports(p) if m}]


@pytest.mark.parametrize("path", REF_TESTS, ids=lambda p: p.name)
def test_tests_that_import_the_reference_reset_its_globals(path):
    """A port test that imports the JAX package takes the autouse fixture
    of ``tests/torch_defaults.py``: both packages' launch code leaves
    module globals set (the reference's dry-run: moe's dispatch on
    ``"sort"``), and xdist runs files in any order on a worker."""
    tree = ast.parse(path.read_text(), str(path))
    assert any(isinstance(n, ast.ImportFrom) and n.module == "torch_defaults"
               and "package_defaults" in {a.name for a in n.names}
               for n in tree.body), \
        f"{path.name} imports repro without torch_defaults' fixture"


def test_the_fixture_check_sees_the_reference_tests():
    assert len(REF_TESTS) > 20
