"""No run loads JAX or the JAX package; the reference, and every
architecture module, imports nothing of the program."""
import ast
import json
import subprocess
import sys

import pytest

from bench import harness

BENCH = harness.ROOT / "bench"


def test_top_level_names_compared_whole():
    mods = {"repro_torch": 1, "repro_torch.models": 1, "reproducible": 1,
            "jaxtyping": 1, "numpy": 1}
    assert harness.jax_modules(mods) == []
    mods.update({"repro": 1, "repro.models.moe": 1, "jax.numpy": 1,
                 "jaxlib": 1, "flax.linen": 1})
    assert harness.jax_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                         "repro", "repro.models.moe"]


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(imports(path)) & (set(harness.JAX_NAMES) |
                                          {"benchmarks"}), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(imports(path))
        assert "repro_torch" not in names and "bench" not in names, path


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        (BENCH / "archs").glob("*.py")))
def test_architecture_module_loads_no_jax_and_nothing_of_the_program(name):
    code = ("import json, sys\n"
            "sys.path[:0] = [sys.argv[1]]\n"
            "from bench import harness\n"
            "harness.arch(sys.argv[2])\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
            " in harness.JAX_NAMES + ('repro_torch',))))")
    p = subprocess.run([sys.executable, "-c", code, str(harness.ROOT), name],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
