"""No run loads JAX or the JAX package; the reference imports nothing of
the program."""
import ast

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
