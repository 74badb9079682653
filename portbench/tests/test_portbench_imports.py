"""No file of the benchmark imports JAX or the JAX package, compared by
the whole top-level name (the program's name begins with the JAX
package's), and the plain reference imports nothing of the program."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "deformablelka_tpu"}


def _imported(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not _imported(path) & FORBIDDEN, path


def test_the_program_is_imported_by_its_whole_name():
    assert "deformablelka_tpu_torch" in _imported(ROOT / "configs" / "dlka_former_synapse.py")


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "reference").rglob("*.py")):
        assert "deformablelka_tpu_torch" not in _imported(path), path


def test_the_forbidden_names_are_the_harness_guard():
    from portbench import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
