"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "better_fastlio2_tpu"}
PROGRAM = "better_fastlio2_tpu_torch"


def _imports(path: Path):
    """(top-level name, level) of every import in a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 15
    for f in files:
        for top, level in _imports(f):
            # whole top-level names: the port's name begins with the JAX
            # package's and is allowed outside the reference
            assert level or top not in FORBIDDEN, f"{f}: imports {top}"


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "dataclasses", "math", "numpy", "torch"}
    files = sorted((BENCH / "ref").rglob("*.py"))
    assert len(files) >= 4
    for f in files:
        for top, level in _imports(f):
            assert level or top in allowed, f"{f}: imports {top}"
            assert top != PROGRAM


def test_the_check_tells_the_names_apart():
    import sys
    from lio_bench import harness as H
    present = {m.split(".")[0] for m in sys.modules}
    assert PROGRAM not in FORBIDDEN
    assert set(H.forbidden_modules()) == present & FORBIDDEN
