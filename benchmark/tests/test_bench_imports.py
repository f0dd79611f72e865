"""No module of the benchmark imports JAX or the JAX package, or reads the
JAX-era measurement scripts. Top-level names are compared whole: the
port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "simplenerf_tpu", "bench", "bench_scaling", "chip_smoke", "tools"}


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_forbidden_import(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if p.name != Path(__file__).name],
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_reads_no_jax_era_script(path):  # this file names them to look for them
    text = path.read_text()
    for name in ("bench.py", "chip_smoke", "tools/", "simplenerf_tpu"):
        if name == "simplenerf_tpu":
            assert "import simplenerf_tpu" not in text and "from simplenerf_tpu" not in text
        else:
            assert f'"{name}' not in text and f"'{name}" not in text, name


def test_reference_takes_nothing_from_the_program():
    text = (harness.HERE / "reference.py").read_text()
    assert "simplenerf_torch" not in imported_tops(harness.HERE / "reference.py")
    assert "import simplenerf_torch" not in text and "from simplenerf_torch" not in text


def test_port_name_is_not_mistaken_for_the_jax_package():
    assert "simplenerf_torch".split(".")[0] not in harness.FORBIDDEN
    assert "simplenerf_tpu.fields".split(".")[0] in harness.FORBIDDEN
