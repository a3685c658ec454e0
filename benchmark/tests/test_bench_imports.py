"""No file of the benchmark imports JAX or the JAX package (top-level
module names compared whole: accflow_tpu_torch begins with accflow_tpu),
and the reference imports nothing of the measured program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "accflow_tpu"}


def imported(path: Path) -> set:
    """Top-level names of every module the file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "accflow_tpu_torch" not in imported(path)


def test_the_check_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import accflow_tpu_torch.models\nfrom accflow_tpu.ops import corr\n"
                     "import jaxlib\n")
    assert imported(probe) & FORBIDDEN == {"accflow_tpu", "jaxlib"}
