"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from portbench.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path
    code = ("import sys; import portbench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=HERE.parent, check=True).stdout.strip()
    assert out == "[]"


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    monkeypatch.setitem(sys.modules, "jaxish.sub", sys)
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "repro.mapreduce", sys)
    assert harness.foreign_modules() == ["repro"]


def test_the_command_refuses_a_machine_without_the_cards():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    run = subprocess.run([sys.executable, "portbench/run.py", "--workload", "wc-fixed",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=HERE.parent)
    assert run.returncode != 0 and run.stdout == ""
    assert "needs 1 CUDA device" in run.stderr
