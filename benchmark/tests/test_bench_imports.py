"""Nothing under ``benchmark/`` imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX package's),
and the yardstick and the reference import nothing of the port."""

import ast
import subprocess
import sys

import pytest

import bench_tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "open_knowledge_graph_embeddings_tpu"}
PORT = "open_knowledge_graph_embeddings_tpu_torch"
#: the yardstick and the plain reference: no module of the program
YARDSTICK = ["compare.py", "host.py", "labels.py", "params.py", "reference.py", "synth.py", "trace.py", "work.py"]


def imported_top_levels(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(bench_tiny.BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(name):
    assert PORT not in imported_top_levels(bench_tiny.BENCH / "okbench" / name)


def test_reference_loads_no_port_module():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import okbench.reference, okbench.labels, okbench.work; "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & set({sorted(FORBIDDEN | {PORT})!r})))")
    out = subprocess.run([sys.executable, "-c", code, str(bench_tiny.BENCH)], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from okbench import cli

    monkeypatch.setitem(sys.modules, PORT, sys.modules[__name__])
    assert cli.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules[__name__])
    assert cli.forbidden_modules() == ["jax"]
