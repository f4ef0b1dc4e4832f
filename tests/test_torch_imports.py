"""The torch port stands alone: it imports with JAX blocked, no source of the
port (nor chip_smoke.py) imports JAX or the JAX package, and every source
reaches a checkout."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "open_knowledge_graph_embeddings_tpu_torch"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import open_knowledge_graph_embeddings_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "assert p.__name__ + '.ops.lstm_scan_kernel' in names, names\n"
        "for m in ('preprocessing.jobs', 'preprocessing.avro', 'preprocessing.corpus', 'cli.create_data',\n"
        "          'native.loader', 'parallel.distributed', 'parallel.mesh', 'parallel.sharding'):\n"
        "    assert p.__name__ + '.' + m in names, names\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'open_knowledge_graph_embeddings_tpu'\n"
        "       or m.startswith('open_knowledge_graph_embeddings_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for sub in ("native", "parallel"):  # the host helpers and the processes' packages are checked too
        assert any(f.parent.name == sub for f in files), sub
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "open_knowledge_graph_embeddings_tpu"), (f, mod)


def test_port_sources_are_not_git_ignored():
    """Every source of the port reaches a checkout: no .gitignore pattern
    (such as the dataset directories' ``data/``) swallows one."""
    if not (ROOT / ".git").exists():
        pytest.skip("not a git work tree")
    files = [
        str(f.relative_to(ROOT)) for f in sorted(PORT.rglob("*"))
        if f.is_file() and not {"_build", "__pycache__"} & set(f.parts)
    ] + ["chip_smoke.py"]
    res = subprocess.run(
        ["git", "check-ignore", "--no-index", *files], cwd=ROOT, capture_output=True, text=True, timeout=60
    )
    assert res.returncode == 1 and not res.stdout, f"git-ignored port sources:\n{res.stdout}{res.stderr}"
