"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either; top-level module names
are compared whole (`cosnarks_tpu_torch` is not `cosnarks_tpu`). A run
refuses a process that holds them, and a machine without a card."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NEVER = {"jax", "jaxlib", "cosnarks_tpu"}


def _imports(path: Path):
    """(top-level name, level) of every import statement in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def _files():
    return sorted(p for p in HERE.rglob("*.py")
                  if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imports(path):
    bad = {name for name, level in _imports(path)
           if level == 0 and name in NEVER}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name, level in _imports(path):
        assert level <= 1, f"{path}: a relative import leaves the reference"
        if level == 0:
            assert name not in NEVER | {"cosnarks_tpu_torch", "portbench"}, (
                f"{path} imports {name}")


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "cosnarks_tpu_torch_x",
                        types.ModuleType("cosnarks_tpu_torch_x"))
    assert "cosnarks_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax():
    """Everything a run imports, every cell and every job, in a fresh
    process: nothing forbidden."""
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from portbench import run, faults, hooks, trace, work\n"
        "from portbench import plonk_fixture\n"
        "for w in json.loads((run.ROOT / 'BENCHMARK.json').read_text())"
        "['workloads']:\n"
        "    run.load_cell(w['name'])\n"
        "for p in sorted((run.ROOT / 'portbench/jobs').glob('*_*.py')):\n"
        "    run._load(p, 'portbench.jobs.' + p.stem)\n"
        "print(run.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_exits_without_a_result(tmp_path):
    """Here there is no CUDA card: exit 2, nothing on standard output. In a
    directory that holds only the benchmark, the run fails too."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "groth16_bn254_rep3.share_msm_2p20", "--seed", "2147483700",
             "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
