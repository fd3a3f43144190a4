"""What the benchmark may load: nothing of JAX or the JAX package anywhere,
nothing of the program in the plain reference; a run with no card fails
with no result; and a run's process takes one CPU thread a math library."""

import ast
import json
import subprocess
import sys

import pytest

from h100bench import common

ROOT = common.ROOT


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted((ROOT / "h100bench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(common.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((ROOT / "h100bench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "objcavit_torch" not in top_level_imports(path)


def test_the_check_compares_whole_top_level_names():
    assert common.forbidden_modules(["objcavit_torch.models", "jaxtyping"]) == []
    assert common.forbidden_modules(["jax.numpy", "objcavit_tpu.models"]) == [
        "jax.numpy", "objcavit_tpu.models"]


def test_a_cpu_run_loads_no_jax():
    """A whole tiny run in a fresh process, then its ``sys.modules``."""
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1]);"
        "from h100bench.tests.conftest import tiny_files;"
        "from h100bench import common, harness;"
        "r = harness.run_cell(common.benchmark(), 'graphbins-b5.request-bs8', 7, 0.2, False,"
        " 'cpu', files=tiny_files('graphbins-b5.request-bs8'));"
        "print(json.dumps([r['correct'], common.forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == [True, []]


def _env():
    import os

    return {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}


def test_a_run_with_no_card_fails_with_no_result():
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                          "graphbins-b5.stream-bs16", "--seed", "2147483659", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=600, env=_env())
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_run_takes_one_cpu_thread_whatever_the_environment_says():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from h100bench import common;"
            "common.set_environment(); import torch; print(torch.get_num_threads())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         cwd=ROOT, timeout=600, env={**_env(), "OMP_NUM_THREADS": "4"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["1"]
