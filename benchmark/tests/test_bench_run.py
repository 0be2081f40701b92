"""run.py without a card, the import check, and the reference's
independence from the program."""
import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "light-jan-524k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
    assert "no CPU fallback" in p.stderr


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "vic_tpu_torch_extra", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_loaded() == ["jax"]
    monkeypatch.setitem(sys.modules, "vic_tpu.model", object())
    assert harness.forbidden_loaded() == ["jax", "vic_tpu"]
    with pytest.raises(harness.RunRefused):
        harness.refuse_forbidden("in the test")


def test_reference_imports_nothing_of_the_program():
    ref = harness.BENCH / "reference"
    for path in ref.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]] \
                    if node.level == 0 else []
            else:
                continue
            for top in tops:
                assert top not in ("vic_tpu_torch", "vic_tpu", "jax"), path
    code = ("import sys; import benchmark.compare, benchmark.gen; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'vic_tpu_torch', 'vic_tpu', 'jax', 'jaxlib', 'flax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_bare_checkout_of_the_benchmark_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    has no program to run: the run fails and prints no result."""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "light-jan-524k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
