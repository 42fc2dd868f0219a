"""What a run's process may load: no JAX and nothing of the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and a reference that brings in nothing of the port.  And the
command refuses to run without a card or without the port."""

import json
import os
import shutil
import subprocess
import sys

import torch

from benchmark import harness

ROOT = harness.ROOT
PROBE = """
import glob, json, os, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def top_level_names(body: str) -> set:
    code = PROBE.format(root=ROOT, body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loops_and_metrics_load_no_jax():
    names = top_level_names("""
from benchmark import harness
import sparsex_tpu_torch
for kind in ("loops", "metrics", "gen"):
    for p in glob.glob(os.path.join(harness.HERE, kind, "*.py")):
        harness.load_module(kind, os.path.basename(p)[:-3])
""")
    assert "sparsex_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "sparsex_tpu"}


def test_reference_brings_in_nothing_of_the_port():
    names = top_level_names("from benchmark.reference import plain")
    assert not names & {"jax", "jaxlib", "flax", "sparsex_tpu",
                        "sparsex_tpu_torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sparsex_tpu_torch_like", sys)
    assert "sparsex_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_no_result_when_a_forbidden_module_is_loaded_by_the_end(
        monkeypatch, capsys):
    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "TORCHINDUCTOR_CACHE_DIR"):
        monkeypatch.setenv(key, "")    # restored after run.py sets them
    from benchmark import run as bench_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def late_import(*args, **kw):
        # as a reference or a metric reader that loads JAX would
        monkeypatch.setitem(sys.modules, "flax.core", sys)
        return {"correct": True, "checks": {}}

    monkeypatch.setattr(harness, "run_cell", late_import)
    rc = bench_run.main(["--workload", "urand19-pagerank", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and "correct" not in out.out
    assert "flax" in out.err


def run_command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "urand19-pagerank", "--seed", str(2 ** 33 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env=env)


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_command(ROOT, env)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_no_result_with_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_command(str(tmp_path))
    assert out.returncode != 0
    assert "correct" not in out.stdout
