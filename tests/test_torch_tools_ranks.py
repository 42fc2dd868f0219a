"""The port's rank tools on the CPU: ``tools/weak_scaling_torch.py`` and
``tools/soak_torch.py``, each run as a script (``python3 tools/<tool>.py
... --device cpu``), as users run them: their spawned ranks
(``parallel.comm.run_ranks``, gloo) import the script by its path.

- ``weak_scaling_torch --devices 1 2`` at 2^12 rows a rank, x replicated
  and through the halo ring: every point within 2e-4 of the float64 COO
  oracle, the JSON's fields, gloo's note; ``--mesh 1x2`` is accepted;
- ``soak_torch --n 8192 --nnz 60000`` on 2 ranks: every check, then
  ``SOAK PASSED`` and exit 0.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(name, *argv, timeout=300):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", name + ".py")]
        + list(argv) + ["--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=timeout)
    assert proc.returncode >= 0, "killed by a signal"
    return proc


@pytest.mark.parametrize("mode", ["replicated", "halo"])
def test_weak_scaling(mode, tmp_path):
    path = str(tmp_path / "weak.json")
    proc = run_tool("weak_scaling_torch", "--devices", "1", "2",
                    "--base-n", "4096", "--mode", mode, "--loops", "2",
                    "--mesh", "1x2", "--json", path)
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-3000:])
    assert "weak-scaling efficiency @ 2 devices" in proc.stdout
    with open(path) as fp:
        out = json.load(fp)
    assert {"platform", "backend", "note", "mode", "base_n",
            "points"} <= set(out)
    assert (out["platform"], out["backend"], out["mode"],
            out["base_n"]) == ("cpu", "gloo", mode, 4096)
    assert "NOT a scaling result" in out["note"]
    points = out["points"]
    assert [p["devices"] for p in points] == [1, 2]
    assert points[1]["nnz"] > points[0]["nnz"]
    for p in points:
        assert p["x_mode"] == mode
        assert p["rel_err"] < 2e-4 and p["us_per_spmv"] > 0
    assert points[0]["efficiency_vs_1dev"] == 1.0


def test_soak(tmp_path):
    proc = run_tool("soak_torch", "--n", "8192", "--nnz", "60000",
                    "--ranks", "2")
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-3000:])
    lines = proc.stdout.splitlines()
    assert lines[-1] == "SOAK PASSED"
    checks = [line for line in lines if line.endswith("]")]
    assert len(checks) == 9 and all(c.endswith("[ok]") for c in checks)
    assert any("sharded x2 halo(k=" in c for c in checks)
