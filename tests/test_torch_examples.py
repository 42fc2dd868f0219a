"""The nine examples of the PyTorch port (``examples/*_torch.py``) on the
CPU at a small size.

Each example's ``main(argv)`` runs in this process with ``--device cpu``
and must return 0 after printing its own check line (against the COO
oracle, a dense product or the true residual) as ``check: ... ok``.
``matrix_caching_example_p2_torch`` restores what
``matrix_caching_example_p1_torch`` saved under ``tmp_path``.  On the
card, ``chip_smoke.py`` runs each ``main`` at its default size.
"""

import importlib.util
import os

import pytest
import torch

import sparsex_tpu_torch as spt

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# example -> its arguments at a small size (besides --device cpu)
EXAMPLES = {
    "csr_example_torch": [],
    "mmf_example_torch": ["--loops", "4"],
    "advanced_example_torch": [],
    "reordering_example_torch": [],
    "matrix_caching_example_p1_torch": ["--cache", "{tmp}/a.npz"],
    "matrix_caching_example_p2_torch": ["--cache", "{tmp}/a.npz"],
    "cg_example_torch": ["--n", "512"],
    "spmm_block_cg_example_torch": ["--n", "512", "--k", "3"],
    "spgemm_example_torch": ["--n", "256", "--nnz", "2000"],
}


@pytest.fixture(autouse=True)
def fresh_port_config():
    spt.Config.reset()
    yield
    spt.Config.reset()


def load_example(name):
    """The module ``examples/<name>.py`` (the examples are scripts, not a
    package)."""
    path = os.path.join(ROOT, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, tmp_path, capsys):
    args = [a.format(tmp=tmp_path) for a in EXAMPLES[name]]
    rc = load_example(name).main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    checks = [line for line in out.splitlines() if line.startswith("check:")]
    return rc, out, checks


def test_every_torch_example_is_listed():
    found = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
                   if f.endswith("_torch.py"))
    assert found == sorted(EXAMPLES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_and_checks(name, tmp_path, capsys):
    if name == "matrix_caching_example_p2_torch":
        assert _run("matrix_caching_example_p1_torch", tmp_path,
                    capsys)[0] == 0
        spt.Config.reset()
    rc, out, checks = _run(name, tmp_path, capsys)
    assert rc == 0, out
    assert len(checks) == 1 and checks[0].endswith(": ok"), out
