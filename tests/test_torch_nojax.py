"""sparsex_tpu_torch runs without JAX, and refuses what it does not run.

A subprocess blocks every ``jax`` import with a ``sys.meta_path`` finder,
tunes the bench's headline matrix at 2^17 rows and its blocky matrix at
2^18 rows (fused runs and a merged plan) on the CPU and checks each SpMV
against the COO oracle; then it checks three refusals: no default
device without CUDA, no kernel build without nvcc, and NotImplementedError
for a plan outside the ported slice.  ``chip_smoke.py`` imports neither JAX
nor the JAX package itself, and without a CUDA device it exits non-zero
and prints no result.
"""

import ast
import json
import os
import subprocess
import sys
import tempfile

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys, tempfile

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax is blocked in this process")

sys.meta_path.insert(0, _NoJax())
import numpy as np
import torch
torch.set_num_threads(1)

import bench
import sparsex_tpu_torch as spx
from sparsex_tpu.ops.oracle import coo_spmv
from sparsex_tpu_torch.ops import _build

out = {}
n = 1 << 17
rows, cols, vals = bench.build_matrix(n)
cfg = spx.Config.reset()
cfg.set("spx.tpu.value_dtype", "float32")
cfg.set("spx.preproc.xform", "all")
cfg.set("spx.preproc.sampling", "portion")
rowptr = np.zeros(n + 1, dtype=np.int64)
rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
A = spx.mat_tune(spx.input_load_csr(rowptr, cols, vals, n, n),
                 device="cpu")
extras = {e[0]: e[1:] for e in A.csx.executors[0].meta[5:] if e}
out["extras"] = sorted(extras)
x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
y = spx.matvec_kernel(1.0, A, x, 0.0, None, device="cpu")
want = coo_spmv(n, rows, cols, vals.astype(np.float64), x.astype(np.float64))
out["rel_err"] = bench._mixed_rel_err(y.numpy(), want)
out["shape"] = list(y.shape)

nb = 1 << 18
rows, cols, vals = bench.build_blocky_matrix(nb)
rowptr = np.zeros(nb + 1, dtype=np.int64)
rowptr[1:] = np.cumsum(np.bincount(rows, minlength=nb))
B = spx.mat_tune(spx.input_load_csr(rowptr, cols, vals, nb, nb),
                 device="cpu")
meta = B.csx.executors[0].meta
out["blocky_extras"] = sorted(e[0] for e in meta[5:] if e)
out["blocky_styles"] = sorted(e[5][1][5] for e in meta[2]
                              if len(e) > 5 and e[5] and e[5][0] == "frun")
xb = np.random.default_rng(2).standard_normal(nb).astype(np.float32)
yb = spx.matvec_kernel(1.0, B, xb, 0.0, None, device="cpu")
want = coo_spmv(nb, rows, cols, vals.astype(np.float64), xb.astype(np.float64))
out["blocky_rel_err"] = bench._mixed_rel_err(yb.numpy(), want)

torch.cuda.is_available = lambda: False
try:
    spx.resolve_device()
    out["no_cuda"] = "returned"
except spx.SparsexError as e:
    out["no_cuda"] = "SparsexError"

_build.BUILD_DIR = tempfile.mkdtemp()     # no cached library to load
try:
    _build.library()
    out["no_nvcc"] = "built"
except _build.KernelBuildError as e:
    out["no_nvcc"] = "KernelBuildError" if "nvcc not found" in str(e) else str(e)

d = np.arange(4096)
try:
    spx.mat_tune(spx.input_load_csr(np.arange(4097), d,
                                    np.ones(4096, np.float32), 4096, 4096),
                 device="cpu")
    out["out_of_slice"] = "tuned"
except NotImplementedError as e:
    out["out_of_slice"] = "NotImplementedError" if "ROADMAP.md" in str(e) else str(e)

out["jax_modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax."))
print(json.dumps(out))
"""


def test_port_runs_and_refuses_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env["CUDA_HOME"] = os.path.join(tempfile.gettempdir(), "no-cuda-here")
    env["PATH"] = os.path.dirname(sys.executable)
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["jax_modules"] == []
    assert out["extras"] == ["dfused", "k3dias"]
    assert out["shape"] == [1 << 17]
    assert out["rel_err"] < 2e-4          # bench.CHECK_TOL
    assert out["blocky_extras"] == ["dfused", "fall"]
    assert out["blocky_styles"] == ["rlp2", "rlp8"]
    assert out["blocky_rel_err"] < 2e-4
    assert out["no_cuda"] == "SparsexError"
    assert out["no_nvcc"] == "KernelBuildError"
    assert out["out_of_slice"] == "NotImplementedError"


def test_chip_smoke_imports_no_jax_and_refuses_without_cuda():
    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path) as fp:
        tree = ast.parse(fp.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    top = {m.split(".")[0] for m in mods}
    assert "jax" not in top and "sparsex_tpu" not in top, sorted(mods)
    assert "sparsex_tpu_torch" in top
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, path], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "kernels" not in r.stdout
