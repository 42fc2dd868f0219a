"""sparsex_tpu_torch stands on its own, and refuses what it does not run.

A subprocess blocks every import of ``jax``, of the JAX package
``sparsex_tpu`` (but not ``sparsex_tpu_torch``), of its benchmark
``bench`` and of ``ml_dtypes`` (NumPy's bf16, which only JAX brings) with
a ``sys.meta_path`` finder, then tunes and runs on the CPU,
each SpMV against a numpy COO oracle within ``chip_smoke.CHECK_TOL``: the
headline matrix at 2^17 rows, the blocky matrix at 2^18 (fused runs and a
merged plan), the HPCG stencil at 16^3 (the plain-table DIA variant, its
meta recomputed from the port's own tables), the wide-run matrix at 2^15
(K1 style run16), the lane-skewed one at 2^15 (K1 style sl) and the 3x3
block matrix at 3 * 2^14 (a block table through a partial segment,
``fs``); then the headline matrix at 2^17 as a bf16 matrix (computed in
float32), its SpMV and a k = 2 SpMM of a bf16 x within 2e-2 of the largest
value of the oracle on the bf16-rounded values and x.  Then it
checks two refusals, no default device without CUDA and no kernel build
without nvcc; that 2^15 random singles with the fused pipeline kept off
(``spx.tpu.min_fused_nnz``) plan the paged delta with its scatter route
(``dscatter``) and run within the same bar; that bench.py's symmetric
matrix at 2^14 rows (page and route gates at 1024) runs per shard, on
both paged delta streams and their scatter routes, and as its full
mirror, within the same bar; that the headline matrix at 2^16 tunes in two
shards, takes a ``set_entry`` on shard 1 (planned again once) and
survives a ``mat_save`` / ``mat_restore`` round trip, each SpMV within the
same bar; that a class no planner of the port makes (the reference's
stacked sharded delta of several devices) raises NotImplementedError; and
that ``examples/cg_example_torch.py`` solves at 256 rows and passes its
own check; at the end no module of
``jax``, ``sparsex_tpu`` or ``bench`` is loaded.
``chip_smoke.py`` imports none of them either, and without a CUDA device
it exits non-zero and prints no result.
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

BLOCKED = ("jax", "jaxlib", "sparsex_tpu", "bench", "ml_dtypes")

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")

sys.meta_path.insert(0, _Blocked())
import numpy as np
import torch
torch.set_num_threads(1)

import chip_smoke as cs
import sparsex_tpu_torch as spx
from sparsex_tpu_torch.ops import _build
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.kernels import static_meta

out = {}


def tune(n, rows, cols, vals, **options):
    cfg = spx.Config.reset()
    cfg.set("spx.tpu.value_dtype", "float32")
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    for key, value in options.items():
        cfg.set(key, value)
    return spx.mat_tune(cs.csr_input(spx, rows, cols, vals, n),
                        device="cpu")


def spmv_err(A, n, rows, cols, vals, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    y = spx.matvec_kernel(1.0, A, x, 0.0, None, device="cpu")
    want = np.bincount(rows, weights=vals.astype(np.float64)
                       * x.astype(np.float64)[cols], minlength=n)
    assert tuple(y.shape) == (n,)
    return cs._mixed_rel_err(y.numpy(), want)


def extras(A):
    return sorted(e[0] for e in A.csx.executors[0].meta[5:] if e)


def styles(A):
    meta = A.csx.executors[0].meta
    return sorted(m[5] for _, m in cs.fused_runs(meta))


n = 1 << 17
rows, cols, vals = cs.build_matrix(n)
A = tune(n, rows, cols, vals)
out["headline"] = (extras(A), spmv_err(A, n, rows, cols, vals, 1))

n = 1 << 18
rows, cols, vals = cs.build_blocky_matrix(n)
A = tune(n, rows, cols, vals)
out["blocky"] = (extras(A), styles(A), spmv_err(A, n, rows, cols, vals, 2))
# one SpMM (k = 3, the k-batched path of the merged plan)
X = np.random.default_rng(6).standard_normal((n, 3)).astype(np.float32)
Y = spx.matmat_kernel(1.0, A, X, 0.0, None, device="cpu")
want = np.stack([np.bincount(rows, weights=vals.astype(np.float64)
                             * X[:, j].astype(np.float64)[cols], minlength=n)
                 for j in range(3)], axis=1)
out["spmm"] = (list(Y.shape), cs._mixed_rel_err(Y.numpy(), want))

n, rows, cols, vals = cs.hpcg_matrix(16)
A = tune(n, rows, cols, vals.astype(np.float32),
         **{"spx.preproc.sampling": "none"})
ex = A.csx.executors[0]
out["hpcg"] = (ex.variant, ex.meta == static_meta(A.csx.shards[0]),
               [len(offs) for _a, offs, _n in ex.meta[4]],
               spmv_err(A, n, rows, cols, vals, 3))

troute.MIN_ELEMS = 1024   # a run table routes one element per unit
n = 1 << 15
rows, cols, vals = cs.wide_run_matrix(n, 16)
A = tune(n, rows, cols, vals)
out["run16"] = (extras(A), styles(A), spmv_err(A, n, rows, cols, vals, 4))
troute.MIN_ELEMS = 1 << 15

rows, cols, vals = cs.lane_skew_matrix(n)
A = tune(n, rows, cols, vals)
fmeta = A.csx.executors[0].meta[5][1]
out["sl"] = (extras(A), fmeta[6], spmv_err(A, n, rows, cols, vals, 5))

n = 3 << 14               # a 3x3 block table through a partial segment
rows, cols, vals = cs.block3_matrix(n)
A = tune(n, rows, cols, vals)
ex = A.csx.executors[0]
out["fs"] = ([e[4][0] for e in ex.meta[3] if len(e) > 4 and e[4]],
             spmv_err(A, n, rows, cols, vals, 6))

n = 1 << 17              # a bf16 matrix, computed in float32
rows, cols, vals = cs.build_matrix(n)
A = tune(n, rows, cols, vals, **{"spx.tpu.value_dtype": "bfloat16"})
X = torch.from_numpy(np.random.default_rng(7).standard_normal((n, 2))
                     .astype(np.float32)).bfloat16()
y = spx.matvec_kernel(1.0, A, X[:, 0].contiguous(), 0.0, None, device="cpu")
Y = spx.matmat_kernel(1.0, A, X, 0.0, None, device="cpu")
vb = torch.from_numpy(vals).bfloat16().double().numpy()
Xh = X.double().numpy()
want = np.stack([np.bincount(rows, weights=vb * Xh[cols, j], minlength=n)
                 for j in range(2)], axis=1)
out["bf16"] = (str(y.dtype), str(Y.dtype), extras(A),
               float(np.abs(y.double().numpy() - want[:, 0]).max()
                     / np.abs(want[:, 0]).max()),
               float(np.abs(Y.double().numpy() - want).max()
                     / np.abs(want).max()))

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

# singles with the fused pipeline kept off plan the paged delta with its
# scatter route (dscatter), which runs since ROADMAP Queue 1 item 10
rng = np.random.default_rng(4)
ns, m = 1 << 15, 40000
key = np.unique(rng.integers(0, ns * ns, m))
r, c = key // ns, key % ns
v = rng.standard_normal(r.size).astype(np.float32)
A = tune(ns, r, c, v, **{"spx.tpu.min_fused_nnz": str(1 << 30)})
out["dscatter"] = (extras(A), spmv_err(A, ns, r, c, v, 8))

# a symmetric matrix (ROADMAP Queue 1 item 8): per shard, both paged delta
# streams through their scatter routes, and the full mirror
tpk.MIN_PAGE_NNZ, troute.MIN_ELEMS = 1024, 1024
n = 1 << 14
rows, cols, vals = cs.build_symmetric_matrix(n)
for mode in ("off", "on"):
    A = tune(n, rows, cols, vals, **{"spx.matrix.symmetric": "true",
                                     "spx.tpu.sym_full": mode})
    out["symmetric " + mode] = (type(A.csx.executors[0]).__name__,
                                extras(A), spmv_err(A, n, rows, cols, vals,
                                                    9))
tpk.MIN_PAGE_NNZ, troute.MIN_ELEMS = 1 << 14, 1 << 15

# two shards (ROADMAP Queue 1 item 5): the headline matrix at 2^16 tuned
# in two shards, a set_entry on shard 1 seen by the next SpMV, and a
# save / restore round trip
n = 1 << 16
rows, cols, vals = cs.build_matrix(n)
A = tune(n, rows, cols, vals, **{"spx.rt.nr_threads": "2"})
i = int(np.nonzero(rows >= A.csx.partition.row_start[1])[0][3])
spx.mat_set_entry(A, int(rows[i]), int(cols[i]), 4.0)
vals = vals.copy()
vals[i] = 4.0
path = tempfile.mkdtemp() + "/a.npz"
spx.mat_save(A, path)
B = spx.mat_restore(path, device="cpu")
errs = [spmv_err(M, n, rows, cols, vals, 10) for M in (A, B)]
out["shards"] = [len(A.csx.executors), A.csx.replans] + errs + [
    spx.mat_get_entry(B, int(rows[i]), int(cols[i]))]

# a class no planner of the port makes: the reference's stacked sharded
# delta of several devices
from sparsex_tpu_torch.ops.kernels import check_slice
try:
    check_slice((ns, ns, (), (), (), ("dsfused", None)))
    out["out_of_slice"] = "passed"
except NotImplementedError as e:
    out["out_of_slice"] = ("NotImplementedError" if "'dsfused'" in str(e)
                           else str(e))

# the CG example (a symmetric matrix, the solver's blocks) at a small size
import importlib.util
spec = importlib.util.spec_from_file_location(
    "cg_example_torch", "examples/cg_example_torch.py")
example = importlib.util.module_from_spec(spec)
spec.loader.exec_module(example)
out["cg_example"] = example.main(["--n", "256", "--device", "cpu"])

out["blocked_modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in BLOCKED)
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
    tol = 2e-4                             # chip_smoke.CHECK_TOL
    assert out["blocked_modules"] == []
    assert out["headline"][0] == ["dfused", "k3dias"]
    assert out["headline"][1] < tol
    assert out["blocky"][:2] == [["dfused", "fall"], ["rlp2", "rlp8"]]
    assert out["blocky"][2] < tol
    assert out["spmm"][0] == [1 << 18, 3] and out["spmm"][1] < tol
    assert out["hpcg"][:3] == ["plain", True, [27]]
    assert out["hpcg"][3] < tol
    assert out["run16"][:2] == [["dfused", "fall"], ["run16"]]
    assert out["run16"][2] < tol
    assert out["sl"][:2] == [["dfused"], "sl"]
    assert out["sl"][2] < tol
    assert out["fs"][0] == ["fs"] and out["fs"][1] < tol
    assert out["bf16"][:3] == ["torch.bfloat16", "torch.bfloat16",
                               ["dfused", "k3dias"]]
    assert max(out["bf16"][3:]) < 2e-2
    assert out["no_cuda"] == "SparsexError"
    assert out["no_nvcc"] == "KernelBuildError"
    assert out["dscatter"][0] == ["dpages", "dscatter"]
    assert out["dscatter"][1] < tol
    assert out["symmetric off"][:2] == [
        "SymShardExecutor", ["dpages", "dpagesT", "dscatter", "dscatterT"]]
    assert out["symmetric on"][:2] == ["CsxExecutor",
                                       ["dpages", "dscatter"]]
    assert max(out["symmetric off"][2], out["symmetric on"][2]) < tol
    assert out["shards"][:2] == [2, 1]
    assert max(out["shards"][2:4]) < tol and out["shards"][4] == 4.0
    assert out["out_of_slice"] == "NotImplementedError"
    assert out["cg_example"] == 0


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
    assert not top & {"jax", "sparsex_tpu", "bench"}, sorted(mods)
    assert "sparsex_tpu_torch" in top
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, path], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "kernels" not in r.stdout
