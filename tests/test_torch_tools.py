"""The port's command-line tools (``tools/*_torch.py``) and bench.py's
diagc workload, on the CPU at a small size.

- ``test_sparsex_torch``: the reference tool's three end-to-end cases
  (tests/test_driver_parity.py:119-133, same matrices and exit codes), an
  RCM case and a bad ``-o``; its y on ``test2.mtx.sorted`` against the JAX
  package's ``matvec_mult`` within 1e-10 (float64);
- ``bench_spmv_torch``: all four adapters on one file (the JSON keys are
  the reference tool's, which runs the same file here), a directory, an
  unknown library (a usage error), a cross-check failure (exit 1);
- ``profile_fused_torch``: each of bench.py's four workloads at 2^13-2^14
  rows and blocky's SpMM (k = 3), its JSON in ``PROFILE_r05.json``'s
  format;
- every tool exits 2 without CUDA unless given ``--device cpu``, and on a
  malformed ``--device``; ``ops.oracle.mixed_rel_err`` is bench.py's;
- diagc (``chip_smoke.build_diagc_matrix``, bench.py's copied) at 2^14 and
  2^15: the plan ``check_diagc_plan`` expects, the SpMV against the
  reference executor and the COO oracle (1e-10 float64, ``CHECK_TOL``
  float32) and a k = 8 SpMM against eight SpMVs;
- a subprocess with ``jax``, ``sparsex_tpu`` and ``bench`` blocked runs
  ``test_sparsex_torch``, ``bench_spmv_torch`` and ``profile_fused_torch``.

The rank tools (``weak_scaling_torch``, ``soak_torch``) spawn processes:
tests/test_torch_tools_ranks.py.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import chip_smoke as cs
import sparsex_tpu_torch as spt

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MAT = os.path.join(HERE, "matrices")
DEMOPATT = os.path.join(MAT, "demopatt.mtx.sorted")
DEMOPATT_UNSORTED = os.path.join(MAT, "demopatt.mtx.unsorted")
SYMMETRIC = os.path.join(MAT, "symmetric.mtx.sorted")
TEST2 = os.path.join(MAT, "test2.mtx.sorted")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def fresh_port_config():
    spt.Config.reset()
    yield
    spt.Config.reset()


def load_tool(name, monkeypatch=None, **env):
    """A fresh ``tools/<name>.py`` module (the tools are scripts; their
    LOOPS-style constants are read at import, under ``env``)."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- test_sparsex_torch ---------------------------------------------------

@pytest.mark.parametrize("args,want", [
    # the reference tool's cases (tests/test_driver_parity.py:119-133)
    ([DEMOPATT, "-o", "spx.preproc.xform=all", "-t"], 0),
    ([DEMOPATT_UNSORTED], 2),
    ([SYMMETRIC, "-o", "spx.matrix.symmetric=true",
      "-o", "spx.preproc.xform=all"], 0),
    # RCM reordering (x and y through vec.reorder / inv_reorder)
    ([TEST2, "-o", "spx.preproc.xform=all", "-r", "-t"], 0),
    # an option the port does not know: a SparsexError at load/tune
    ([TEST2, "-o", "spx.preproc.no_such_option=1"], 2),
], ids=["all_timed", "unsorted", "symmetric", "reorder", "bad_option"])
def test_test_sparsex_exit_codes(args, want, monkeypatch, capsys):
    tool = load_tool("test_sparsex_torch", monkeypatch, LOOPS="4")
    assert tool.main(args + CPU) == want
    out = capsys.readouterr()
    if want == 0:
        assert "PASSED (rel_err=" in out.out
        assert ("MFLOPS" in out.out) == ("-t" in args)
    else:
        assert "LOAD/TUNE ERROR" in out.err


def test_test_sparsex_y_matches_the_jax_package(monkeypatch):
    """The port tool's y on test2.mtx.sorted against the JAX package's
    ``matvec_mult`` of the same file and x (float64)."""
    import sparsex_tpu as spx
    tool = load_tool("test_sparsex_torch", monkeypatch, LOOPS="2")
    got = tool.run(TEST2, ["spx.preproc.xform=all"], device="cpu")
    assert got["rc"] == 0 and got["err"] <= tool.TOLERANCE
    spx.option_set("spx.preproc.xform", "all")
    mat = spx.mat_tune(spx.input_load_mmf(TEST2))
    x = np.random.default_rng(0).random(mat.ncols)
    want = np.asarray(spx.matvec_mult(2.0, mat, jnp.asarray(x)),
                      dtype=np.float64)
    scale = np.abs(want).max()
    assert got["y"].dtype == np.float64
    assert np.abs(got["y"] - want).max() / scale < 1e-10


# --- bench_spmv_torch -----------------------------------------------------

BENCH_ENV = {"LOOPS": "2", "OUTER_LOOPS": "1"}
LIBS = ["-l", "sparsex,csr,native,scipy"]


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def test_bench_spmv_file_has_the_reference_tools_keys(monkeypatch, capsys):
    tool = load_tool("bench_spmv_torch", monkeypatch, **BENCH_ENV)
    assert tool.main(["-f", TEST2, "--json"] + LIBS + CPU) == 0
    out = capsys.readouterr().out
    assert out.count("[OK]") == 3 and "FAILED" not in out
    (got,) = _json_lines(out)
    ref_tool = load_tool("bench_spmv", monkeypatch, **BENCH_ENV)
    assert ref_tool.main(["-f", TEST2, "--json"] + LIBS) == 0
    (want,) = _json_lines(capsys.readouterr().out)
    assert set(got) == set(want) == {"matrix", "sparsex", "csr", "native",
                                     "scipy"}
    for lib in ("sparsex", "csr", "native", "scipy"):
        assert set(got[lib]) == set(want[lib]) == {"pt", "mt", "mflops",
                                                   "size"}
        assert got[lib]["mt"] > 0 and got[lib]["mflops"] > 0
        assert got[lib]["size"] > 0


def test_bench_spmv_directory(monkeypatch, capsys, tmp_path):
    for path in (DEMOPATT, TEST2):
        shutil.copy(path, tmp_path)
    tool = load_tool("bench_spmv_torch", monkeypatch, **BENCH_ENV)
    assert tool.main(["-d", str(tmp_path), "--json"] + LIBS + CPU) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert [os.path.basename(d["matrix"]) for d in lines] == [
        "demopatt.mtx.sorted", "test2.mtx.sorted"]


def test_bench_spmv_unknown_library_is_a_usage_error(monkeypatch):
    tool = load_tool("bench_spmv_torch", monkeypatch, **BENCH_ENV)
    with pytest.raises(SystemExit) as e:
        tool.main(["-f", TEST2, "-l", "sparsex,mkl"] + CPU)
    assert e.value.code == 2


def test_bench_spmv_cross_check_failure_exits_1(monkeypatch, capsys):
    tool = load_tool("bench_spmv_torch", monkeypatch, **BENCH_ENV)

    class Wrong(tool.ScipyAdapter):
        def __call__(self, x, renorm=False):
            return 1.001 * super().__call__(x, renorm)

    monkeypatch.setitem(tool.ADAPTERS, "scipy", Wrong)
    assert tool.main(["-f", TEST2, "-l", "sparsex,scipy"] + CPU) == 1
    assert "check scipy vs sparsex" in capsys.readouterr().out


# --- profile_fused_torch --------------------------------------------------

SMALL = {"BENCH_N": str(1 << 14), "BENCH_N_BLOCKY": str(1 << 14),
         "BENCH_N_SYM": str(1 << 13), "BENCH_N_DIAGC": str(1 << 14)}


@pytest.mark.parametrize("workload,spmm", [
    ("headline", 0), ("blocky", 0), ("symmetric", 0), ("diagc", 0),
    ("blocky", 3)])
def test_profile_fused(workload, spmm, monkeypatch, capsys, tmp_path):
    tool = load_tool("profile_fused_torch", monkeypatch, **SMALL)
    path = str(tmp_path / "profile.json")
    argv = ["--workload", workload, "--iters", "2", "--reps", "1",
            "--spmm", str(spmm), "--json", path] + CPU
    assert tool.main(argv) == 0
    out = capsys.readouterr().out
    assert "cpu total:" in out and "platform=cpu" in out
    with open(path) as fp:
        data = json.load(fp)
    key = workload + (f" spmm k={spmm}" if spmm else "")
    assert list(data) == [key]
    entry = data[key]
    assert set(entry) == {"nnz", "total_us_per_iter", "kernels",
                          "chain_us_per_iter", "platform"}
    builder, n = tool.sizes()[workload]
    assert entry["nnz"] == builder(n)[0].size
    assert entry["total_us_per_iter"] > 0 and entry["platform"] == "cpu"
    assert entry["chain_us_per_iter"] > 0
    assert all(isinstance(v, float) for v in entry["kernels"].values())


def test_kernel_key_names_our_kernels():
    assert cs.kernel_key("void k1_lp_kernel<float>(float const*)") == "k1"
    assert cs.kernel_key("k1_rlp_kb_kernel<double>") == "k1_rlp_kb"
    assert cs.kernel_key("k2_kernel<float>(...)") == "k2"
    assert cs.kernel_key("k2_kernel<float>(...)", kb=True) == "k2_kb"
    assert cs.kernel_key("delta_pages_acc_kernel<float>") == \
        "delta_pages_acc"
    assert cs.kernel_key("void at::native::vectorized_elementwise") is None
    # every launch key, by its demangled name (the profile) and its mangled
    # one (a graph's kernel nodes, through the CUDA driver)
    from sparsex_tpu_torch.ops.fused import KERNELS
    for key in KERNELS:
        kb = key.endswith("_kb")
        base = key[:-3] if kb else key
        entry = ("k1_lp" if base == "k1" else base) + ("_kb" if kb else "")
        assert cs.kernel_key(f"void {entry}_kernel<float>(int const*)") == key
        m = cs._MANGLED.search(f"_ZN12_GLOBAL__N_1{len(entry) + 7}{entry}"
                               "_kernelIfEEvPKi")
        assert m and m.group(1) + (m.group(2) or "") == (
            "k1_lp" if base == "k1" else base) + ("_kb" if kb else "")


# --- every tool without CUDA -------------------------------------------------

TOOL_ARGV = [
    ("test_sparsex_torch", [TEST2]),
    ("bench_spmv_torch", ["-f", TEST2]),
    ("profile_fused_torch", ["--workload", "diagc"]),
    ("weak_scaling_torch", ["--devices", "1"]),
    ("soak_torch", ["--n", "4096"]),
]


@pytest.mark.parametrize("name,argv", TOOL_ARGV)
def test_tool_without_cuda_exits_2(name, argv, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    tool = load_tool(name, monkeypatch, **SMALL)
    assert tool.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("name,argv", TOOL_ARGV)
def test_tool_with_a_malformed_device_exits_2(name, argv, monkeypatch,
                                              capsys):
    tool = load_tool(name, monkeypatch, **SMALL)
    assert tool.main(argv + ["--device", "bogus"]) == 2
    assert "--device bogus" in capsys.readouterr().err


def test_mixed_rel_err_is_benchs():
    from sparsex_tpu_torch.ops.oracle import mixed_rel_err
    rng = np.random.default_rng(3)
    b = rng.standard_normal(1000)
    b[::7] = 0.0
    a = b + 1e-5 * rng.standard_normal(1000)
    assert mixed_rel_err(a, b) == bench._mixed_rel_err(a, b)
    assert mixed_rel_err(a[:0], b[:0]) == 0.0


# --- diagc ------------------------------------------------------------------

def test_diagc_builder_is_benchs():
    for a, b in zip(cs.build_diagc_matrix(1 << 12),
                    bench.build_diagc_matrix(1 << 12)):
        np.testing.assert_array_equal(a, b)
    assert cs.N_DIAGC == 1 << 19


def _tune_diagc(n, dtype_name):
    rows, cols, vals = cs.build_diagc_matrix(n)
    cfg = spt.Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype_name)
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    mat = spt.mat_tune(cs.csr_input(spt, rows, cols, vals, n), device="cpu")
    return mat, rows, cols, vals


@pytest.mark.parametrize("n,dtype_name,bar", [
    (1 << 14, "float64", 1e-10), (1 << 15, "float64", 1e-10),
    (1 << 15, "float32", cs.CHECK_TOL)])
def test_diagc_matches_reference_and_oracle(n, dtype_name, bar, capsys):
    """The port's plan (``dfused`` with its ``cvt`` run tables, 3 route
    instances at these sizes) and SpMV against the reference executor
    (its own plan, XLA on the CPU) and the float64 COO oracle."""
    from sparsex_tpu.config import Config
    from sparsex_tpu.csx import CsxMatrix
    mat, rows, cols, vals = _tune_diagc(n, dtype_name)
    cs.check_diagc_plan(3)(mat, f"diagc {n} {dtype_name}")
    assert "plan: extras ['dfused']" in capsys.readouterr().out
    x = cs.x_for(mat, n, dtype_name)
    got = spt.matvec_kernel(1.0, mat, x, 0.0, None).double().numpy()
    want = cs._oracle_spmv(n, rows, cols, vals, x.numpy())
    assert cs._mixed_rel_err(got, want) < bar
    cfg = Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype_name)
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    ref = CsxMatrix.from_coo(n, n, rows, cols, vals, config=cfg)
    yr = np.asarray(ref.matvec(jnp.asarray(x.numpy())), dtype=np.float64)
    assert np.abs(got - yr).max() / np.abs(yr).max() < bar


def test_diagc_spmm_matches_its_spmvs():
    """A k = 8 SpMM (one k-batched chunk) equals eight SpMVs on the CPU."""
    n = 1 << 15
    mat, rows, cols, vals = _tune_diagc(n, "float32")
    X = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n, 8)).astype(np.float32))
    Y = spt.matmat_kernel(1.0, mat, X, 0.0, None)
    cols_ = torch.stack([spt.matvec_kernel(1.0, mat, X[:, j].contiguous(),
                                           0.0, None) for j in range(8)], 1)
    torch.testing.assert_close(Y, cols_, rtol=0, atol=0)
    want = np.stack([cs._oracle_spmv(n, rows, cols, vals, X[:, j].numpy())
                     for j in range(8)], 1)
    assert cs._mixed_rel_err(Y.double().numpy(), want) < cs.CHECK_TOL


# --- no JAX -----------------------------------------------------------------

NOJAX = r"""
import importlib.util, json, os, sys

BLOCKED = ("jax", "jaxlib", "sparsex_tpu", "bench", "ml_dtypes")

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")

sys.meta_path.insert(0, _Blocked())
root, mat, out = sys.argv[1:4]


def tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rcs = [tool("test_sparsex_torch").main([mat, "-o", "spx.preproc.xform=all",
                                        "--device", "cpu"]),
       tool("bench_spmv_torch").main(["-f", mat, "-l",
                                      "sparsex,csr,native,scipy",
                                      "--device", "cpu"]),
       tool("profile_fused_torch").main(["--workload", "diagc", "--iters",
                                         "2", "--reps", "1", "--device",
                                         "cpu"])]
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
with open(out, "w") as fp:
    json.dump({"rcs": rcs, "loaded": bad}, fp)
"""


def test_tools_run_without_jax(tmp_path):
    out = tmp_path / "out.json"
    env = dict(os.environ, LOOPS="2", OUTER_LOOPS="1",
               BENCH_N_DIAGC=str(1 << 13))
    proc = subprocess.run(
        [sys.executable, "-c", NOJAX, ROOT, TEST2, str(out)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as fp:
        got = json.load(fp)
    assert got == {"rcs": [0, 0, 0], "loaded": []}
