"""Several shards on one device (``spx.rt.nr_threads``) on the CPU.

The same COO, tuned by the port and by the JAX package at the same shard
count, must give the same row partition and shard tables, and SpMV / SpMM
results (alpha and beta included) within 1e-10 of each other and of a
float64 COO oracle in float64, within ``chip_smoke.CHECK_TOL`` (2e-4, the
mixed relative error) in float32, within 2e-2 of the largest oracle value
for a bf16 matrix.  The reference runs as its own tests run it on the CPU:
its plain tables (its page layouts are TPU-only).  The port runs each
shard's own plan through its plain kernel versions; one
``ShardsExecutor`` runs them all.

Inputs: ``tests/test_csx_e2e.py``'s ``MATRICES`` in 2, 3 and 4 shards;
bench.py's headline matrix at 2^14; a small blocky matrix whose shards plan
the merged route plan with lane-placed run tables
(``tests/test_torch_blocky.py``'s recipe); a matrix whose shards plan
differently (one the fused delta pipeline, the other the plain DIA
tables); bench.py's symmetric matrix at 2^14 with its per-shard plans
paging and routing both delta streams (``tests/test_torch_symmetric.py``'s
recipe) and as its full mirror.
"""

import numpy as np
import pytest
import torch

import sparsex_tpu.ops.fused as fused
import sparsex_tpu.ops.pallas_kernels as pk
from sparsex_tpu.config import Config as RefConfig
from sparsex_tpu.csx import CsxMatrix as RefCsxMatrix
from sparsex_tpu.ops import route as route_mod
from sparsex_tpu.symmetric import build_symmetric_csx as ref_build_sym

import chip_smoke
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.exec import ShardsExecutor
from sparsex_tpu_torch.ops.kernels import fused_mm_ok
from sparsex_tpu_torch.symmetric import SymShardExecutor
from test_torch_blocky import _merged_matrix
from test_torch_plan import assert_same
from tests import fixtures

torch.set_num_threads(1)

MATRICES = {
    "pattern10": fixtures.pattern10(),
    "random": fixtures.random_coo(),
    "banded": fixtures.banded_coo(),
    "blocky": fixtures.blocky_coo(),
}
BARS = {"float64": 1e-10, "float32": chip_smoke.CHECK_TOL}


@pytest.fixture(autouse=True)
def fresh_port_config():
    spt.Config.reset()
    yield
    spt.Config.reset()


def _thresholds(monkeypatch, **values):
    """Planner thresholds set alike on both packages."""
    mods = {"MIN_FUSED_NNZ": (fused, tf), "MIN_PAGE_NNZ": (pk, tpk),
            "MIN_ELEMS": (route_mod, troute)}
    for name, value in values.items():
        for mod in mods[name]:
            monkeypatch.setattr(mod, name, value)


def _options(**options):
    for cfg in (spt.Config.instance(), RefConfig.instance()):
        for key, value in options.items():
            cfg.set(key, str(value))


def _tune(nrows, ncols, rows, cols, vals, nthreads, **options):
    """The port's matrix (on the CPU) and the reference's, tuned from the
    same COO under the same options in ``nthreads`` shards."""
    _options(**{"spx.rt.nr_threads": nthreads, **options})
    A = spt.mat_tune(spt.input_load_csr(*_csr(nrows, rows, cols, vals),
                                        nrows, ncols), device="cpu")
    ref = RefCsxMatrix.from_coo(nrows, ncols, rows, cols, vals)
    return A, ref


def _csr(nrows, rows, cols, vals):
    order = np.lexsort((cols, rows))
    rowptr = np.zeros(nrows + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=nrows))
    return rowptr, np.asarray(cols)[order], np.asarray(vals)[order]


def _parts(p):
    return (p.nparts, list(p.row_start), list(p.row_end),
            list(p.nnz_per_part))


def _oracle(nrows, rows, cols, vals, x):
    x = np.asarray(x, dtype=np.float64)
    v = np.asarray(vals, dtype=np.float64)
    if x.ndim == 1:
        return np.bincount(rows, weights=v * x[cols], minlength=nrows)
    return np.stack([_oracle(nrows, rows, cols, vals, x[:, j])
                     for j in range(x.shape[1])], axis=1)


def _err(got, want, dtype):
    got = np.asarray(got, dtype=np.float64)
    if dtype == "float64":
        return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    return chip_smoke._mixed_rel_err(got, want)


def _check(A, ref, nrows, ncols, rows, cols, vals, dtype, k=3, seed=0):
    """SpMV and SpMM (alpha, beta, y) of the port against the oracle and
    the reference, and the partitions and shard tables equal."""
    assert _parts(A.csx.partition) == _parts(ref.partition)
    assert_same(A.csx.shards, ref.shards, "shards")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(ncols).astype(dtype)
    y0 = rng.standard_normal(nrows).astype(dtype)
    X = rng.standard_normal((ncols, k)).astype(dtype)
    Y0 = rng.standard_normal((nrows, k)).astype(dtype)
    bar = BARS[dtype]
    for alpha, beta in ((1.0, 0.0), (1.3, 0.7)):
        got = spt.matvec_kernel(alpha, A, x, beta, y0).numpy()
        want = alpha * _oracle(nrows, rows, cols, vals, x) + beta * y0
        assert _err(got, want, dtype) < bar
        assert _err(got, np.asarray(ref.matvec(x, alpha, beta, y0)),
                    dtype) < bar
        got = spt.matmat_kernel(alpha, A, X, beta, Y0).numpy()
        want = alpha * _oracle(nrows, rows, cols, vals, X) + beta * Y0
        assert _err(got, want, dtype) < bar
        assert _err(got, np.asarray(ref.matmat(X, alpha, beta, Y0)),
                    dtype) < bar


@pytest.mark.parametrize("nthreads", [2, 3, 4])
@pytest.mark.parametrize("mname", list(MATRICES))
def test_e2e_matrices_in_shards(mname, nthreads):
    """``tests/test_csx_e2e.py``'s matrices in 2-4 shards, float64."""
    nrows, ncols, rows, cols, vals = MATRICES[mname]
    A, ref = _tune(nrows, ncols, rows, cols, vals, nthreads,
                   **{"spx.preproc.xform": "all",
                      "spx.preproc.sampling": "none"})
    assert len(A.csx.executors) == nthreads == A.csx.partition.nparts
    assert isinstance(A.csx._executor(), ShardsExecutor)
    _check(A, ref, nrows, ncols, rows, cols, vals, "float64")
    rr, cc, vv = A.csx.tocoo()
    assert rr.tolist() == rows.tolist() and cc.tolist() == cols.tolist()
    np.testing.assert_array_equal(vv, vals)


@pytest.mark.parametrize("nthreads", [2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_headline_in_shards(dtype, nthreads):
    """bench.py's headline matrix at 2^14 in 2-4 shards; each shard's plan
    holds the executor's own ``row_start``-free arrays (DIA offsets are
    partition-local, as the reference's)."""
    n = 1 << 14
    rows, cols, vals = chip_smoke.build_matrix(n)
    A, ref = _tune(n, n, rows, cols, vals.astype(dtype), nthreads,
                   **{"spx.tpu.value_dtype": dtype,
                      "spx.preproc.xform": "all"})
    _check(A, ref, n, n, rows, cols, vals.astype(dtype), dtype)
    for ex, t in zip(A.csx.executors, A.csx.shards):
        assert ex.nrows == t.nrows and ex.ncols == n


def test_blocky_merged_plans_in_shards(monkeypatch):
    """A small blocky matrix in 2 shards: each shard plans the fused delta,
    two fused run tables (the 4x2 blocks' lane-placed rlp2 and the width-8
    runs, lane-placed rlp8 or, where a shard's runs are too sparse for lane
    placement, the dense-tile run8) and one merged route plan; its SpMM
    runs k-batched in every shard."""
    _thresholds(monkeypatch, MIN_FUSED_NNZ=256, MIN_PAGE_NNZ=1024,
                MIN_ELEMS=64)
    n, rows, cols, vals = _merged_matrix(np.float32)
    A, ref = _tune(n, n, rows, cols, vals, 2,
                   **{"spx.tpu.value_dtype": "float32",
                      "spx.preproc.xform": "all"})
    for ex in A.csx.executors:
        extras = chip_smoke.extras_of(ex.meta)
        assert {"dfused", "fall"} <= set(extras)
        styles = {m[5] for _, m in chip_smoke.fused_runs(ex.meta)}
        assert "rlp2" in styles and styles - {"rlp2"} <= {"rlp8", "run8"}
        assert fused_mm_ok(ex.meta)
    _check(A, ref, n, n, rows, cols, vals, "float32", k=9)


def _mixed_matrix(n=1 << 14, seed=3):
    """Rows [0, n/4) hold 8 random singles each, rows [n/4, n) three
    diagonals: split by nonzeros into 2 shards, the first plans the fused
    delta pipeline, the second only DIA tables (the plain-table
    variant)."""
    rng = np.random.default_rng(seed)
    q = n // 4
    r1 = np.repeat(np.arange(q), 8)
    c1 = rng.integers(0, n, r1.size)
    r2 = np.concatenate([np.arange(q, n)] * 3)
    c2 = np.concatenate([np.arange(q, n) + o for o in (0, 1, -3)])
    rows = np.concatenate([r1, r2])
    cols = np.concatenate([c1, np.clip(c2, 0, n - 1)])
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    return n, rows, cols, rng.standard_normal(rows.size)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_shards_that_plan_differently(dtype):
    """One shard paged (the fused delta pipeline), the other the plain
    tables: the one executor runs both, its SpMM k-batched on the first
    and once per column on the second."""
    n, rows, cols, vals = _mixed_matrix()
    vals = vals.astype(dtype)
    A, ref = _tune(n, n, rows, cols, vals, 2,
                   **{"spx.tpu.value_dtype": dtype,
                      "spx.preproc.xform": "all",
                      "spx.tpu.min_fused_nnz": 4096})
    ex0, ex1 = A.csx.executors
    assert (ex0.variant, ex1.variant) == ("paged", "plain")
    assert fused_mm_ok(ex0.meta) and not fused_mm_ok(ex1.meta)
    _check(A, ref, n, n, rows, cols, vals, dtype, k=10)


@pytest.mark.parametrize("nthreads", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["off", "on"])
def test_symmetric_in_shards(monkeypatch, mode, dtype, nthreads):
    """bench.py's symmetric matrix at 2^14 in 2 and 3 shards: per shard,
    each shard's plan pages and routes both delta streams (``dpagesT`` /
    ``dscatterT``) at its own ``row_start``, and the shards' results are
    summed; the full mirror takes all shards into one executor.  Against
    the reference at the same shard count (its plain per-shard tables) and
    the full oracle."""
    _thresholds(monkeypatch, MIN_PAGE_NNZ=1024, MIN_ELEMS=1024)
    n = 1 << 14
    rows, cols, vals = chip_smoke.build_symmetric_matrix(n)
    vals = vals.astype(dtype)
    _options(**{"spx.rt.nr_threads": nthreads, "spx.tpu.value_dtype": dtype,
                "spx.preproc.xform": "all", "spx.matrix.symmetric": "true",
                "spx.tpu.sym_full": mode})
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    ref = ref_build_sym(n, n, rows, cols, vals)
    assert _parts(A.csx.partition) == _parts(ref.partition)
    assert_same(A.csx.shards, ref.shards, "shards")
    assert_same(A.csx.dvalues, ref.dvalues, "dvalues")
    exs = A.csx.executors
    if mode == "off":
        assert [type(e) for e in exs] == [SymShardExecutor] * nthreads
        assert [e.row_start for e in exs] == A.csx.partition.row_start
        assert any({"dpagesT", "dscatterT"} <= set(chip_smoke.extras_of(
            e.meta)) for e in exs[1:])
    else:
        assert len(exs) == 1 and not isinstance(exs[0], SymShardExecutor)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(n).astype(dtype)
    y0 = rng.standard_normal(n).astype(dtype)
    X = rng.standard_normal((n, 2)).astype(dtype)
    got = spt.matvec_kernel(1.1, A, x, 0.4, y0).numpy()
    want = 1.1 * _oracle(n, rows, cols, vals, x) + 0.4 * y0
    assert _err(got, want, dtype) < BARS[dtype]
    assert _err(got, np.asarray(ref.matvec(x, 1.1, 0.4, y0)),
                dtype) < BARS[dtype]
    got = spt.matmat_mult(1.5, A, X).numpy()
    assert _err(got, 1.5 * _oracle(n, rows, cols, vals, X),
                dtype) < BARS[dtype]


def test_bf16_in_shards():
    """A bf16 matrix in 2 shards computes in float32; a bf16 x gives a bf16
    y within 2e-2 of the oracle on the bf16-rounded values and x, its SpMM
    too."""
    n = 1 << 14
    rows, cols, vals = chip_smoke.build_matrix(n)
    _options(**{"spx.rt.nr_threads": 2, "spx.tpu.value_dtype": "bfloat16",
                "spx.preproc.xform": "all"})
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    assert A.csx._executor().dtype == torch.float32
    vb = torch.from_numpy(vals).bfloat16().double().numpy()
    X = torch.as_tensor(np.random.default_rng(1).standard_normal((n, 3)),
                        dtype=torch.bfloat16)
    y = spt.matvec_mult(1.0, A, X[:, 0].contiguous())
    Y = spt.matmat_mult(1.0, A, X)
    assert y.dtype == Y.dtype == torch.bfloat16
    Xh = X.double().numpy()
    for got, want in ((y.double().numpy(), _oracle(n, rows, cols, vb,
                                                   Xh[:, 0])),
                      (Y.double().numpy(), _oracle(n, rows, cols, vb, Xh))):
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


@pytest.mark.parametrize("nthreads", [1, 3])
def test_measure_load_imbalance_per_shard(nthreads):
    """One time per shard, each shard's eager SpMV on the CPU."""
    n = 1 << 12
    rows, cols, vals = chip_smoke.build_matrix(n)
    _options(**{"spx.rt.nr_threads": nthreads})
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    secs, imb = A.csx.measure_load_imbalance(loops=2, outer=3)
    assert len(secs) == nthreads and all(s > 0 for s in secs)
    assert imb >= 0.0 and (nthreads > 1 or imb == 0.0)
