"""Symmetric matrices (CSX-Sym) on sparsex_tpu_torch, on the CPU.

``spt.mat_tune`` under ``spx.matrix.symmetric`` tunes the lower triangle
and the diagonal (``symmetric.build_symmetric_csx``) and runs it in the
mode ``spx.tpu.sym_full`` selects: the full mirror (``on``,
``mirror_full_tables`` on the port's main path) or per shard (``off``:
``local_contrib(..., symmetric=True)``, the transposed paged delta stream
``dpagesT`` through the delta-pages kernel and its scatter route
``dscatterT`` or the kernel's scatter epilogue).  Each case tunes one
symmetric matrix with both packages under the same options and planner
thresholds:

- plan parity: the port's lower-triangle tables, ``mirror_full_tables``
  and per-shard plans (``_sym_paged``: metas and arrays) equal the
  reference's, array for array (the reference pages float32 only, so its
  dtype gate is lifted for the float64 cases);
- the SpMV (alpha = 1.1, beta = 0.4 with a y) and a k = 3 SpMM in both
  modes against the reference's ``SymCsxMatrix.matvec`` / ``matmat``
  (plain per-shard variant on the CPU; one case through its paged variant
  with the Pallas kernels in interpret mode) and a float64 COO oracle of
  the full matrix, within 1e-10 in float64 and ``chip_smoke.CHECK_TOL``
  (2e-4) in float32 (max |y - ref| / max |ref|);
- chip_smoke's kernel phase and launch counts on a per-shard plan, and
  the upload's checks of the transposed stream;
- a symmetric MMF read as its lower triangle;
- the refusals: an unsymmetric pattern, and ``spx.rt.nr_threads = 2``.

Inputs: bench.py's symmetric matrix (``chip_smoke.build_symmetric_matrix``)
at 2^12 and 2^14 rows with the page and route gates lowered (both streams
routed; routed with leftovers; both through the epilogue), the symmetric
HPCG stencil at 16^3 (13 lower diagonals per shard, 27 mirrored), a
symmetric matrix of width-6 horizontal runs and 4x2 blocks, a band with
a full anti-diagonal (an anti-diagonal DIA table), and
``tests/test_symmetric.py``'s inputs.
"""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import sparsex_tpu.ops.pallas_kernels as pk
from sparsex_tpu.config import Config as RefConfig
from sparsex_tpu.ops import route as route_mod
from sparsex_tpu.symmetric import build_symmetric_csx as ref_build
from sparsex_tpu.symmetric import mirror_full_tables as ref_mirror
import sparsex_tpu_torch as spt
from sparsex_tpu_torch import symmetric as tsym
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import kernels as tk
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from test_torch_pages import record_calls
from test_torch_plan import assert_same
from tests import fixtures

torch.set_num_threads(1)
BARS = {"float32": chip_smoke.CHECK_TOL, "float64": 1e-10}


@pytest.fixture(autouse=True)
def fresh_port_config():
    """The port's Config is its own singleton: reset it around every test,
    as tests/conftest.py resets the reference's."""
    spt.Config.reset()
    yield
    spt.Config.reset()


def _gates(monkeypatch, page_nnz=None, elems=None):
    """The paged and routed planners' gates, alike on both packages, and
    the reference's float32-only page gate lifted (the port pages any
    type)."""
    for mod, name, value in ((pk, "MIN_PAGE_NNZ", page_nnz),
                             (tpk, "MIN_PAGE_NNZ", page_nnz),
                             (route_mod, "MIN_ELEMS", elems),
                             (troute, "MIN_ELEMS", elems)):
        if value is not None:
            monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(pk, "pallas_dtype_ok", lambda dtype: True)


def _full(rows, cols, vals):
    """The full COO of a lower triangle and diagonal, sorted."""
    strict = rows > cols
    r = np.concatenate([rows, cols[strict]])
    c = np.concatenate([cols, rows[strict]])
    v = np.concatenate([vals, vals[strict]])
    order = np.lexsort((c, r))
    return r[order], c[order], v[order]


def _bench(n):
    return (n,) + chip_smoke.build_symmetric_matrix(n)


def _hpcg(nx):
    return chip_smoke.hpcg_matrix(nx)


def _runs_blocks(n, seed=2):
    """n/16 width-6 horizontal runs and n/8 4x2 blocks (as bench.py's
    blocky matrix has) in the strict lower triangle, a diagonal and
    singles, mirrored."""
    rng = np.random.default_rng(seed)
    m = n // 16
    hr = rng.integers(64, n, m)
    hc = rng.integers(0, hr - 6)
    br = rng.integers(8, n // 4, 2 * m) * 4
    bc = rng.integers(0, br // 2 - 1) * 2
    ii, jj = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
    rows = np.concatenate([np.repeat(hr, 6),
                           (br[:, None, None] + ii).ravel(), np.arange(n),
                           rng.integers(1, n, m)])
    cols = np.concatenate([(hc[:, None] + np.arange(6)).ravel(),
                           (bc[:, None, None] + jj).ravel(), np.arange(n),
                           np.zeros(m, np.int64)])
    cols[-m:] = rng.integers(0, rows[-m:])
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    vals = rng.standard_normal(rows.size) + 0.5
    return (n,) + _full(rows, cols, vals)


def _anti_band(n=1024):
    """The diagonal, the first sub- and superdiagonal and the full
    anti-diagonal s = n - 1, symmetric values: per shard a DIA table and
    an anti-diagonal one (its transposed windows reversed)."""
    r = np.arange(n)
    rows = np.concatenate([r, r, r[1:], r[:-1]])
    cols = np.concatenate([r, n - 1 - r, r[1:] - 1, r[:-1] + 1])
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    key = np.minimum(rows, cols) * n + np.maximum(rows, cols)
    return n, rows, cols, np.sin(key.astype(np.float64)) + 1.5


def _fixture(n, seed):
    nr, _nc, rows, cols, vals = fixtures.symmetric_coo(n=n, seed=seed)
    return nr, rows, cols, vals


def _banded(n=150):
    """tests/test_symmetric.py's banded matrix (diagonals 0, 1, 5)."""
    rows, cols = [], []
    for b in (0, 1, 5):
        r = np.arange(b, n, dtype=np.int64)
        rows.append(r)
        cols.append(r - b)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.random.default_rng(8).standard_normal(rows.size) + 1.0
    return (n,) + _full(rows, cols, vals)


def _structure(n=64):
    """tests/test_symmetric.py's structure matrix: a horizontal run, a 2x2
    block, an anti-diagonal run and singles in the lower triangle."""
    entries = {(40, c) for c in range(2, 10)}
    entries |= {(r, c) for r in (50, 51) for c in (4, 5)}
    entries |= {(30 + i, 10 - i) for i in range(5)}
    entries |= {(20, 3), (60, 33)}
    low = np.array(sorted(entries))
    vals = np.arange(1.0, low.shape[0] + 1.0)
    rows = np.concatenate([low[:, 0], low[:, 1]])
    cols = np.concatenate([low[:, 1], low[:, 0]])
    order = np.lexsort((cols, rows))
    return (n, rows[order], cols[order],
            np.concatenate([vals, vals])[order])


# name -> (matrix, xform, (MIN_PAGE_NNZ, MIN_ELEMS), the per-shard plan's
# extras)
CASES = {
    "bench_2^12": (lambda: _bench(1 << 12), "all", (256, 256),
                   {"dpages", "dpagesT", "dscatter", "dscatterT"}),
    "bench_2^14": (lambda: _bench(1 << 14), "all", (1024, 1024),
                   {"dpages", "dpagesT", "dscatter", "dscatterT"}),
    "bench_2^14_epilogue": (lambda: _bench(1 << 14), "all",
                            (1024, 1 << 30), {"dpages", "dpagesT"}),
    "hpcg_16^3": (lambda: _hpcg(16), "all", (None, None), set()),
    # sampled, the stencil leaves singles: the direct stream unrouted (the
    # scatter epilogue), the transposed one routed
    "hpcg_16^3_sampled": (lambda: _hpcg(16), "all", (None, None),
                          {"dpages", "dpagesT", "dscatterT"}),
    "runs_blocks": (lambda: _runs_blocks(1 << 12), "all", (256, 1 << 30),
                    {"dpages", "dpagesT"}),
    "fixture_none": (lambda: _fixture(60, 3), "none", (None, None), set()),
    "fixture_h": (lambda: _fixture(60, 3), "h", (None, None), set()),
    "fixture_v": (lambda: _fixture(60, 3), "v", (None, None), set()),
    "fixture_all": (lambda: _fixture(60, 3), "all", (None, None), set()),
    "very_sparse": (lambda: _fixture(40, 11), "all", (None, None), set()),
    "banded": (_banded, "all", (None, None), set()),
    "anti_band": (_anti_band, "all", (None, None), set()),
    "structure": (_structure, "all", (None, None), set()),
    "spmm_fixture": (lambda: _fixture(70, 6), "all", (None, None), set()),
}


def _tune(monkeypatch, case, dtype, mode):
    """(n, full rows, cols, vals, the port's matrix on the CPU, the
    reference's) of a case, both tuned under the same options."""
    build, xform, (page_nnz, elems), _extras = CASES[case]
    _gates(monkeypatch, page_nnz, elems)
    n, rows, cols, vals = build()
    vals = np.asarray(vals).astype(dtype)
    opts = {"spx.tpu.value_dtype": dtype, "spx.preproc.xform": xform,
            "spx.preproc.sampling": "none" if case == "hpcg_16^3"
            else "portion",
            "spx.matrix.symmetric": "true", "spx.tpu.sym_full": mode}
    for cfg in (spt.Config.instance(), RefConfig.instance()):
        for key, value in opts.items():
            cfg.set(key, value)
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    ref = ref_build(n, n, rows, cols, vals)
    return n, rows, cols, vals, A, ref


def _oracle(n, rows, cols, vals, x):
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        return np.bincount(rows, weights=np.asarray(vals, np.float64)
                           * x[cols], minlength=n)
    return np.stack([_oracle(n, rows, cols, vals, x[:, j])
                     for j in range(x.shape[1])], axis=1)


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    return (np.abs(np.asarray(got, dtype=np.float64) - want).max()
            / np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plans_equal_the_reference(monkeypatch, case, dtype):
    """The lower-triangle tables and diagonal, the mirrored full tables and
    each shard's paged plan equal the reference's."""
    _n, _r, _c, _v, A, ref = _tune(monkeypatch, case, dtype, "off")
    csx = A.csx
    assert_same(csx.shards, ref.shards, "shards")
    assert_same(csx.dvalues, ref.dvalues, "dvalues")
    full = tsym.mirror_full_tables(csx.shards, csx.dvalues, csx.nrows,
                                   csx.ncols)
    assert_same(full, ref_mirror(ref.shards, ref.dvalues, ref.nrows,
                                 ref.ncols), "mirror")
    ref._build_sym_arrays()
    csx._build_sym_arrays()
    assert_same(csx._sym_paged, ref._sym_paged, "sym_paged")
    extras = {e[0] for e in csx._sym_paged[0][0][5:]}
    assert extras == CASES[case][3]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["off", "on"])
def test_spmv_matches_reference_and_oracle(monkeypatch, case, dtype, mode):
    """The SpMV with alpha and beta, per shard and as the full mirror,
    against the reference's in the same mode and the full COO oracle."""
    n, rows, cols, vals, A, ref = _tune(monkeypatch, case, dtype, mode)
    ex = A.csx.executors[0]
    assert isinstance(ex, tsym.SymShardExecutor) == (mode == "off")
    rng = np.random.default_rng(3)
    x = rng.standard_normal(n).astype(dtype)
    y0 = rng.standard_normal(n).astype(dtype)
    before = tf.launch_counts()
    got = spt.matvec_kernel(1.1, A, x, 0.4, y0).numpy()
    assert tf.launch_counts() == before            # no launch on the CPU
    want = np.asarray(ref.matvec(jnp.asarray(x), alpha=1.1, beta=0.4,
                                 y=jnp.asarray(y0)))
    assert got.shape == (n,) and got.dtype == np.dtype(dtype)
    assert _rel(got, want) < BARS[dtype]
    assert _rel(got, 1.1 * _oracle(n, rows, cols, vals, x)
                + 0.4 * y0.astype(np.float64)) < BARS[dtype]


@pytest.mark.parametrize("case", ["bench_2^12", "bench_2^14_epilogue",
                                  "hpcg_16^3", "runs_blocks",
                                  "spmm_fixture"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["off", "on"])
def test_spmm_matches_reference_and_oracle(monkeypatch, case, dtype, mode):
    """A k = 3 SpMM (per shard: the SpMV once per column) against the
    reference's and the oracle."""
    n, rows, cols, vals, A, ref = _tune(monkeypatch, case, dtype, mode)
    X = np.random.default_rng(6).standard_normal((n, 3)).astype(dtype)
    got = spt.matmat_mult(1.5, A, X).numpy()
    want = np.asarray(ref.matmat(jnp.asarray(X), alpha=1.5))
    assert got.shape == (n, 3)
    assert _rel(got, want) < BARS[dtype]
    assert _rel(got, 1.5 * _oracle(n, rows, cols, vals, X)) < BARS[dtype]
    per_column = np.stack([spt.matvec_mult(1.5, A, X[:, j].copy()).numpy()
                           for j in range(3)], axis=1)
    if mode == "off":
        assert np.array_equal(got, per_column)


def test_paged_shard_matches_the_reference_paged(monkeypatch):
    """The reference's paged per-shard variant (its delta-pages Pallas
    kernel in interpret mode, both streams routed) against the port's on
    the same plan, float32."""
    n, rows, cols, vals, A, ref = _tune(monkeypatch, "bench_2^12",
                                        "float32", "off")
    monkeypatch.setattr(pk, "dia_pallas_ok", lambda: True)
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref.matvec(jnp.asarray(x)))
    assert hasattr(ref, "_sym_dev_paged")          # the paged variant ran
    got = spt.matvec_mult(1.0, A, x).numpy()
    assert _rel(got, want) < 1e-5
    assert _rel(got, _oracle(n, rows, cols, vals, x)) < 1e-5


@pytest.mark.parametrize("case", ["bench_2^14", "bench_2^14_epilogue",
                                  "hpcg_16^3_sampled", "runs_blocks"])
def test_chip_smoke_phase_on_a_shard_plan(monkeypatch, case):
    """chip_smoke's plan description, kernel phase and launch counts on a
    per-shard plan: the phase calls the delta-pages wrappers with what the
    SpMV gives them (the scatter epilogue on a stream without a route; on
    a routed transposed stream, off the path, its rows planned again) and
    every lane gather of both routes; the counts it derives from the plan
    are the SpMV's calls."""
    n, *_rest, A, _ref = _tune(monkeypatch, case, "float64", "off")
    ex = A.csx.executors[0]
    calls = []
    wrappers = ((tpk, "delta_pages", "delta_pages"),
                (tpk, "delta_pages_acc", "delta_pages_acc"),
                (tpk, "dia", "dia"),
                (troute, "lane_gather", "lane_gather"))
    record_calls(monkeypatch, wrappers, calls)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    ex(x)
    path = list(calls)
    calls.clear()
    res = chip_smoke.kernel_phase(ex, x, "cpu", timed=False)
    extras = chip_smoke.extras_of(ex.meta)
    off_path = [c for c in calls if c not in path]
    if {"dscatter", "dscatterT"} <= set(extras):   # no epilogue on the path
        assert [c[0] for c in off_path] == ["delta_pages_acc"]
    else:
        assert off_path == []
    assert set(path) <= set(calls)
    counted = Counter(name for name, _ in path)
    want = chip_smoke.expected_counts(ex.meta)
    assert {k: v for k, v in want.items() if v} == dict(counted)
    assert set(res) == set(counted) | {c[0] for c in off_path}


def test_chip_smoke_rows_of_a_routed_transposed_stream(monkeypatch):
    """chip_smoke plans the transposed stream's rows again for its
    off-path epilogue check: the rows of the unrouted plan."""
    *_rest, A, _ref = _tune(monkeypatch, "bench_2^14", "float32", "off")
    rows = chip_smoke.transposed_rows(A.csx.executors[0])
    monkeypatch.setattr(troute, "MIN_ELEMS", 1 << 30)
    (meta, host), = [tsym.shard_plan(t, A.nrows, A.ncols)
                     for t in A.csx.shards]
    assert "dscatterT" not in {e[0] for e in meta[5:]}
    assert np.array_equal(rows.numpy(), host["delta_pages_t"]["rows"])


def test_sym_plan_checks(monkeypatch):
    """chip_smoke's symmetric plan checks pass on both modes of the HPCG
    stencil (27 mirrored diagonals; 13 lower ones and the diagonal), and
    the per-shard SpMV's local_contrib returns the lower part and the
    mirror apart."""
    n, rows, cols, vals, A, _ref = _tune(monkeypatch, "hpcg_16^3",
                                         "float64", "on")
    mat = SimpleNamespace(csx=A.csx, nnz=A.nnz)
    ex = chip_smoke.check_sym_plan("hpcg")(mat, "full")
    assert ex.meta[4][0][2] == 27
    spt.Config.instance().set("spx.tpu.sym_full", "off")
    A.csx._executor()
    ex = chip_smoke.check_sym_plan("hpcg")(mat, "per-shard")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(n))
    acc, z = tk.local_contrib(ex.meta, ex.arrays, x, nrows_part=n, ncols=n,
                              symmetric=True)
    lower = rows >= cols
    assert _rel((acc + z).numpy(), _oracle(n, rows, cols, vals,
                                           x.numpy())) < 1e-12
    assert _rel(acc.numpy(), _oracle(n, rows[lower], cols[lower],
                                     vals[lower], x.numpy())) < 1e-12


def test_refusals():
    """An unsymmetric pattern is refused (SPX_ERR_INPUT_MAT); two shards
    (ROADMAP Queue 1 item 5) tune and run against the oracle,
    and a class no planner of the port makes, the reference's stacked
    sharded delta of several devices, is refused by name."""
    n, rows, cols, vals = _structure()
    keep = rows != 40
    cfg = spt.Config.instance()
    cfg.set("spx.matrix.symmetric", "true")
    with pytest.raises(spt.SparsexError) as ei:
        spt.mat_tune(chip_smoke.csr_input(spt, rows[keep], cols[keep],
                                          vals[keep], n), device="cpu")
    assert ei.value.code == spt.ErrorCode.SPX_ERR_INPUT_MAT
    cfg.set("spx.rt.nr_threads", "2")
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    assert [type(e) for e in A.csx.executors] == [tsym.SymShardExecutor] * 2
    x = np.random.default_rng(2).standard_normal(n)
    assert _rel(spt.matvec_mult(1.0, A, x).numpy(),
                _oracle(n, rows, cols, vals, x)) < 1e-12
    with pytest.raises(NotImplementedError, match="'dsfused'"):
        tk.check_slice((n, n, (), (), (), ("dsfused", None)))


@pytest.mark.parametrize("case", ["bench_2^14_epilogue", "bench_2^12"])
def test_upload_checks_the_transposed_stream(monkeypatch, case):
    """The delta-pages kernels read x2 unchecked and the transposed stream
    scatters into every row: the upload refuses a ``dpagesT`` window
    outside its page grid, a row past its sentinel ``nrows``, and a
    ``dscatterT`` residual outside the rows; the plan as made uploads."""
    from sparsex_tpu_torch.ops import convert
    n, *_rest, A, _ref = _tune(monkeypatch, case, "float32", "off")
    A.csx._build_sym_arrays()
    (meta, host), = A.csx._sym_paged
    rep = host["delta_pages_t"]
    plo = rep["plo"]
    rep["plo"] = plo.copy()
    rep["plo"][-1] = 1 << 20
    with pytest.raises(ValueError, match="delta_pages_t plo: windows"):
        convert.plan_to_torch(meta, host, "cpu", torch.float32)
    rep["plo"] = plo
    if "rows" in rep:
        rows = rep["rows"]
        assert rows.max() == n          # the padding slots' sentinel
        rep["rows"] = rows.copy()
        rep["rows"][0] = n + 1
        with pytest.raises(ValueError, match="delta_pages_t rows"):
            convert.plan_to_torch(meta, host, "cpu", torch.float32)
        rep["rows"] = rows
    else:
        res = host["delta_scatter_t"]
        res_dest = res["res_dest"]
        res["res_dest"] = res_dest.copy()
        res["res_dest"][...] = n
        with pytest.raises(ValueError, match="delta_scatter_t: residuals"):
            convert.plan_to_torch(meta, host, "cpu", torch.float32)
        res["res_dest"] = res_dest
    up = convert.plan_to_torch(meta, host, "cpu", torch.float32)
    assert set(up) >= {"delta_pages_t", "delta_t", "dias"}


@pytest.mark.parametrize("mode", ["off", "on"])
def test_mmf_stored_as_lower_triangle(tmp_path, mode):
    """A symmetric MMF is read as its lower triangle (``keep_lower``) and
    tuned as it is (``already_lower``, api.py:148-153), against the
    oracle of the full matrix in both modes."""
    n, _nc, rows, cols, vals = fixtures.symmetric_coo(n=60, seed=3)
    low = rows >= cols
    path = str(tmp_path / "sym.mtx")
    fixtures.write_mmf(path, n, n, rows[low], cols[low], vals[low],
                       banner="%%MatrixMarket matrix coordinate real "
                              "symmetric")
    cfg = spt.Config.instance()
    cfg.set("spx.matrix.symmetric", "true")
    cfg.set("spx.tpu.sym_full", mode)
    inp = spt.input_load_mmf(path)
    assert inp.mmf.stored_lower_only
    A = spt.mat_tune(inp, device="cpu")
    assert A.nnz == int(low.sum())
    x = np.random.default_rng(0).standard_normal(n)
    got = spt.matvec_mult(1.0, A, x).numpy()
    assert _rel(got, _oracle(n, rows, cols, vals, x)) < 1e-10
