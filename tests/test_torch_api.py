"""The public API of sparsex_tpu_torch on the CPU, against the JAX package.

One port case for each test of ``tests/test_api.py`` (the reference C
library's ``sparsex_test.c`` walkthrough), with ``device="cpu"``; then the
API the port gained with its several-shard slice, each held against the
JAX package on the same input:

- the exported names (the reference's ``__all__`` less ``spgemm``);
- entries: ``mat_get_entry`` of every stored entry and ``tocoo`` equal to
  the reference's, in 1 and 2 shards, symmetric included; ``set_entry``
  writes the host tables at once and the next SpMV plans and uploads the
  written shards again, once for a sweep of 1000 writes; a symmetric
  write drops the mirrored executor; a bf16 matrix rounds the new value;
- archives (``mat_save`` / ``mat_restore``) in float32, float64, bf16 and
  symmetric: the port's archive equal to the reference's array for array
  (keys, dtypes, values, metadata), and archives crossing both ways with
  equal SpMVs; a layout whose fused run's route instances overlap outside
  a merged plan, saved by the JAX package, planned again at restore;
- ``partition_csr`` and the ``vec`` ops against the reference's.
"""

import json

import numpy as np
import pytest
import torch

import sparsex_tpu as ref
import sparsex_tpu.ops.fused as fused
import sparsex_tpu.ops.pallas_kernels as pk
from sparsex_tpu.io.csr import csr_from_coo
from sparsex_tpu.ops import route as route_mod
from sparsex_tpu.ops.oracle import coo_spmv, max_rel_error

import chip_smoke
import sparsex_tpu_torch as spt
from sparsex_tpu_torch import persist
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.kernels import unmerged_overlapping_runs
from tests import fixtures

torch.set_num_threads(1)
TOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_port_config():
    spt.Config.reset()
    spt.matvec_kernel_csr_invalidate()
    yield
    spt.Config.reset()
    spt.matvec_kernel_csr_invalidate()


def _options(**options):
    for cfg in (spt.Config.instance(), ref.Config.instance()):
        for key, value in options.items():
            cfg.set(key, str(value))


def _y(v):
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


# ---------------------------------------------------------------------------
# tests/test_api.py, on the port
# ---------------------------------------------------------------------------

def test_full_api_walkthrough_mmf(tmp_path):
    """load MMF -> tune -> repeated matvec_mult -> check vs oracle ->
    destroy (tests/test_api.py:14)."""
    spt.init()
    nrows, ncols, rows, cols, vals = fixtures.random_coo(50, 50, seed=9)
    path = str(tmp_path / "m.mtx")
    fixtures.write_mmf(path, nrows, ncols, rows, cols, vals)
    inp = spt.input_load_mmf(path)
    mat = spt.mat_tune(inp, device="cpu")
    assert (mat.nrows, mat.ncols, mat.nnz) == (nrows, ncols, rows.size)
    x = np.random.default_rng(0).standard_normal(ncols)
    for _ in range(8):
        y = spt.matvec_mult(2.0, mat, x)
    want = 2.0 * coo_spmv(nrows, rows, cols, vals, x)
    assert max_rel_error(_y(y), want) <= TOL
    csx = mat.csx
    spt.input_destroy(inp)
    spt.mat_destroy(mat)
    assert inp.mmf is None and mat.csx is None and csx.executors == []
    spt.finalize()


def test_csr_input_and_partition():
    """matvec_kernel with alpha and beta; partition_csr equal to the
    reference's (tests/test_api.py:39)."""
    nrows, ncols, rows, cols, vals = fixtures.banded_coo()
    csr = csr_from_coo(nrows, ncols, rows, cols, vals)
    inp = spt.input_load_csr(csr.rowptr, csr.colind, csr.values, nrows,
                             ncols)
    mat = spt.mat_tune(inp, device="cpu")
    x = np.arange(ncols, dtype=np.float64) / ncols
    y0 = np.ones(nrows)
    got = _y(spt.matvec_kernel(1.5, mat, x, -0.5, y0))
    want = 1.5 * coo_spmv(nrows, rows, cols, vals, x) - 0.5 * y0
    assert max_rel_error(got, want) <= TOL
    for nparts in (1, 3, 4, 7):
        part = spt.partition_csr(csr.rowptr, nrows, nparts)
        rpart = ref.partition_csr(csr.rowptr, nrows, nparts)
        assert isinstance(part, spt.Partition) and part.nrows == nrows
        assert (part.parts.row_start, part.parts.row_end,
                part.parts.nnz_per_part) == (
            rpart.parts.row_start, rpart.parts.row_end,
            rpart.parts.nnz_per_part)
        assert sum(part.parts.nnz_per_part) == rows.size


def test_matvec_kernel_csr_lazy_tune():
    """Tuned at the first call for the buffers, cached after; the LRU
    holds at most 16 and invalidation drops an entry
    (tests/test_api.py:57)."""
    from sparsex_tpu_torch import api
    nrows, ncols, rows, cols, vals = fixtures.random_coo(30, 30, seed=2)
    csr = csr_from_coo(nrows, ncols, rows, cols, vals)
    x = np.random.default_rng(1).standard_normal(ncols)
    y = np.zeros(nrows)
    got = _y(spt.matvec_kernel_csr(csr.rowptr, csr.colind, csr.values,
                                   nrows, ncols, 1.0, x, 0.0, y,
                                   device="cpu"))
    want = coo_spmv(nrows, rows, cols, vals, x)
    assert max_rel_error(got, want) <= TOL
    (entry,) = api._csr_cache.values()
    spt.matvec_kernel_csr(csr.rowptr, csr.colind, csr.values, nrows, ncols,
                          2.0, x, 1.0, y, device="cpu")
    assert list(api._csr_cache.values()) == [entry]
    others = [csr_from_coo(nrows, ncols, rows, cols, vals + i)
              for i in range(17)]
    for c in others:
        spt.matvec_kernel_csr(c.rowptr, c.colind, c.values, nrows, ncols,
                              1.0, x, 0.0, y, device="cpu")
    assert len(api._csr_cache) == api._CSR_CACHE_MAX
    last = others[-1]
    spt.matvec_kernel_csr_invalidate(last.rowptr, last.colind, last.values)
    assert len(api._csr_cache) == api._CSR_CACHE_MAX - 1


def test_mat_save_restore_api(tmp_path):
    """Save, restore onto the CPU, set an entry of the restored matrix
    (tests/test_api.py:67)."""
    nrows, ncols, rows, cols, vals = fixtures.blocky_coo()
    csr = csr_from_coo(nrows, ncols, rows, cols, vals)
    inp = spt.input_load_csr(csr.rowptr, csr.colind, csr.values, nrows,
                             ncols)
    mat = spt.mat_tune(inp, device="cpu")
    path = str(tmp_path / "cache.npz")
    spt.mat_save(mat, path)
    mat2 = spt.mat_restore(path, device="cpu")
    x = np.random.default_rng(3).standard_normal(ncols)
    np.testing.assert_allclose(_y(spt.matvec_mult(1.0, mat, x)),
                               _y(spt.matvec_mult(1.0, mat2, x)),
                               rtol=1e-12)
    r, c = int(rows[0]), int(cols[0])
    spt.mat_set_entry(mat2, r, c, 7.5)
    assert spt.mat_get_entry(mat2, r, c) == pytest.approx(7.5)


def test_reorder_flag(tmp_path):
    """OP_REORDER: the SpMV in the RCM order, vec.reorder / inv_reorder
    around it (tests/test_api.py:87)."""
    spt.option_set("spx.preproc.xform", "all")
    nrows, ncols, rows, cols, vals = fixtures.symmetric_coo(n=50, seed=13)
    path = str(tmp_path / "s.mtx")
    fixtures.write_mmf(path, nrows, ncols, rows, cols, vals)
    inp = spt.input_load_mmf(path)
    mat = spt.mat_tune(inp, spt.OP_REORDER, device="cpu")
    perm = mat.permutation
    assert perm is not None
    x = np.random.default_rng(4).standard_normal(ncols)
    got = spt.matvec_mult(1.0, mat, spt.vec.reorder(torch.as_tensor(x),
                                                     perm))
    got = _y(spt.vec.inv_reorder(got, perm))
    want = coo_spmv(nrows, rows, cols, vals, x)
    assert max_rel_error(got, want) <= TOL


def test_vector_ops():
    """(tests/test_api.py:104), each op also equal to the reference's."""
    v1 = spt.vec.create(5, device="cpu")
    assert torch.all(v1 == 0) and v1.dtype == torch.float64
    v1 = spt.vec.init(v1, 2.0)
    v2 = spt.vec.create_random(5, seed=0, device="cpu")
    assert spt.vec.compare(spt.vec.add(v1, v2), 2.0 + v2)
    assert spt.vec.compare(spt.vec.sub(v1, v1), torch.zeros(5))
    assert float(spt.vec.mul(v1, v1)) == pytest.approx(20.0)
    assert spt.vec.compare(spt.vec.scale(v1, 3.0), 6.0 * torch.ones(5))
    s = spt.vec.scale_add(v1, v2, 0.5)
    assert spt.vec.compare(s, 2.0 + 0.5 * v2)
    perm = np.array([2, 0, 1, 4, 3])
    r = spt.vec.reorder(v2, perm)
    assert spt.vec.compare(spt.vec.inv_reorder(r, perm), v2)
    a, b = v2.numpy(), np.arange(5.0)
    for name, args in (("add", (b,)), ("sub", (b,)), ("scale", (1.7,)),
                       ("scale_add", (b, -0.3)), ("reorder", (perm,)),
                       ("inv_reorder", (perm,))):
        got = getattr(spt.vec, name)(torch.as_tensor(a), *args)
        want = getattr(ref.vec, name)(a, *args)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert spt.vec.compare(a, a * (1 + 5e-7)) == ref.vec.compare(
        a, a * (1 + 5e-7)) is True
    assert spt.vec.compare(a, a * (1 + 2e-6)) == ref.vec.compare(
        a, a * (1 + 2e-6)) is False
    g = torch.Generator().manual_seed(7)
    u = spt.vec.create_random(1000, -1.0, 1.0, dtype=torch.float32,
                              device="cpu", generator=g)
    assert u.dtype == torch.float32 and -1 <= u.min() and u.max() < 1


def test_symmetric_mmf_api(tmp_path):
    """Symmetric option and an MMF symmetric file end to end
    (tests/test_api.py:122)."""
    from sparsex_tpu_torch.io.mmf import load_mmf
    text = fixtures.symmetric_mmf_text(n=8, seed=4)
    path = str(tmp_path / "sym.mtx")
    with open(path, "w") as fp:
        fp.write(text)
    spt.option_set("spx.matrix.symmetric", "true")
    mat = spt.mat_tune(spt.input_load_mmf(path), device="cpu")
    full = load_mmf(path)
    x = np.random.default_rng(5).standard_normal(8)
    got = _y(spt.matvec_mult(1.0, mat, x))
    want = coo_spmv(8, full.rows, full.cols, full.vals, x)
    assert max_rel_error(got, want) <= TOL


def test_symmetric_flag_on_unsymmetric_mmf_fails(tmp_path):
    """(tests/test_api.py:141)"""
    nrows, ncols, rows, cols, vals = fixtures.random_coo(20, 20, seed=6)
    path = str(tmp_path / "g.mtx")
    fixtures.write_mmf(path, nrows, ncols, rows, cols, vals)
    spt.option_set("spx.matrix.symmetric", "true")
    with pytest.raises(spt.SparsexError):
        spt.mat_tune(spt.input_load_mmf(path), device="cpu")


def test_vector_part_ops_and_copy():
    """spx_vec_{add,sub,mul}_part, copy, init_rand_range
    (tests/test_api.py:151), the part ops equal to the reference's."""
    vec = spt.vec
    a = torch.arange(10, dtype=torch.float64)
    b = torch.full((10,), 2.0, dtype=torch.float64)
    out = vec.add_part(a, b, 2, 5)
    assert torch.allclose(out[2:5], a[2:5] + 2.0)
    assert torch.equal(out[:2], a[:2]) and torch.equal(out[5:], a[5:])
    out = vec.sub_part(a, b, 0, 3)
    assert torch.equal(out[:3], a[:3] - 2.0) and torch.equal(out[3:], a[3:])
    assert vec.mul_part(a, b, 1, 4) == ref.vec.mul_part(a.numpy(),
                                                        b.numpy(), 1, 4)
    for name, args in (("add_part", (2, 5)), ("sub_part", (0, 3)),
                       ("scale_add_part", (0.5, 1, 7))):
        np.testing.assert_array_equal(
            getattr(vec, name)(a, b, *args).numpy(),
            getattr(ref.vec, name)(a.numpy(), b.numpy(), *args))
    c = vec.copy(a)
    c[0] = 99
    assert a[0] == 0
    v = torch.zeros(100, dtype=torch.float64)
    vec.init_rand_range(v, 3.0, 7.0, seed=1)
    assert v.min() >= 3.0 and v.max() < 7.0
    w = vec.create_interleaved(16, device="cpu")
    assert w.shape == (16,) and torch.all(w == 0)
    bufs = [torch.zeros(4), torch.ones(4)]
    vec.init_from_map(bufs, 5.0, [(0, 1), (1, 3)])
    assert bufs[0].tolist() == [0, 5, 0, 0] and bufs[1].tolist() == [1, 1,
                                                                     1, 5]
    assert vec.add_from_map(torch.zeros(4), bufs, [(0, 1), (1, 3)]
                            ).tolist() == [0, 5, 0, 5]


def test_measure_load_imbalance():
    """Per-shard seconds and the imbalance (tests/test_api.py:178)."""
    spt.Config.reset().set("spx.rt.nr_threads", "2")
    rng = np.random.default_rng(0)
    n = 1024
    rows = rng.integers(0, n, 4000)
    cols = rng.integers(0, n, 4000)
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    mat = spt.mat_tune(chip_smoke.csr_input(
        spt, rows, cols, rng.standard_normal(rows.size), n), device="cpu")
    secs, imb = mat.csx.measure_load_imbalance(loops=8)
    assert len(secs) == 2 and all(s > 0 for s in secs)
    assert imb >= 0.0


# ---------------------------------------------------------------------------
# the exported surface
# ---------------------------------------------------------------------------

def test_exports_match_the_reference(monkeypatch):
    """Every name of the reference's ``__all__`` but ``spgemm`` (ROADMAP
    Queue 1 item 12); the error handler and the environment options."""
    assert set(ref.__all__) - set(spt.__all__) == {"spgemm"}
    assert all(hasattr(spt, name) for name in spt.__all__)
    seen = []
    old = spt.set_error_handler(lambda *a: seen.append(a[0]))
    try:
        with pytest.raises(spt.SparsexError):
            spt.option_set("spx.no.such.option", "1")
    finally:
        spt.set_error_handler(old)
    monkeypatch.setenv("NUM_THREADS", "3")
    spt.options_set_from_env()
    assert spt.option_get("spx.rt.nr_threads") == "3"


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------

ENTRY_CASES = {
    "pattern10": fixtures.pattern10,
    "banded": fixtures.banded_coo,
    "blocky": fixtures.blocky_coo,
    "headline_2^12": lambda: (1 << 12, 1 << 12) + chip_smoke.build_matrix(
        1 << 12),
}


def _tune_both(nrows, ncols, rows, cols, vals, **options):
    _options(**{"spx.preproc.xform": "all", "spx.preproc.sampling": "none",
                **options})
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, nrows),
                     device="cpu") if nrows == ncols else spt.mat_tune(
        spt.input_load_csr(*_csr(nrows, rows, cols, vals), nrows, ncols),
        device="cpu")
    R = ref.mat_tune(ref.input_load_csr(*_csr(nrows, rows, cols, vals),
                                        nrows, ncols))
    return A, R


def _csr(nrows, rows, cols, vals):
    rowptr = np.zeros(nrows + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=nrows))
    return rowptr, cols, vals


@pytest.mark.parametrize("nthreads", [1, 2])
@pytest.mark.parametrize("case", sorted(ENTRY_CASES))
def test_entries_match_the_reference(case, nthreads):
    """get_entry of every stored entry, a missing entry's error and
    warning, set_entry and tocoo, against the reference."""
    nrows, ncols, rows, cols, vals = ENTRY_CASES[case]()
    A, R = _tune_both(nrows, ncols, rows, cols, vals,
                      **{"spx.rt.nr_threads": nthreads})
    for r, c in zip(rows.tolist(), cols.tolist()):
        assert spt.mat_get_entry(A, r, c) == ref.mat_get_entry(R, r, c)
    taken = set(zip(rows.tolist(), cols.tolist()))
    free = next((r, c) for r in range(nrows) for c in range(ncols)
                if (r, c) not in taken)
    with pytest.raises(spt.SparsexError) as ei:
        spt.mat_get_entry(A, *free)
    assert ei.value.code == spt.ErrorCode.SPX_ERR_ENTRY_NOT_FOUND
    with pytest.raises(spt.SparsexError) as ei:
        spt.mat_get_entry(A, nrows, 0)
    assert ei.value.code == spt.ErrorCode.SPX_ERR_OUT_OF_BOUNDS
    spt.mat_set_entry(A, *free, 1.0)        # a warning, nothing set
    assert A.csx._stale == set()
    pick = np.random.default_rng(1).choice(rows.size, 5, replace=False)
    for i in pick:
        for M, pkg in ((A, spt), (R, ref)):
            pkg.mat_set_entry(M, int(rows[i]), int(cols[i]), -2.5 - i)
    for got, want in zip(A.csx.tocoo(), R.csx.tocoo()):
        np.testing.assert_array_equal(got, want)
    x = np.random.default_rng(2).standard_normal(ncols)
    np.testing.assert_allclose(_y(spt.matvec_mult(1.0, A, x)),
                               np.asarray(ref.matvec_mult(1.0, R, x)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("nthreads", [1, 2])
def test_symmetric_entries_match_the_reference(monkeypatch, mode, nthreads):
    """A symmetric matrix: entries of both triangles and the diagonal,
    the mirrored tocoo, set_entry of a mirror entry and of the diagonal;
    a write drops the mirrored executor at once."""
    n = 1 << 10
    rows, cols, vals = chip_smoke.build_symmetric_matrix(n)
    vals = vals.astype(np.float64)
    _options(**{"spx.preproc.xform": "all", "spx.matrix.symmetric": "true",
                "spx.tpu.sym_full": mode, "spx.rt.nr_threads": nthreads})
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    R = ref.mat_tune(chip_smoke.csr_input(ref, rows, cols, vals, n))
    for i in range(0, rows.size, 7):
        r, c = int(rows[i]), int(cols[i])
        assert spt.mat_get_entry(A, r, c) == ref.mat_get_entry(R, r, c)
    for got, want in zip(A.csx.tocoo(), R.csx.tocoo()):
        np.testing.assert_array_equal(got, want)
    up = int(np.nonzero(cols > rows)[0][-1])
    A.csx._executor()
    for M, pkg in ((A, spt), (R, ref)):
        pkg.mat_set_entry(M, int(rows[up]), int(cols[up]), 3.25)
        pkg.mat_set_entry(M, n - 1, n - 1, -1.5)
    assert A.csx._full_exec is None
    assert spt.mat_get_entry(A, int(cols[up]), int(rows[up])) == 3.25
    assert spt.mat_get_entry(A, n - 1, n - 1) == -1.5
    x = np.random.default_rng(2).standard_normal(n)
    np.testing.assert_allclose(_y(spt.matvec_mult(1.0, A, x)),
                               np.asarray(ref.matvec_mult(1.0, R, x)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("symmetric", [False, True])
def test_set_entry_sweep_plans_once(symmetric):
    """1000 writes to a matrix of two shards plan each written shard once,
    at the next SpMV, which then meets the oracle with the new values."""
    n = 1 << 12
    rows, cols, vals = (chip_smoke.build_symmetric_matrix(n) if symmetric
                        else chip_smoke.build_matrix(n))
    vals = vals.astype(np.float64)
    _options(**{"spx.preproc.xform": "all", "spx.rt.nr_threads": 2,
                "spx.matrix.symmetric": str(symmetric).lower(),
                "spx.tpu.sym_full": "off"})
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    r0 = A.csx.partition.row_start[1]
    idx = np.nonzero(rows >= r0)[0][:1000]
    new = vals.copy()
    for i in idx:
        new[i] = 0.5 + 0.001 * i
        spt.mat_set_entry(A, int(rows[i]), int(cols[i]), new[i])
        if symmetric:    # the mirror entry is the same stored value
            new[(rows == cols[i]) & (cols == rows[i])] = new[i]
    assert A.csx.replans == 0 and A.csx._stale
    x = np.random.default_rng(3).standard_normal(n)
    y = _y(spt.matvec_mult(1.0, A, x))
    assert A.csx.replans == 1
    assert max_rel_error(y, coo_spmv(n, rows, cols, new, x)) <= 1e-12
    spt.matvec_mult(1.0, A, x)
    assert A.csx.replans == 1


def test_set_entry_rounds_a_bf16_value():
    """A bf16 matrix's tables hold bf16-rounded values: a written value is
    rounded the same way, and the next SpMV uses it."""
    n = 1 << 10
    rows, cols, vals = chip_smoke.build_matrix(n)
    spt.Config.reset().set("spx.tpu.value_dtype", "bfloat16")
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    v = 1.0 + 2 ** -12
    spt.mat_set_entry(A, int(rows[3]), int(cols[3]), v)
    got = spt.mat_get_entry(A, int(rows[3]), int(cols[3]))
    assert got == float(torch.tensor(v).bfloat16()) != v


# ---------------------------------------------------------------------------
# archives
# ---------------------------------------------------------------------------

def _archive(path):
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files}
    meta = json.loads(bytes(arrays.pop("meta")).decode("utf-8"))
    return arrays, meta


ARCHIVE_CASES = {
    # name -> (matrix, value type, options)
    "headline_f32": (lambda: chip_smoke.build_matrix(1 << 13), "float32",
                     {}),
    "headline_f64_x2": (lambda: chip_smoke.build_matrix(1 << 13), "float64",
                        {"spx.rt.nr_threads": 2}),
    "blocky_f32_x2": (lambda: chip_smoke.build_blocky_matrix(1 << 13),
                      "float32", {"spx.rt.nr_threads": 2}),
    "symmetric_f64_x2": (lambda: chip_smoke.build_symmetric_matrix(1 << 12),
                         "float64", {"spx.rt.nr_threads": 2,
                                     "spx.matrix.symmetric": "true"}),
}


@pytest.mark.parametrize("case", sorted(ARCHIVE_CASES))
def test_archives_cross_both_ways(tmp_path, case):
    """The port's archive equals the reference's on the same matrix, array
    for array with dtypes, and its metadata; each package restores the
    other's with equal SpMVs."""
    build, dtype, options = ARCHIVE_CASES[case]
    rows, cols, vals = build()
    n = int(rows.max()) + 1
    n = 1 << int(np.ceil(np.log2(n)))
    vals = vals.astype(dtype)
    _options(**{"spx.tpu.value_dtype": dtype, "spx.preproc.xform": "all",
                **options})
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    R = ref.mat_tune(chip_smoke.csr_input(ref, rows, cols, vals, n))
    pa, pr = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    spt.mat_save(A, pa)
    ref.mat_save(R, pr)
    (aa, am), (ra, rm) = _archive(pa), _archive(pr)
    assert am == rm
    assert aa.keys() == ra.keys()
    for k in ra:
        assert aa[k].dtype == ra[k].dtype, k
        np.testing.assert_array_equal(aa[k], ra[k], err_msg=k)
    x = np.random.default_rng(1).standard_normal(n).astype(dtype)
    want = _y(spt.matvec_mult(1.0, A, x))
    for path in (pa, pr):
        B = spt.mat_restore(path, device="cpu")
        assert type(B.csx) is type(A.csx)
        np.testing.assert_array_equal(_y(spt.matvec_mult(1.0, B, x)), want)
        S = ref.mat_restore(path)
        np.testing.assert_allclose(np.asarray(ref.matvec_mult(1.0, S, x)),
                                   want, rtol=1e-5 if dtype == "float32"
                                   else 1e-12, atol=1e-6)


def test_bf16_archives(tmp_path):
    """A bf16 matrix's values go into the archive as the 2-byte bf16
    patterns the reference's bf16 tables save as (``|V2``); the port
    restores its own archive and the reference's to its bf16-rounded f32
    tables, with the SpMV of the matrix it saved.  (The reference cannot
    restore a bf16 archive: ROADMAP Queue 3, "Not port faults".)"""
    import ml_dtypes  # noqa: F401  (the reference's bf16 dtype)
    n = 1 << 12
    rows, cols, vals = chip_smoke.build_matrix(n)
    _options(**{"spx.tpu.value_dtype": "bfloat16",
                "spx.preproc.xform": "all"})
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    R = ref.mat_tune(chip_smoke.csr_input(ref, rows, cols, vals, n))
    pa, pr = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    spt.mat_save(A, pa)
    ref.mat_save(R, pr)
    (aa, am), (ra, rm) = _archive(pa), _archive(pr)
    assert am == rm and aa.keys() == ra.keys()
    for k in ra:
        assert aa[k].dtype == ra[k].dtype, k
        np.testing.assert_array_equal(aa[k].view(np.uint8),
                                      ra[k].view(np.uint8), err_msg=k)
    assert aa["s0_d_vals"].dtype == np.dtype("V2")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n),
                        dtype=torch.bfloat16)
    want = spt.matvec_mult(1.0, A, x)
    for path in (pa, pr):
        B = spt.mat_restore(path, device="cpu")
        assert B.csx.shards[0].value_type == "bfloat16"
        got = spt.matvec_mult(1.0, B, x)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    np.testing.assert_array_equal(
        persist.bf16_values(persist.bf16_bits(A.csx.shards[0].delta.vals)),
        A.csx.shards[0].delta.vals)


def test_restore_replans_an_overlapping_layout(tmp_path, monkeypatch):
    """``chip_smoke.overlap_run_matrix(4096, 17, 2)`` under small planner
    thresholds: the reference's saved layout holds a fused run whose route
    instances overlap outside a merged plan; the port's restore plans that
    shard again (its own layout, with an ``fs`` route) and meets the
    oracle, where the archived layout run as it is would not."""
    for mods, name, value in (((fused, tf), "MIN_FUSED_NNZ", 256),
                              ((pk, tpk), "MIN_PAGE_NNZ", 64),
                              ((route_mod, troute), "MIN_ELEMS", 64)):
        for mod in mods:
            monkeypatch.setattr(mod, name, value)
    n = 4096
    rows, cols, vals = chip_smoke.overlap_run_matrix(n, 17, 2)
    vals = vals.astype(np.float64)
    _options(**{"spx.tpu.value_dtype": "float64",
                "spx.preproc.xform": "all"})
    R = ref.mat_tune(chip_smoke.csr_input(ref, rows, cols, vals, n))
    path = str(tmp_path / "ref.npz")
    ref.mat_save(R, path)
    arrays, meta = _archive(path)
    saved = persist._dec_tree(meta["layouts"][0]["meta"], arrays)
    assert unmerged_overlapping_runs(saved)
    B = spt.mat_restore(path, device="cpu")
    ex = B.csx.executors[0]
    assert not unmerged_overlapping_runs(ex.meta)
    assert any(len(e) > 4 and e[4] and e[4][0] == "fs" for e in ex.meta[2])
    x = np.random.default_rng(1).standard_normal(n)
    want = np.bincount(rows, weights=vals * x[cols], minlength=n)
    got = _y(spt.matvec_mult(1.0, B, x))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-10


def test_restore_refuses_what_is_not_an_archive(tmp_path):
    """A file that is no archive, or one of the old format, raises
    SPX_ERR_FILE_READ, as in the reference."""
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, meta=np.frombuffer(json.dumps(
        {"magic": "sparsex_tpu-csx-v1"}).encode(), dtype=np.uint8))
    for path in (bad, str(tmp_path / "missing.npz")):
        with pytest.raises(spt.SparsexError) as ei:
            spt.mat_restore(path, device="cpu")
        assert ei.value.code == spt.ErrorCode.SPX_ERR_FILE_READ
