"""The port's row-blocked delta stream on the CPU: its planner
(``ops/pallas_kernels.build_row_blocks``: ``row_block_rows``,
``row_block_layout``), the plain version of its
kernel (``delta_rowblock_acc_plain``, which the wrapper runs on a CPU
tensor) and the executor's choice (``ops/exec.device_layout``): a paged
delta stream whose products are scatter-added (``dpages`` without
``dscatter``) is laid out in row blocks (``drows``) where its windows fit;
a routed stream and a symmetric shard's streams keep their layout.  The
CUDA kernel against the plain version is in ``tests/test_torch_cuda.py``
(``-k rowblock``)."""

import numpy as np
import pytest
import torch

import sparsex_tpu_torch as spt
from sparsex_tpu_torch import timing
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.route import fold_sort_key
from test_torch_cuda import route_singles

torch.set_num_threads(1)
BARS = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture(autouse=True)
def fresh_port_config():
    spt.Config.reset()
    timing.trace_reset()
    yield
    spt.Config.reset()


def urand(n, per_row, seed):
    """A GAP-style urand graph on n vertices: n * per_row / 2 random edges,
    self loops and duplicates dropped, both directions stored, sorted by
    row; its values PageRank's 1 / degree of the column."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, n * per_row // 2)
    c = rng.integers(0, n, r.size)
    keep = r != c
    key = np.unique(np.concatenate([r[keep] * n + c[keep],
                                    c[keep] * n + r[keep]]))
    rows, cols = key // n, key % n
    return rows, cols, 1.0 / np.bincount(cols, minlength=n)[cols]


def paged_stream(rows, cols, vals, n):
    """The paged delta stream the planner makes of these singles (fold
    sorted, as for a stream without a scatter route): (rep, npages)."""
    rep, _left = tpk.build_delta_pages(cols, rows, vals, n, n,
                                       sort_key=fold_sort_key(rows, n, cols))
    rep.pop("q")
    return rep, rep.pop("npages")


def kept(rep, n):
    """(rows, cols, vals) of the elements the stream keeps."""
    r = rep["rows"].reshape(-1)
    ok = r < n
    c = (np.repeat(rep["plo"].astype(np.int64) * tpk.PAGE, tpk.DELTA_TILE)
         + rep["sl"].reshape(-1))
    return r[ok].astype(np.int64), c[ok], rep["vals"].reshape(-1)[ok]


def plain_q(rows, cols, rb):
    """The most pages a tile's window spans when each row block's elements,
    sorted by page, are cut into tiles of DELTA_TILE: counted tile by
    tile."""
    worst = 0
    for b in np.unique(rows // rb):
        pages = np.sort(cols[rows // rb == b] // tpk.PAGE)
        for t in range(0, pages.size, tpk.DELTA_TILE):
            tile = pages[t:t + tpk.DELTA_TILE]
            worst = max(worst, int(tile[-1] - tile[0]) + 1)
    return worst


def layout_elements(lay, n):
    """(rows, cols, vals) of the real slots of a row-blocked layout, and
    each slot's row block."""
    T = lay["plo"].size
    tiles = lay["blk_tile"].astype(np.int64)
    blk = np.repeat(np.arange(tiles.size - 1), np.diff(tiles))
    blk = np.repeat(blk, tpk.DELTA_TILE)
    lrow = lay["lrow"].astype(np.int64)
    col = (np.repeat(lay["plo"].astype(np.int64) * tpk.PAGE, tpk.DELTA_TILE)
           + lay["sl"].reshape(-1))
    ok = lrow >= 0
    assert blk.size == T * tpk.DELTA_TILE
    return (blk * lay["rb"] + lrow)[ok], col[ok], \
        lay["vals"].reshape(-1)[ok], blk


@pytest.mark.parametrize("n", [1 << 14, 40000, 1 << 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_row_block_layout_holds_each_element_once(n, dtype):
    """Every kept element of the stream appears exactly once, with its row
    and column; every local row lies below rb; every tile's window spans at
    most MAX_Q pages and lies in the page grid; the sentinel (local row -1,
    value 0, offset 0) sits only in each block's padding, after its
    elements and short of a whole tile."""
    rows, cols, vals = urand(n, 32, seed=n)
    rep, npages = paged_stream(rows, cols, vals.astype(dtype), n)
    lay = tpk.build_row_blocks(rep, n, npages, np.dtype(dtype).itemsize)
    rb = lay["rb"]
    assert rb == tpk.row_block_rows(n, np.dtype(dtype).itemsize)
    r0, c0, v0 = kept(rep, n)
    r1, c1, v1, blk = layout_elements(lay, n)
    o0, o1 = np.lexsort((c0, r0)), np.lexsort((c1, r1))
    assert np.array_equal(r0[o0], r1[o1]) and np.array_equal(c0[o0], c1[o1])
    assert np.array_equal(v0[o0], v1[o1])
    lrow = lay["lrow"]
    assert lrow.dtype == np.int16 and lrow.min() >= -1 and lrow.max() < rb
    assert lay["sl"].dtype == np.int16 and lay["plo"].dtype == np.int32
    q = lay["q"]
    assert q <= tpk.MAX_Q
    assert q == plain_q(r0, c0, rb)
    sl = lay["sl"].reshape(-1).astype(np.int64)
    assert sl.min() >= 0 and sl.max() < q * tpk.PAGE
    assert lay["plo"].min() >= 0 and lay["plo"].max() + q <= max(npages, q)
    pad = lrow < 0
    assert (lay["vals"].reshape(-1)[pad] == 0).all() and (sl[pad] == 0).all()
    tiles = lay["blk_tile"].astype(np.int64)
    assert tiles[0] == 0 and tiles[-1] == lay["plo"].size
    assert tiles.size == -(-n // rb) + 1 and (np.diff(tiles) >= 0).all()
    per_block = np.bincount(r0 // rb, minlength=tiles.size - 1)
    for b in range(tiles.size - 1):
        run = lrow[tiles[b] * tpk.DELTA_TILE: tiles[b + 1] * tpk.DELTA_TILE]
        k = per_block[b]
        assert (run[:k] >= 0).all() and (run[k:] == -1).all()
        assert run.size - k < tpk.DELTA_TILE
    assert (blk[~pad] == r1 // rb).all()


@pytest.mark.parametrize("case,n,per_row,dtype,rb", [
    ("dense", 1 << 14, 64, "float32", 1 << 14),
    ("dense", 1 << 14, 64, "float64", 1 << 13),
    ("sparse", 1 << 16, 4, "float32", 1 << 14),
    ("short", 3000, 64, "float32", 4096),
    ("too tall", 1 << 20, 1, "float32", None),
])
def test_row_block_rows_fit_or_fall_back(case, n, per_row, dtype, rb):
    """The planner's block: as many rows as 64 KB of sums hold in the value
    type (16,384 in f32, 8,192 in f64), or the rows rounded up to a power
    of two where fewer.  A stream too tall for it (2^20 rows of one
    element: a block's 16,384 elements spread over 1,024 pages) makes no
    layout, and its planner span counts as rejected."""
    rows, cols, vals = urand(n, per_row, seed=per_row)
    rep, npages = paged_stream(rows, cols, vals.astype(dtype), n)
    isz = np.dtype(dtype).itemsize
    lay = tpk.build_row_blocks(rep, n, npages, isz)
    spans = spt.trace_snapshot()["spans"]["spx.tune.plan.build_row_blocks"]
    if rb is None:
        assert lay is None and spans["rejected_seconds"] > 0
        r0, c0, _v = kept(rep, n)
        assert plain_q(r0, c0, tpk.row_block_rows(n, isz)) > tpk.MAX_Q
    else:
        assert lay["rb"] == rb == tpk.row_block_rows(n, isz)
        assert lay["q"] <= tpk.MAX_Q and spans["rejected_seconds"] == 0


@pytest.mark.parametrize("n", [1 << 14, 50000, 1 << 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rowblock_plain_matches_delta_pages_and_oracle(n, dtype):
    """The row-blocked kernel's plain version (through its wrapper, on CPU
    tensors) adds what ``delta_pages_acc_plain`` adds from the fold-sorted
    stream and what the CSR oracle gives, into an accumulator that already
    holds values, ragged row blocks (n not a multiple of rb) included."""
    rows, cols, vals = urand(n, 32, seed=3)
    rep, npages = paged_stream(rows, cols, vals.astype(dtype), n)
    lay = tpk.build_row_blocks(rep, n, npages, np.dtype(dtype).itemsize)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(n).astype(dtype))
    acc0 = torch.from_numpy(rng.standard_normal(n).astype(dtype))
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in lay.items()
         if isinstance(v, np.ndarray)}
    x2 = tpk.pad_x_pages(x, n, max(lay["q"], tpk.MAX_Q), npages)
    got = tpk.delta_rowblock_acc(t["plo"], t["sl"], t["lrow"], t["vals"], x2,
                                 lay["q"], acc0.clone(), t["blk_tile"],
                                 lay["rb"])
    want = tpk.delta_pages_acc_plain(
        torch.from_numpy(rep["plo"]), torch.from_numpy(rep["sl"]),
        torch.from_numpy(rep["vals"]), x2, tpk.MAX_Q, acc0.clone(),
        torch.from_numpy(rep["rows"].astype(np.int64)))
    r0, c0, v0 = kept(rep, n)
    oracle = acc0.numpy().astype(np.float64) + np.bincount(
        r0, weights=v0.astype(np.float64)
        * x.numpy().astype(np.float64)[c0], minlength=n)
    scale = np.abs(oracle).max()
    assert np.abs(got.numpy() - want.numpy()).max() <= BARS[dtype] * scale
    assert np.abs(got.numpy() - oracle).max() <= BARS[dtype] * scale


def _tune(rows, cols, vals, n, dtype, **options):
    cfg = spt.Config.reset()
    for key, value in {"spx.tpu.value_dtype": dtype,
                       "spx.preproc.xform": "all", **options}.items():
        cfg.set(key, value)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return spt.mat_tune(spt.input_load_csr(rowptr, cols, vals.astype(dtype),
                                           n, n), device="cpu")


def _extras(meta):
    return {e[0] for e in meta[5:] if e}


def _matvec_ok(A, rows, cols, vals, n, dtype):
    """``matvec_kernel(0.85, A, x, 1, y)`` and the SpMM of 3 columns (the
    SpMV column by column) against the CSR oracle."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, 3)).astype(dtype)
    y = rng.standard_normal(n).astype(dtype)
    v = vals.astype(dtype).astype(np.float64)
    want = np.stack([np.bincount(rows, weights=v * x[cols, j].astype(
        np.float64), minlength=n) for j in range(3)], axis=1)
    got = spt.matvec_kernel(0.85, A, x[:, 0], 1.0, y)
    bar = BARS[dtype] * np.abs(want).max()
    assert np.abs(got.numpy() - (0.85 * want[:, 0] + y)).max() <= 2 * bar
    got = spt.matmat_mult(1.0, A, x)
    assert np.abs(np.asarray(got) - want).max() <= bar


@pytest.mark.parametrize("plan", ["epilogue", "routed", "symmetric"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_executor_row_blocks_only_an_unrouted_stream(monkeypatch, plan,
                                                     dtype):
    """Through ``api.matvec_kernel``: a urand graph's paged delta stream,
    whose scatter route the planner rejects, runs in row blocks (``drows``
    replaces ``dpages``, ``delta_rows`` the uploaded ``delta_pages`` with
    its int32 rows); a routed stream (``dpages`` + ``dscatter``) and a
    symmetric shard's streams (``dpages`` + ``dpagesT``) keep theirs.  The
    counters say which: ``plan.rowblock.plans``, ``.elems``, and
    ``.fallbacks`` (none here)."""
    if plan == "routed":
        n = 4096
        monkeypatch.setattr(tpk, "MIN_PAGE_NNZ", 64)
        monkeypatch.setattr(troute, "MIN_ELEMS", 64)
        rows, cols, vals = route_singles(n)
        A = _tune(rows, cols, vals, n, dtype, **{"spx.preproc.xform": "none"})
    else:
        n = 1 << 14
        rows, cols, vals = urand(n, 32, seed=5)
        opts = {}
        if plan == "symmetric":
            monkeypatch.setattr(tpk, "MIN_PAGE_NNZ", 1024)
            monkeypatch.setattr(troute, "MIN_ELEMS", 1 << 30)
            vals = np.ones(rows.size)      # the graph itself: symmetric
            opts = {"spx.matrix.symmetric": "true", "spx.tpu.sym_full": "off"}
        A = _tune(rows, cols, vals, n, dtype, **opts)
    ex = A.csx.executors[0]
    counters = spt.trace_snapshot()["counters"]
    want = {"epilogue": {"drows"}, "routed": {"dpages", "dscatter"},
            "symmetric": {"dpages", "dpagesT"}}[plan]
    assert _extras(ex.meta) == want
    if plan == "epilogue":
        assert "delta_pages" not in ex.arrays
        dr = ex.arrays["delta_rows"]
        assert dr["lrow"].dtype == torch.int16
        assert counters["plan.rowblock.plans"] == 1
        assert counters["plan.rowblock.elems"] == int(
            (dr["lrow"] >= 0).sum()) > 0
    else:
        assert "delta_rows" not in ex.arrays and "delta_pages" in ex.arrays
        assert "plan.rowblock.plans" not in counters
    assert "plan.rowblock.fallbacks" not in counters
    _matvec_ok(A, rows, cols, vals, n, dtype)


def test_executor_keeps_a_stream_too_tall_for_row_blocks(monkeypatch):
    """A stream whose windows do not fit a row block (one element a row)
    stays fold-sorted, its plan counted in ``plan.rowblock.fallbacks``, and
    runs the delta-pages kernel's epilogue as before."""
    n = 1 << 17
    monkeypatch.setattr(troute, "MIN_ELEMS", 1 << 30)
    rng = np.random.default_rng(9)
    rows = np.arange(n)
    cols = rng.integers(0, n, n)
    vals = rng.standard_normal(n)
    A = _tune(rows, cols, vals, n, "float64",
              **{"spx.preproc.xform": "none",
                 "spx.tpu.min_fused_nnz": str(n + 1)})
    ex = A.csx.executors[0]
    counters = spt.trace_snapshot()["counters"]
    assert _extras(ex.meta) == {"dpages"}
    assert ex.arrays["delta_pages"]["rows"].dtype == torch.int32
    assert counters["plan.rowblock.fallbacks"] == 1
    assert "plan.rowblock.plans" not in counters
    _matvec_ok(A, rows, cols, vals, n, "float64")
