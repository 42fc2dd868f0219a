"""The SpMM slice of sparsex_tpu_torch on the CPU.

The k-batched kernels (``kb`` > 0 variants of K1, T1, K2, K3 and the lane
gather) run their plain PyTorch versions on CPU tensors; the reference's
k-batched Pallas kernels (``fused._build_k1/_build_t1/_build_k2(...,
kb=kb)``, ``route._build_lane_gather(..., kb=kb)``, K3 through the
reference's ``k3_combine`` on a k-major x) run in interpret mode on the
same inputs, made with numpy from a seed, kb in {1, 3, 8}:

- K1 in ``lp``, ``rlp{W}``, ``sl`` and ``run{W}``, T1 in f32 and f64, K2
  with um2 on and off, the lane gather at K in {1, 3}: bit for bit; K3 with
  a masked g3 and DIA plus anti-diagonal tables within 1e-6 of the largest
  value (the 1-D test's bar);
- column c of every k-batched plain version equals its kb = 0 plain
  version on column c, bit for bit.

End to end, ``matmat`` (``CsxExecutor.matmat``: chunks of ``MM_FUSED_KB``
columns through ``fused_mm_contrib`` on a fused plan, the SpMV once per
column otherwise) against the reference ``CsxMatrix.matmat`` in interpret
mode (float32, within 1e-5 of the largest value), a float64 COO oracle
(float64, within 1e-6) and the port's own per-column ``matvec``
(``torch.equal``, as tests/test_spmm.py:384 holds the reference); the API's
alpha/beta/Y and its SPX_ERR_VEC_DIM refusals; no kernel launch on the
CPU.
"""

import hashlib
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import sparsex_tpu.ops.fused as fused
import sparsex_tpu.ops.pallas_kernels as pk
from sparsex_tpu.config import Config as RefConfig
from sparsex_tpu.csx import CsxMatrix as RefCsxMatrix
from sparsex_tpu.ops import route as route_mod
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.kernels import fused_mm_ok

torch.set_num_threads(1)
L = 128
TILE3 = L * L
KBS = (1, 3, 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def fresh_port_config():
    """The port's Config is its own singleton: reset it around every test,
    as tests/conftest.py resets the reference's."""
    spt.Config.reset()
    yield
    spt.Config.reset()


def _columns_equal(batched, one_column):
    """Column c of a k-batched result equals ``one_column(c)``."""
    for c in range(batched.shape[0]):
        assert torch.equal(batched[c], one_column(c)), f"column {c}"


# ---------------------------------------------------------------------------
# the k-batched plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style,q", [("lp", 4), ("lp", 32), ("rlp4", 4),
                                     ("sl", 2), ("run16", 2), ("rlp2", 1),
                                     ("rlp2", 32), ("rlp128", 4),
                                     ("rlp128", 32), ("run2", 2),
                                     ("run128", 1), ("sl", 1), ("sl", 16),
                                     ("lp", 1)])
@pytest.mark.parametrize("kb", KBS + (5,))
def test_k1_kb_matches_pallas(style, q, kb):
    """Lane-placed windows of q8 pages and dense windows of q pages, each
    with offsets past the window (they read 0); the run widths 2 to 128 of
    the roll (one to seven passes).  In a lane-placed run style, lane 0 of
    the first row routes the total of the arc of W lanes that ends at lane
    W/2 - 1, so it wraps lane 127 -> 0: the circular roll sums it whole."""
    rng = np.random.default_rng(q * 10 + kb + len(style))
    T, npages = 8, 64
    dense, W = tf.k1_style(style)
    low = rng.integers(0, min(1 << 14, q * 1024 + 512) if dense
                       else q * 8 + 8, (T, 8, L))
    g1 = rng.integers(-1, L, (T, 8, L))
    if W and not dense:
        g1[0, 0, 0] = W // 2 - 1
    mg = fused.pack_k1_meta(low, g1)
    plo = rng.integers(0, npages - q + 1 if dense else npages // q,
                       T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(np.float32)
    x2 = rng.standard_normal((kb, npages, 8, L)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused._build_k1(T, q, style, "float32", kb=kb)(
            jnp.asarray(plo), jnp.asarray(mg), jnp.asarray(vals),
            jnp.asarray(x2)))
    args = (_t(plo), _t(mg), _t(vals))
    got = tf.k1(*args, _t(x2), q, style)
    assert got.shape == (kb, T, 8, L)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.4
    _columns_equal(got, lambda c: tf.k1(*args, _t(x2[c]), q, style))
    if W and not dense:
        idx, ok = tf.k1_x_index(args[0], args[1], q, style)
        p = np.where(ok.numpy(), x2.reshape(kb, -1)[:, idx.numpy()], 0)
        arc = (np.arange(W // 2 - W, W // 2) % L)
        assert arc[0] > arc[-1]                 # the arc wraps
        p_arc = p[:, 0, 0, arc] * vals[0, 0, arc]
        np.testing.assert_allclose(want[:, 0, 0, 0], p_arc.sum(-1),
                                   rtol=1e-5,
                                   atol=1e-5 * np.abs(p_arc).sum())


@pytest.mark.parametrize("kb", KBS + (5,))
def test_k1_kb_lp_past_window_matches_pallas(kb):
    """Lane-placed K1 with most routed slots past their q8-page window:
    those read 0 (0 x v), the rest x * v, as the Pallas kernel gives."""
    rng = np.random.default_rng(90 + kb)
    T, npages, q = 8, 64, 4
    low = rng.integers(q * 8, 8 * 8, (T, 8, L))       # pages q8 .. 7
    inside = rng.random((T, 8, L)) < 0.2
    low[inside] = rng.integers(0, q * 8, int(inside.sum()))
    g1 = rng.integers(-1, L, (T, 8, L))
    mg = fused.pack_k1_meta(low, g1)
    plo = rng.integers(0, npages // q, T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(np.float32)
    x2 = rng.standard_normal((kb, npages, 8, L)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused._build_k1(T, q, "lp", "float32", kb=kb)(
            jnp.asarray(plo), jnp.asarray(mg), jnp.asarray(vals),
            jnp.asarray(x2)))
    args = (_t(plo), _t(mg), _t(vals))
    got = tf.k1(*args, _t(x2), q, "lp")
    np.testing.assert_array_equal(got.numpy(), want)
    _idx, ok = tf.k1_x_index(args[0], args[1], q, "lp")
    src = np.take_along_axis(ok.numpy(), np.maximum(g1, 0), -1)
    assert (~src[g1 >= 0]).mean() > 0.7           # routed, past the window
    assert 0.1 < (want != 0).mean() < 0.3
    _columns_equal(got, lambda c: tf.k1(*args, _t(x2[c]), q, "lp"))


@pytest.mark.parametrize("kb", KBS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_t1_kb_matches_pallas(kb, dtype):
    rng = np.random.default_rng(kb)
    A2R = 6
    a1 = rng.standard_normal((kb, A2R * L, L)).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused._build_t1(A2R, np.dtype(dtype).name, kb=kb)(
            jnp.asarray(a1)))
    got = tf.t1(_t(a1), A2R)
    assert got.shape == (kb, A2R, L, L)
    np.testing.assert_array_equal(got.numpy(), want)
    _columns_equal(got, lambda c: tf.t1(_t(a1[c]), A2R))


@pytest.mark.parametrize("um2", [True, False])
@pytest.mark.parametrize("kb", KBS)
def test_k2_kb_matches_pallas(um2, kb):
    """As the 1-D test: A2R = 13 (ceil8 16), W2 = 16, D2R = 5; the unmasked
    Pallas kernel takes g2b with its lane offset, the port raw wires."""
    rng = np.random.default_rng(kb * 2 + um2)
    A2R, W2, D2R = 13, 16, 5
    a1t = rng.standard_normal((kb, A2R, L, L)).astype(np.float32)
    lo = 0 if um2 else -1
    g2a = rng.integers(lo, L, (L, A2R, L)).astype(np.int8)
    g2b = rng.integers(lo, 16, (L, W2, L)).astype(np.int8)
    g2c = rng.integers(lo, 2 * W2, (L, D2R, L)).astype(np.int8)
    g2b_pallas = fused._g2b_lane_offset(g2b, A2R) if um2 else g2b
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused._build_k2(A2R, W2, D2R, "float32", kb=kb,
                                          um2=um2)(
            jnp.asarray(a1t), jnp.asarray(g2a), jnp.asarray(g2b_pallas),
            jnp.asarray(g2c)))
    wires = (_t(g2a), _t(g2b), _t(g2c))
    got = tf.k2(_t(a1t), *wires, W2, D2R)
    assert got.shape == (kb, L, D2R, L)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.2
    _columns_equal(got, lambda c: tf.k2(_t(a1t[c]), *wires, W2, D2R))


# (D2R, wires per instance, um3, dia, anti, ncols), as
# tests/test_torch_fused.py's K3_CASES: one and an odd number of
# destination blocks, eight instances of 1..8 wires beside DIA and anti
# tables, masked wires (-1) where um3 is False
K3_KB_CASES = [
    pytest.param(2, (3, 3), False, (-20000, 300, 16390), (5, 40000), 30000,
                 id="2-False-dia0-anti0"),
    pytest.param(2, (3,), True, (-13, 0, 8), (), 30000,
                 id="1-True-dia1-anti1"),
    pytest.param(1, (2,), False, (-5, 0, 7), (), 12000, id="d2r1-masked"),
    pytest.param(3, (1, 2, 3, 4, 5, 6, 7, 8), False, (-9, 0, 30000),
                 (2, 40000), 45000, id="d2r3-8inst-k1to8-masked"),
]


@pytest.mark.parametrize("D2R,Ks,um3,dia,anti,ncols", K3_KB_CASES)
@pytest.mark.parametrize("kb", KBS)
def test_k3_kb_matches_pallas(D2R, Ks, um3, dia, anti, ncols, kb):
    """K3 through both packages' ``k3_combine`` on a k-major x (the
    reference builds its kb > 0 K3): routed instances of ``Ks`` wires,
    DIA and anti-diagonal windows over a ragged x."""
    n_inst = len(Ks)
    rng = np.random.default_rng(n_inst * 10 + kb + 100 * (D2R != 2))
    nrows = D2R * TILE3 - 700
    e1 = [rng.standard_normal((kb, L, D2R, L)).astype(np.float32)
          for _ in range(n_inst)]
    g3 = [rng.integers(0 if um3 else -1, L, (D2R, K, L, L)).astype(np.int8)
          for K in Ks]
    r = np.arange(D2R * TILE3)

    def grid(offs, is_anti):
        if not offs:
            return None
        v = rng.standard_normal((len(offs), r.size)).astype(np.float32)
        for k, o in enumerate(offs):
            c = o - r if is_anti else r + o
            v[k, (c < 0) | (c >= ncols)] = 0   # the encoder's guarantee
        return np.ascontiguousarray(
            v.reshape(len(offs), D2R, L, L).transpose(1, 0, 2, 3))

    dv, adv = grid(dia, False), grid(anti, True)
    x = rng.standard_normal((kb, ncols)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        pack = (dia, None if dv is None else jnp.asarray(dv), anti,
                None if adv is None else jnp.asarray(adv))
        want = np.asarray(fused.k3_combine(
            [(jnp.asarray(e), jnp.asarray(g), g.shape[1], um3)
             for e, g in zip(e1, g3)], pack, jnp.asarray(x), nrows, ncols))
    tpack = (dia, None if dv is None else _t(dv), anti,
             None if adv is None else _t(adv))

    def port(c=None):
        pick = (lambda a: a) if c is None else (lambda a: a[c])
        return tf.k3_combine([(_t(pick(e)), _t(g), g.shape[1], um3)
                              for e, g in zip(e1, g3)], tpack, _t(pick(x)),
                             nrows, ncols)

    got = port()
    assert got.shape == (kb, nrows)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    _columns_equal(got, port)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("kb", KBS)
def test_lane_gather_kb_matches_pallas(K, kb):
    rng = np.random.default_rng(K * 10 + kb)
    R = 192
    x = rng.standard_normal((kb, R, L)).astype(np.float32)
    idx = rng.integers(-1, L, (K, R, L)).astype(np.int8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(route_mod._build_lane_gather(
            R, K, "float32", kb=kb)(jnp.asarray(x), jnp.asarray(idx)))
    got = troute.lane_gather(_t(x), _t(idx))
    assert got.shape == (kb, R, L)
    np.testing.assert_array_equal(got.numpy(), want)
    _columns_equal(got, lambda c: troute.lane_gather(_t(x[c]), _t(idx)))


def test_kb_wrappers_reject_bad_batches():
    """More than MAX_KB columns, or a batch that does not match, raise."""
    x = torch.zeros(tf.MAX_KB + 1, 64, L)
    with pytest.raises(ValueError):
        troute.lane_gather(x, torch.zeros(1, 64, L, dtype=torch.int8))
    with pytest.raises(ValueError):
        tf.t1(torch.zeros(tf.MAX_KB + 1, 2 * L, L), 2)
    e1 = torch.zeros(3, L, 1, L)
    g3 = torch.zeros(1, 1, L, L, dtype=torch.int8)
    dv = torch.zeros(1, 1, L, L)
    with pytest.raises(ValueError, match="expected"):   # 2 x columns, 3 E1
        tf.k3([e1], [g3], dv, (0,), None, (), torch.zeros(2, 1, L, L), None,
              TILE3, 1)
    with pytest.raises(ValueError, match="x blocks"):   # reversed x 1-D
        tf.k3([e1[:2]], [g3], dv, (0,), dv, (0,), torch.zeros(2, 1, L, L),
              torch.zeros(1, L, L), TILE3, 1)


# ---------------------------------------------------------------------------
# matmat end to end
# ---------------------------------------------------------------------------

def _thresholds(monkeypatch, fused_nnz=256, page_nnz=64, route_elems=64):
    """Planner thresholds set alike on both packages (so that they plan the
    same arrays); the reference's DIA kernel admitted in interpret mode."""
    for mods, name, value in (((fused, tf), "MIN_FUSED_NNZ", fused_nnz),
                              ((pk, tpk), "MIN_PAGE_NNZ", page_nnz),
                              ((route_mod, troute), "MIN_ELEMS",
                               route_elems)):
        for mod in mods:
            monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(pk, "dia_pallas_ok", lambda: True)


def _fused_mm_matrix(n, rng, runs=False):
    """tests/test_spmm.py's matrix: diagonals 0, 3, -2, n/8 width-8 runs
    (``runs``) and n singles, float32 values."""
    rows_l, cols_l = [], []
    for b in (0, 3, -2):
        r = np.arange(max(0, -b), min(n, n - b))
        rows_l.append(r)
        cols_l.append(r + b)
    if runs:
        hr = rng.integers(0, n, n // 8)
        hc = rng.integers(0, n - 8, n // 8)
        rows_l.append(np.repeat(hr, 8))
        cols_l.append((hc[:, None] + np.arange(8)[None]).ravel())
    rows_l.append(rng.integers(0, n, n))
    cols_l.append(rng.integers(0, n, n))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    _, u = np.unique(rows.astype(np.int64) * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = np.random.default_rng(1).standard_normal(
        rows.size).astype(np.float32)
    return rows, cols, vals


def _port(n, rows, cols, vals, dtype, reference=False, **options):
    """The port's matrix on the CPU (and, with ``reference``, the
    reference's), tuned under bench.py's options plus ``options``."""
    options = {"spx.tpu.value_dtype": dtype, "spx.preproc.xform": "all",
               **options}
    cfgs = [spt.Config.instance()] + ([RefConfig.instance()] if reference
                                      else [])
    for cfg in cfgs:
        for key, value in options.items():
            cfg.set(key, value)
    vals = vals.astype(dtype)
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    ref = RefCsxMatrix.from_coo(n, n, rows, cols, vals) if reference else None
    return A, ref


def _oracle(n, rows, cols, vals, X):
    want = np.zeros((n, X.shape[1]))
    np.add.at(want, rows, vals.astype(np.float64)[:, None]
              * X.astype(np.float64)[cols])
    return want


def _check_matmat(A, ref, n, rows, cols, vals, k, dtype):
    """matmat against the oracle (f32 at 1e-5 of the largest value, f64 at
    1e-6), the reference's matmat in interpret mode (f32) and the port's
    per-column matvec (bit for bit), at alpha=1/beta=0 and
    alpha=1.7/beta=0.5; no kernel launch on the CPU."""
    rng = np.random.default_rng(k)
    X = rng.standard_normal((n, k)).astype(dtype)
    Y0 = rng.standard_normal((n, k)).astype(dtype)
    before = tf.launch_counts()
    Y = spt.matmat_mult(1.0, A, X)
    Yab = spt.matmat_kernel(1.7, A, torch.from_numpy(X), 0.5, Y0)
    cols_y = torch.stack([spt.matvec_mult(1.0, A, X[:, j])
                          for j in range(k)], dim=1)
    assert tf.launch_counts() == before
    assert Y.shape == (n, k) and Y.dtype == getattr(torch, dtype)
    assert torch.equal(Y, cols_y)
    want = _oracle(n, rows, cols, vals.astype(dtype), X)
    bar = 1e-5 if dtype == "float32" else 1e-6
    scale = np.abs(want).max()
    assert np.abs(Y.double().numpy() - want).max() / scale < bar
    wab = 1.7 * want + 0.5 * Y0
    assert (np.abs(Yab.double().numpy() - wab).max() / np.abs(wab).max()
            < bar)
    if ref is not None:
        with pltpu.force_tpu_interpret_mode():
            assert ref.executors[0]._pages_active()
            assert fused_mm_ok(ref.executors[0]._pages_meta)
            yr = np.asarray(ref.matmat(jnp.asarray(X)))
        assert np.abs(Y.numpy() - yr).max() / scale < 1e-5


def _mm_plan(A):
    ex = A.csx.executors[0]
    assert ex.variant == "paged" and fused_mm_ok(ex.meta)
    return {e[0]: e[1:] for e in ex.meta[5:] if e}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k,runs", [(5, False), (11, True)])
def test_matmat_fused_k_batched(monkeypatch, dtype, k, runs):
    """tests/test_spmm.py's k-batched case at n = 8192: the hybrid lp delta
    with DIA tables in K3; with runs, a fused run table beside it; k = 11
    runs chunks of 8 and 3."""
    _thresholds(monkeypatch)
    n = 8192
    rows, cols, vals = _fused_mm_matrix(n, np.random.default_rng(31 + k),
                                        runs=runs)
    A, ref = _port(n, rows, cols, vals, dtype,
                   reference=dtype == "float32")
    assert {"dfused", "k3dias"} <= set(_mm_plan(A))
    _check_matmat(A, ref, n, rows, cols, vals, k, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_matmat_merged_plan(monkeypatch, dtype):
    """tests/test_spmm.py's merged ``fall`` case at n = 16384, k = 6: the
    delta and run segments share one route instance set, per-instance G1
    lane gathers."""
    _thresholds(monkeypatch)
    n = 16384
    rows, cols, vals = _fused_mm_matrix(n, np.random.default_rng(7),
                                        runs=True)
    A, ref = _port(n, rows, cols, vals, dtype, reference=dtype == "float32",
                   **{"spx.tpu.dia_min_fill": "0.9"})
    assert "fall" in _mm_plan(A)
    _check_matmat(A, ref, n, rows, cols, vals, 6, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("build,style", [("lane_skew_matrix", "sl"),
                                         ("wide_run_matrix", "run16")])
def test_matmat_dense_k1_styles(monkeypatch, dtype, build, style):
    """The dense-tile K1 styles at 2^15 rows, k = 3: the sl delta pipeline
    (lane-skewed singles) and a run16 fused run table in a merged plan (a
    run table routes one element per unit: MIN_ELEMS = 1024)."""
    _thresholds(monkeypatch, fused_nnz=fused.MIN_FUSED_NNZ,
                page_nnz=pk.MIN_PAGE_NNZ, route_elems=1024)
    n = 1 << 15
    fn = getattr(chip_smoke, build)
    rows, cols, vals = fn(n) if style == "sl" else fn(n, 16)
    A, ref = _port(n, rows, cols, vals, dtype, reference=dtype == "float32",
                   **{"spx.preproc.sampling": "portion"})
    ex = A.csx.executors[0]
    _mm_plan(A)
    styles = ({ex.meta[5][1][6]} if style == "sl"
              else {m[5] for _ri, m in chip_smoke.fused_runs(ex.meta)})
    assert style in styles
    _check_matmat(A, ref, n, rows, cols, vals, 3, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("variant", ["plain", "paged"])
def test_matmat_per_column_route(monkeypatch, dtype, variant):
    """Plans without a fused segment run the SpMV once per column: the
    plain-table variant (the 16^3 HPCG stencil, one DIA table) and the
    legacy paged variant (nothing fuses above ``spx.tpu.min_fused_nnz``,
    nothing is routed: the paged delta stream, paged run and block tables,
    a standalone DIA table).  The delta stream is too sparse for the
    port's row blocks (its windows would span more than 8 pages there), so
    it keeps the planner's layout; ``tests/test_torch_rowblock.py`` runs
    the SpMM of a row-blocked one."""
    if variant == "plain":
        n, rows, cols, vals = chip_smoke.hpcg_matrix(16)
        opts = {"spx.preproc.sampling": "none"}
    else:
        _thresholds(monkeypatch, page_nnz=1024, route_elems=1 << 30)
        n = 1 << 15
        rows, cols, vals = chip_smoke.build_blocky_matrix(n)
        d = np.arange(n - 1)
        rows = np.concatenate([rows, d, d + 1])
        cols = np.concatenate([cols, d + 1, d])
        _, u = np.unique(rows * n + cols, return_index=True)
        rows, cols = rows[u], cols[u]
        o = np.lexsort((cols, rows))
        rows, cols = rows[o], cols[o]
        vals = np.random.default_rng(2).standard_normal(rows.size)
        opts = {"spx.preproc.sampling": "none",
                "spx.tpu.min_fused_nnz": str(rows.size + 1)}
    A, _ref = _port(n, rows, cols, vals, dtype, **opts)
    ex = A.csx.executors[0]
    assert ex.variant == variant and not fused_mm_ok(ex.meta)
    if variant == "paged":
        assert {e[0] for e in ex.meta[5:] if e} == {"dpages"}
        assert any(len(e) > 3 and e[3] for e in ex.meta[2] + ex.meta[3])
    assert ex.meta[4], "a standalone DIA table"
    _check_matmat(A, None, n, rows, cols, vals, 3, dtype)


def test_executor_makes_its_device_current_once_a_call(monkeypatch):
    """``CsxExecutor`` makes the matrix's CUDA device current once around
    all the launches of a call (the ctypes launchers take the runtime's
    current device): the SpMV, the SpMM through ``__call__`` and
    ``matmat``, each entering ``torch.cuda.device`` once with the matrix's
    device, here a CPU plan posing as one on cuda:1 (its operands stay on
    the CPU, so the plain versions run); a CPU matrix enters nothing."""
    _thresholds(monkeypatch)
    n = 8192
    rng = np.random.default_rng(6)
    rows, cols, vals = _fused_mm_matrix(n, rng)
    A, _ref = _port(n, rows, cols, vals, "float32")
    ex = A.csx.executors[0]
    entered = []

    class Guard:
        def __init__(self, device):
            entered.append(torch.device(device))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Guard)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    want = (ex(x), ex(X), ex.matmat(X))
    assert entered == []
    monkeypatch.setattr(ex, "device", torch.device("cuda", 1))
    monkeypatch.setattr(ex, "_as_vector", lambda v, name: v)
    got = (ex(x), ex(X), ex.matmat(X))
    assert entered == [torch.device("cuda", 1)] * 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_matmat_api_and_dim_errors(monkeypatch):
    """tests/test_spmm.py:91-110 on the port: matmat_mult / matmat_kernel,
    SPX_ERR_VEC_DIM on an X or Y of the wrong shape, a bf16 X computed in
    the matrix's dtype with a bf16 result."""
    _thresholds(monkeypatch)
    n = 8192
    rows, cols, vals = _fused_mm_matrix(n, np.random.default_rng(5))
    A, _ref = _port(n, rows, cols, vals, "float64")
    X = np.random.default_rng(0).standard_normal((n, 3))
    Y = spt.matmat_mult(1.0, A, X, device="cpu")
    ref = _oracle(n, rows, cols, vals.astype(np.float64), X)
    assert np.allclose(Y.numpy(), ref, rtol=1e-10, atol=1e-12)
    Y2 = spt.matmat_kernel(1.0, A, X, 1.0, Y)
    assert np.allclose(Y2.numpy(), 2 * ref, rtol=1e-10, atol=1e-12)
    for bad_x, bad_y in ((X[: n // 2], None), (X, np.zeros((n, 7))),
                         (X[:, 0], None)):
        with pytest.raises(spt.SparsexError) as ei:
            spt.matmat_kernel(1.0, A, bad_x, 1.0, bad_y)
        assert ei.value.code == spt.ErrorCode.SPX_ERR_VEC_DIM
    Xb = torch.from_numpy(X[:, :2].copy()).bfloat16()
    Yb = spt.matmat_mult(1.0, A, Xb)
    assert Yb.dtype == torch.bfloat16
    assert torch.equal(Yb, spt.matmat_mult(1.0, A, Xb.double()).bfloat16())
    with pytest.raises(spt.SparsexError):
        spt.matmat_mult(1.0, A, X, device="cuda:0")


def _sig(v):
    """A call argument as something comparable: tensors by shape, dtype
    and bytes."""
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype),
                hashlib.sha1(v.contiguous().numpy().tobytes()).hexdigest())
    if isinstance(v, (list, tuple)):
        return tuple(_sig(a) for a in v)
    return v


def _record_wrappers(monkeypatch, calls):
    """Record each kernel wrapper call as (launch key, argument
    signatures), the key carrying ``_kb`` where the operands are
    k-batched."""
    def key_of(name, a):
        if name == "k1":
            return tf.k1_key(a[5]) + ("_kb" if a[3].dim() == 4 else "")
        ref = tf._k3_ref(a[0], a[6], a[7]) if name == "k3" else a[0]
        dims = {"t1": 2, "k2": 3, "k3": 3, "lane_gather": 2}[name]
        return name + ("_kb" if ref.dim() > dims else "")

    for mod, name in ((tf, "k1"), (tf, "t1"), (tf, "k2"), (tf, "k3"),
                      (troute, "lane_gather")):
        def rec(*a, _f=getattr(mod, name), _n=name):
            calls.append((key_of(_n, a), _sig(a)))
            return _f(*a)
        monkeypatch.setattr(mod, name, rec)


@pytest.mark.parametrize("merged", [True, False])
def test_chip_smoke_spmm_phase_feeds_the_path_inputs(monkeypatch, merged):
    """chip_smoke's SpMM kernel phase (``kernel_phase`` on a k-major
    chunk) calls every kernel wrapper with exactly the inputs one chunk of
    the port's SpMM gives it, all k-batched; and ``expected_counts(meta,
    k)`` is the SpMM's calls: ceil(k/8) x the SpMV's, under ``_kb`` keys."""
    _thresholds(monkeypatch)
    n = 16384 if merged else 8192
    rows, cols, vals = _fused_mm_matrix(n, np.random.default_rng(7),
                                        runs=merged)
    A, _ref = _port(n, rows, cols, vals, "float64",
                    **{"spx.tpu.dia_min_fill": "0.9"})
    assert ("fall" in _mm_plan(A)) == merged
    ex = A.csx.executors[0]
    calls = []
    _record_wrappers(monkeypatch, calls)
    X = torch.as_tensor(np.random.default_rng(1).standard_normal((n, 11)))
    ex(X)
    counted = Counter(key for key, _ in calls)
    want = chip_smoke.expected_counts(ex.meta, 11)
    assert {key: v for key, v in want.items() if v} == dict(counted)
    assert set(counted) <= set(tf.KB_KERNELS)
    spmv = {key: 2 * v for key, v in
            chip_smoke.expected_counts(ex.meta).items() if v}
    assert {key[:-3]: v for key, v in counted.items()} == spmv
    calls.clear()
    ex(X[:, :8])
    path = set(calls)
    calls.clear()
    res = chip_smoke.kernel_phase(ex, X[:, :8].T.contiguous(), "cpu",
                                        timed=False)
    assert set(calls) == path
    assert set(res) == {key for key, _ in path}
