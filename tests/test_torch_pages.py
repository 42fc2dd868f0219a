"""The non-fused variants of sparsex_tpu_torch on the CPU.

The plain-table variant (the planner made no paged plan: standalone DIA
tables, plain run, block and delta tables) and the legacy paged variant
without a fused segment (the page-bucketed delta stream ``dpages``, paged
run and block tables, standalone DIA), through the port's plain versions
of its three kernels:

- ``dia_plain``, ``delta_pages_plain`` and ``gather_plain`` against the
  Pallas kernels (``pallas_kernels._build_dia_kernel``,
  ``_build_delta_kernel``, ``_build_gather_kernel``) in interpret mode:
  float32 within 1e-5 of the largest value, the gather exact;
- both variants end to end through ``mat_tune(..., device="cpu")`` /
  ``matvec_kernel`` against the reference executor in interpret mode and a
  float64 COO oracle: 1e-5 of the largest value in float32, 1e-12 in
  float64;
- ``chip_smoke.py``'s kernel phase for these paths calls each kernel with
  the inputs the port's SpMV gives it, and its launch counts derived from
  the plan are the path's;
- ``check_slice`` admits both variants and still refuses what is not
  ported, naming its ROADMAP.md queue item.
"""

import hashlib
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
from sparsex_tpu.csx import CsxMatrix as RefCsxMatrix
from sparsex_tpu.ops import kernels as ref_kernels
from sparsex_tpu.ops import route as route_mod
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import kernels as tk
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.kernels import check_slice

torch.set_num_threads(1)
L = 128


@pytest.fixture(autouse=True)
def fresh_port_config():
    """The port's Config is its own singleton: reset it around every test,
    as tests/conftest.py resets the reference's."""
    spt.Config.reset()
    yield
    spt.Config.reset()


def _thresholds(monkeypatch, page_nnz, route_elems):
    """The planners' thresholds, set alike on both packages so that they
    plan the same arrays."""
    for mod in (pk, tpk):
        monkeypatch.setattr(mod, "MIN_PAGE_NNZ", page_nnz)
    for mod in (route_mod, troute):
        monkeypatch.setattr(mod, "MIN_ELEMS", route_elems)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, bar):
    want = np.asarray(want, dtype=np.float64)
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(np.asarray(got, dtype=np.float64) - want).max()
    assert err <= bar * scale


# ---------------------------------------------------------------------------
# the three plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _dia_table(rng, offsets, nrows, ncols, anti, dtype):
    """(D, nrows) values, zero wherever the diagonal leaves the matrix."""
    r = np.arange(nrows)[None, :]
    o = np.asarray(offsets)[:, None]
    c = (o - r) if anti else (r + o)
    dv = rng.standard_normal((len(offsets), nrows)).astype(dtype)
    dv[(c < 0) | (c >= ncols)] = 0
    return dv


@pytest.mark.parametrize("nrows,ncols", [(70000, 70000), (70000, 90001),
                                         (69999, 50000)])
def test_dia_plain_matches_pallas(nrows, ncols):
    """Three 32,768-row tiles; offsets reach more than one tile away on
    both sides, so pad_lo and several x block quotients are exercised."""
    rng = np.random.default_rng(nrows + ncols)
    offsets = (-40000, -3, 0, 1, 777, 33000)
    dv = _dia_table(rng, offsets, nrows, ncols, False, np.float32)
    x = rng.standard_normal(ncols).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pk.dia_spmv_pallas(offsets, jnp.asarray(dv),
                                             jnp.asarray(x), nrows, ncols))
    got = tpk.dia_spmv(offsets, _t(dv), _t(x), nrows, ncols)
    assert got.shape == (nrows,) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_contrib_matches_reference(dtype):
    """A diagonal and an anti-diagonal table, ncols != nrows, through the
    reference's static DIA path on its Pallas branch (float32) or its XLA
    window sums (float64, which the reference never runs in Pallas)."""
    rng = np.random.default_rng(7)
    nrows, ncols = 70000, 80000
    diag = (-40000, 0, 2, 33000)
    anti = (ncols - 1, ncols - 40000, 100000)
    dias = [{"vals": _dia_table(rng, diag, nrows, ncols, False, dtype)},
            {"vals": _dia_table(rng, anti, nrows, ncols, True, dtype)}]
    meta = ((False, diag, len(diag)), (True, anti, len(anti)))
    x = rng.standard_normal(ncols).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want, _ = ref_kernels._dia_contrib_static(
            meta, [{"vals": jnp.asarray(t["vals"])} for t in dias],
            jnp.asarray(x), nrows, ncols, jnp.zeros(nrows, dtype),
            use_pallas=True)
    got = tk.dia_contrib(meta, [{"vals": _t(t["vals"])} for t in dias],
                         _t(x), nrows, ncols)
    _close(got.numpy(), np.asarray(want), 1e-5 if dtype == np.float32
           else 1e-12)
    # the anti-diagonal table contributes: the diagonal one alone differs
    alone = tk.dia_contrib(meta[:1], [{"vals": _t(dias[0]["vals"])}],
                           _t(x), nrows, ncols)
    assert not np.allclose(alone.numpy(), got.numpy())


def _delta_rep(rng, n, m, dtype):
    rows = rng.integers(0, n, m)
    cols = np.clip(rows + rng.integers(-3000, 3000, m), 0, n - 1)
    vals = rng.standard_normal(m).astype(dtype)
    rep, left = pk.build_delta_pages(cols, rows, vals, n, n)
    assert rep is not None and left.size < m // 4
    meta = (rep["plo"].size, rep.pop("q"), rep.pop("npages"))
    return rep, meta


def test_delta_pages_plain_matches_pallas():
    rng = np.random.default_rng(3)
    n, m = 1 << 15, 20000
    rep, meta = _delta_rep(rng, n, m, np.float32)
    T, q, _np = meta
    assert T * 1024 >= 16384 and q > 1
    x = rng.standard_normal(n).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pk.delta_pages_products(
            meta, {k: jnp.asarray(v) for k, v in rep.items()},
            jnp.asarray(x), n))
        want_y = np.asarray(pk.delta_pages_spmv(
            meta, {k: jnp.asarray(v) for k, v in rep.items()},
            jnp.asarray(x), n, n, jnp.zeros(n, np.float32)))
    trep = {"plo": _t(rep["plo"]), "sl": _t(rep["sl"]),
            "vals": _t(rep["vals"]), "rows": _t(rep["rows"])}
    assert trep["sl"].dtype == torch.int16
    assert trep["rows"].dtype == torch.int32
    got = tpk.delta_pages_products(meta, trep, _t(x), n)
    _close(got.numpy(), want, 1e-5)
    # the padding slots' sentinel row n is dropped, as the reference drops
    # it (its scatter-add's mode="drop")
    assert (rep["rows"] == n).any()
    acc = torch.zeros(n)
    tpk.delta_pages_spmv(meta, trep, _t(x), n, n, acc)
    _close(acc.numpy(), want_y, 1e-5)
    with pytest.raises(ValueError, match="nrows_part"):
        tpk.delta_pages_spmv(meta, trep, _t(x), n, n, torch.zeros(n + 1))


@pytest.mark.parametrize("T", [16, 13])
@pytest.mark.parametrize("sl_dtype", [np.int16, np.int32])
def test_gather_plain_matches_pallas(T, sl_dtype):
    """T % 8 == 0 (8 tiles per grid step) and T % 8 != 0 (one); some
    offsets lie outside the q-page window and read 0."""
    rng = np.random.default_rng(T)
    q, npages = 3, 20
    plo = rng.integers(0, npages - q + 1, T).astype(np.int32)
    sl = rng.integers(0, q * 1024 + 200, (T, 8, L)).astype(sl_dtype)
    x2 = rng.standard_normal((npages, 8, L)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pk._build_gather_kernel(T, q, "float32")(
            jnp.asarray(plo), jnp.asarray(sl), jnp.asarray(x2)))
    got = tpk.gather(_t(plo), _t(sl), _t(x2), q)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).mean() < 0.1


@pytest.mark.parametrize("form,width", [("runs", 5), ("runs", 8),
                                        ("diag", 3), ("blocks", 3),
                                        ("blocks", 2)])
def test_paged_units_plain_matches_reference(form, width):
    """The paged-units kernel's plain version against the reference's own
    composition on a unit-page plan: the paged gather in interpret mode
    times the values, summed per unit (a horizontal run table), per block
    row (a block table of width x width blocks) or not at all (a diagonal
    run table, one product per row)."""
    rng = np.random.default_rng(width)
    n, U = 1 << 15, 9000
    W = width
    base = np.sort(rng.integers(0, n - 3000, U))
    flat = (base[:, None] + np.arange(W)).reshape(-1)
    order, n_page, plan = pk.build_unit_pages(flat, W, n)
    assert plan is not None and 0 < n_page <= U
    vshape = (n_page, W, W) if form == "blocks" else (n_page, W)
    vals = rng.standard_normal((U,) + vshape[1:])[order][:n_page]
    x = rng.standard_normal(n)
    sig = (plan["T"], plan["q"], plan["g"], plan["npages"])
    with pltpu.force_tpu_interpret_mode():
        xg = np.asarray(pk.paged_gather(
            sig, {k: jnp.asarray(plan[k]) for k in ("plo", "sl")},
            jnp.asarray(x.astype(np.float32)), n, W)).astype(np.float64)
    if form == "blocks":
        want = (vals * xg[:, None, :]).sum(-1)
    elif form == "runs":
        want = (vals * xg).sum(-1)
    else:
        want = vals * xg
    x2 = tpk.pad_x_pages(_t(x.astype(np.float32)).double(), n, plan["q"],
                         plan["npages"])
    got = tpk.paged_units_plain(_t(plan["plo"]), _t(plan["sl"]), _t(vals),
                                x2, plan["q"], form == "diag")
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert torch.equal(tpk.paged_units(_t(plan["plo"]), _t(plan["sl"]),
                                       _t(vals), x2, plan["q"],
                                       form == "diag"), got)
    # the scatter form adds the partials into acc[dest], dropping rows
    # outside [0, n)
    dest = torch.as_tensor(rng.integers(-2, n + 2, got.numel()))
    acc = torch.as_tensor(rng.standard_normal(n))
    ok = (dest >= 0) & (dest < n)
    want_acc = acc.clone().index_add_(0, dest[ok], got.reshape(-1)[ok])
    out = tpk.paged_units(_t(plan["plo"]), _t(plan["sl"]), _t(vals), x2,
                          plan["q"], form == "diag", acc, dest)
    assert out is acc and torch.allclose(acc, want_acc, rtol=0, atol=1e-12)


def test_paged_units_rejects_bad_arguments():
    plo = torch.zeros(2, dtype=torch.int32)
    sl = torch.zeros(2, 8, L, dtype=torch.int32)
    x2 = torch.zeros(4, 8, L)
    tpk.paged_units(plo, sl, torch.zeros(2 * 204, 5), x2, 2)
    with pytest.raises(ValueError, match="T\\*g"):     # T*g = 408 units
        tpk.paged_units(plo, sl, torch.zeros(400, 5), x2, 2)
    with pytest.raises(ValueError, match="row sums"):
        tpk.paged_units(plo, sl, torch.zeros(2 * 341, 3, 3), x2, 2, True)
    with pytest.raises(TypeError):
        tpk.paged_units(plo, sl, torch.zeros(2 * 204, 5, dtype=torch.float64),
                        x2, 2)


def test_page_wrappers_reject_bad_arguments():
    x2 = torch.zeros(4, 8, L)
    plo = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        tpk.gather(plo, torch.zeros(2, 8, L, dtype=torch.int64), x2, 2)
    with pytest.raises(TypeError):      # the delta stream keeps int16 sl
        tpk.delta_pages(plo, torch.zeros(2, 8, L, dtype=torch.int32),
                        torch.zeros(2, 8, L), x2, 2)
    with pytest.raises(ValueError):
        tpk.gather(plo, torch.zeros(2, 8, L, dtype=torch.int16), x2, 5)
    with pytest.raises(ValueError):
        tpk.dia(torch.zeros(2, 10), torch.zeros(12), (0, 3), 0)


# ---------------------------------------------------------------------------
# both variants end to end
# ---------------------------------------------------------------------------

def combined_matrix(n=1 << 15, seed=4):
    """Headline-like plus blocky-like at 2^15: five dense diagonals, 8000
    4x2 blocks, 4000 width-8 runs and 20000 random singles."""
    rng = np.random.default_rng(seed)
    br0 = rng.integers(0, (n - 4) // 4, 8000) * 4
    bc0 = rng.integers(0, (n - 2) // 2, 8000) * 2
    ii, jj = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
    hr = rng.integers(0, n, 4000)
    hc = rng.integers(0, n - 8, 4000)
    d = np.arange(n)
    drows = [d[(d + o >= 0) & (d + o < n)] for o in (-13, -1, 0, 1, 8)]
    dcols = [r + o for r, o in zip(drows, (-13, -1, 0, 1, 8))]
    rows = np.concatenate([(br0[:, None, None] + ii[None]).ravel(),
                           np.repeat(hr, 8), rng.integers(0, n, 20000)]
                          + drows)
    cols = np.concatenate([(bc0[:, None, None] + jj[None]).ravel(),
                           (hc[:, None] + np.arange(8)[None]).ravel(),
                           rng.integers(0, n, 20000)] + dcols)
    key = rows.astype(np.int64) * n + cols
    _, u = np.unique(key, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    return n, rows[o], cols[o], rng.standard_normal(rows.size)


def _tune(n, rows, cols, vals, dtype, **options):
    """The port's matrix on the CPU and the reference executor of the same
    matrix, both tuned under the same options."""
    options = {"spx.tpu.value_dtype": dtype, "spx.preproc.xform": "all",
               **options}
    for cfg in (spt.Config.instance(), RefConfig.instance()):
        for key, value in options.items():
            cfg.set(key, value)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    A = spt.mat_tune(spt.input_load_csr(rowptr, cols, vals.astype(dtype),
                                        n, n), device="cpu")
    ref = RefCsxMatrix.from_coo(n, n, rows, cols, vals.astype(dtype))
    ref = ref.executors[0]
    ref._maybe_build_pages()
    return A, ref


def _extras(meta):
    return {e[0]: e[1:] for e in meta[5:] if e}


def _check_path(A, ref, n, rows, cols, vals, dtype, bar):
    """matvec_kernel at alpha=1/beta=0 and alpha=2/beta=0.5 against the
    float64 COO oracle, and at alpha=1 against the reference executor in
    interpret mode; no kernel launch on the CPU."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n).astype(dtype)
    y0 = rng.standard_normal(n).astype(dtype)
    want = np.bincount(rows, weights=vals.astype(dtype).astype(np.float64)
                       * x.astype(np.float64)[cols], minlength=n)
    before = tf.launch_counts()
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    y2 = spt.matvec_kernel(2.0, A, x, 0.5, y0)
    assert tf.launch_counts() == before
    assert y.shape == (n,) and y.dtype == getattr(torch, dtype)
    _close(y.numpy(), want, bar)
    _close(y2.numpy(), 2.0 * want + 0.5 * y0, bar)
    with pltpu.force_tpu_interpret_mode():
        yr = np.asarray(ref(jnp.asarray(x)))
    _close(y.numpy(), yr, bar)


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5),
                                       ("float64", 1e-12)])
def test_hpcg_stencil_plain_table_variant(monkeypatch, dtype, bar):
    """The 16^3 HPCG stencil plans no paged variant: one DIA table of 27
    diagonals and nothing else, run by the DIA kernel's plain version."""
    monkeypatch.setattr(pk, "dia_pallas_ok", lambda: True)
    n, rows, cols, vals = chip_smoke.hpcg_matrix(16)
    A, ref = _tune(n, rows, cols, vals, dtype,
                   **{"spx.preproc.sampling": "none"})
    assert ref._pages_meta is None
    meta = A.csx.executors[0].meta
    assert A.csx.executors[0].variant == "plain"
    assert meta == ref.meta and meta[2:4] == ((), ())
    assert [(anti, len(offs)) for anti, offs, _ in meta[4]] == [(False, 27)]
    assert ref.arrays["delta"] is None
    assert A.csx.executors[0].arrays["delta"] is None
    _check_path(A, ref, n, rows, cols, vals, dtype, bar)


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5),
                                       ("float64", 1e-12)])
def test_paged_variant_without_fused_segment(monkeypatch, dtype, bar):
    """Above ``spx.tpu.min_fused_nnz`` nothing fuses and, with the route
    planner's minimum out of reach, nothing is routed: the legacy paged
    variant with the paged delta stream, a paged run table, a plain run
    table, a paged block table and a standalone DIA table."""
    monkeypatch.setattr(pk, "dia_pallas_ok", lambda: True)
    _thresholds(monkeypatch, 1024, 1 << 30)
    n, rows, cols, vals = combined_matrix()
    A, ref = _tune(n, rows, cols, vals, dtype,
                   **{"spx.preproc.sampling": "none",
                      "spx.tpu.min_fused_nnz": str(rows.size + 1)})
    meta = A.csx.executors[0].meta
    # the reference's plan, its paged delta stream laid out in row blocks
    assert meta[:5] == ref._pages_meta[:5]
    assert set(_extras(ref._pages_meta)) == {"dpages"}
    assert set(_extras(meta)) == {"drows"}
    assert _extras(meta)["drows"][2] == _extras(ref._pages_meta)["dpages"][2]
    assert [e[:3] for e in meta[4]] == [(False, (-13, -1, 0, 1, 8), 5)]
    runs = {e[2]: e for e in meta[2]}
    assert set(runs) == {4, 8} and runs[4][3] is None and runs[8][3]
    assert all(len(e) == 5 and e[4] is None for e in meta[2] + meta[3])
    (blk,) = meta[3]
    assert blk[1:3] == (4, 2) and blk[3]
    arrays = A.csx.executors[0].arrays
    dr = arrays["delta_rows"]
    assert "delta_pages" not in arrays
    assert dr["sl"].dtype == torch.int16 and dr["lrow"].dtype == torch.int16
    _check_path(A, ref, n, rows, cols, vals, dtype, bar)


def test_paged_tables_keep_their_unit_order(monkeypatch):
    """A paged table's units are reordered by the planner; the port uploads
    the reordered rows, cols and vals, and its partials (the paged-units
    kernel's for the first T*g units, the clipped gather's for the tail)
    are the block rows' sums over those units, left to right."""
    _thresholds(monkeypatch, 1024, 1 << 30)
    n, rows, cols, vals = combined_matrix()
    A, ref = _tune(n, rows, cols, vals, "float64",
                   **{"spx.preproc.sampling": "none",
                      "spx.tpu.min_fused_nnz": str(rows.size + 1)})
    ex = A.csx.executors[0]
    host = ref._pages_arrays
    for entry, h, d in zip(ex.meta[3], host["blocks"], ex.arrays["blocks"]):
        np.testing.assert_array_equal(d["rows"].numpy(), h["rows"])
        np.testing.assert_array_equal(d["vals"].numpy(), h["vals"])
        assert d["plan"]["sl"].dtype == torch.int32
        T, _q, g, _np = entry[3]
        x = torch.as_tensor(np.random.default_rng(2).standard_normal(n))
        steps = torch.arange(entry[2])
        got, dest = tk.unit_table_partials("blocks", entry, d, x, n, n,
                                           tk.paged_grid(ex.meta, x, n))
        assert torch.equal(dest, (d["rows"][:, None] + torch.arange(
            entry[1])).clamp(0, n - 1).reshape(-1))
        xg = x[(d["cols"][:, None] + steps).clamp(0, n - 1)]
        want = torch.zeros(d["vals"].shape[:2], dtype=x.dtype)
        for c in range(entry[2]):
            want = want + d["vals"][..., c] * xg[:, None, c]
        assert d["cols"].shape[0] >= T * g
        assert torch.equal(got, want)


def test_plan_to_torch_checks_the_page_windows(monkeypatch):
    """The CUDA page kernels read x2 unchecked, so the upload refuses a
    window outside the page grid and a delta row past the sentinel."""
    from sparsex_tpu_torch.ops import convert
    _thresholds(monkeypatch, 1024, 1 << 30)
    n, rows, cols, vals = combined_matrix()
    _A, ref = _tune(n, rows, cols, vals, "float32",
                    **{"spx.preproc.sampling": "none",
                       "spx.tpu.min_fused_nnz": str(rows.size + 1)})
    meta, host = ref._pages_meta, ref._pages_arrays
    for table in (host["delta_pages"], host["runs"][1]["plan"],
                  host["blocks"][0]["plan"]):
        plo = table["plo"]
        table["plo"] = plo.copy()
        table["plo"][-1] = 1 << 20
        with pytest.raises(ValueError, match="windows outside"):
            convert.plan_to_torch(meta, host, "cpu", torch.float32)
        table["plo"] = plo
    dp_rows = host["delta_pages"]["rows"]
    host["delta_pages"]["rows"] = dp_rows.copy()
    host["delta_pages"]["rows"][0] = n + 1
    with pytest.raises(ValueError, match="delta_pages rows"):
        convert.plan_to_torch(meta, host, "cpu", torch.float32)
    host["delta_pages"]["rows"] = dp_rows
    convert.plan_to_torch(meta, host, "cpu", torch.float32)


def _sig(v):
    """A call argument as something comparable: tensors by shape, dtype
    and bytes."""
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype),
                hashlib.sha1(v.contiguous().numpy().tobytes()).hexdigest())
    if isinstance(v, (list, tuple)):
        return tuple(_sig(a) for a in v)
    return v


def _units_sig(a, at=6):
    """A paged-units call's arguments as something comparable: no trailing
    None, and the scatter epilogue's accumulator (argument ``at``; 5 for
    the delta-pages epilogue, 6 for its row-blocked form), which holds what
    the SpMV added before the
    table, by shape and dtype alone."""
    a = list(a)
    while a and a[-1] is None:
        a.pop()
    if len(a) > at:
        a[at] = (tuple(a[at].shape), str(a[at].dtype))
    return _sig(a)


def record_calls(monkeypatch, wrappers, calls):
    """Wrap each (module, function, name) of ``wrappers`` so that a call
    appends (name, its arguments as something comparable) to ``calls``;
    ``ops.kernels`` reaches the paged-units and row-blocked delta wrappers
    through their own names."""
    for mod, fn, name in wrappers:
        def rec(*a, _f=getattr(mod, fn), _n=name):
            calls.append((_n, _units_sig(a) if _n == "paged_units"
                          else _units_sig(a, 5) if _n == "delta_pages_acc"
                          else _units_sig(a, 6) if _n == "delta_rowblock_acc"
                          else _sig(a)))
            return _f(*a)
        monkeypatch.setattr(mod, fn, rec)
    monkeypatch.setattr(tk, "paged_units", tpk.paged_units)
    monkeypatch.setattr(tk, "delta_rowblock_acc", tpk.delta_rowblock_acc)


@pytest.mark.parametrize("kinds", [("hpcg",), ("headline", "blocky"),
                                   ("urand",)])
def test_chip_smoke_pages_phase_feeds_the_path_inputs(monkeypatch, kinds):
    """chip_smoke's plan check passes on both variants and on both layouts
    of the paged delta stream, its kernel phase calls each wrapper with
    exactly the inputs the port's SpMV gives it, and the launch counts it
    derives from the plan are the SpMV's calls.  The combined matrix's
    stream keeps the planner's layout, as headline and blocky 2^22's do:
    with row blocks of 1,024 rows (RB_SMEM cut to 8 KB) its singles are too
    sparse for them, as those streams' are for 16,384; a urand graph's is
    laid out in row blocks."""
    _thresholds(monkeypatch, 1024, 1 << 30)
    opts = {"spx.preproc.sampling": "none"}
    if kinds == ("hpcg",):
        n, rows, cols, vals = chip_smoke.hpcg_matrix(16)
    elif kinds == ("urand",):
        n = 1 << 14
        rows, cols, vals = chip_smoke.urand_matrix(n)
    else:
        n, rows, cols, vals = combined_matrix()
        opts["spx.tpu.min_fused_nnz"] = str(rows.size + 1)
        monkeypatch.setattr(tpk, "RB_SMEM", 8 * 1024)
    A, _ref = _tune(n, rows, cols, vals, "float64", **opts)
    calls = []
    names = {"dia": "dia", "delta_pages": "delta_pages",
             "delta_pages_acc": "delta_pages_acc",
             "delta_rowblock_acc": "delta_rowblock_acc",
             "gather": "paged_gather", "paged_units": "paged_units"}
    record_calls(monkeypatch, [(tpk, fn, name) for fn, name in names.items()],
                 calls)
    x =torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    A.csx.executors[0](x)
    path = list(calls)
    calls.clear()
    mat = SimpleNamespace(csx=A.csx)
    for kind in kinds:
        ex = chip_smoke.check_pages_plan(mat, kind, "cpu")
    res = chip_smoke.kernel_phase(ex, x, "cpu", timed=False)
    # the unit-page gather left the path for the paged-units kernel; the
    # phase still holds it on each paged table's window stream
    gathers = [c for c in calls if c[0] == "paged_gather"]
    assert set(calls) - set(gathers) == set(path)
    assert len(gathers) == len(chip_smoke.paged_tables(ex.meta))
    counted = Counter(name for name, _ in path)
    want = chip_smoke.expected_counts(ex.meta)
    assert {k: want[k] for k in names.values()} == {
        k: counted[k] for k in names.values()}
    assert set(res) == set(counted) | ({"paged_gather"} if gathers else set())
    assert want["dia"] == (kinds != ("urand",))
    assert sum(want.values()) == len(path)


# ---------------------------------------------------------------------------
# what check_slice admits and refuses
# ---------------------------------------------------------------------------

_DIA = ((False, (-1, 0, 1), 3), (True, (40,), 1))
_PRUN = (1, 1, 8, (15, 3, 128, 32), None)
_PBLK = (8, 4, 2, (15, 4, 512, 32), None)


def test_check_slice_admits_both_variants():
    check_slice((1 << 14, 1 << 14, ((1, 1, 8), (2, 1, 4)), ((8, 4, 2),),
                 _DIA))
    check_slice((1 << 14, 1 << 14, (_PRUN, (1, 1, 4, None, None)),
                 (_PBLK,), _DIA, ("dpages", 12, 4, 16)))


@pytest.mark.parametrize("runs,blocks,dias,extras,item", [
    ((), (), (), (("dpages", 12, 4, 16),
                  ("dsfused", 8, 4, 32, (), False, "lp")), "'dsfused'"),
    ((), (), ((False, None, 3),), (), "dynamic"),
])
def test_check_slice_still_refuses(runs, blocks, dias, extras, item):
    with pytest.raises(NotImplementedError, match=item):
        check_slice((1 << 14, 1 << 14, runs, blocks, dias) + extras)


@pytest.mark.parametrize("runs,blocks,dias,extras", [
    ((), (), _DIA, (("dpages", 12, 4, 16), ("dscatter", (), False))),
    # a symmetric shard's transposed delta stream, without and with its
    # scatter route (ROADMAP Queue 1 item 8)
    ((), (), _DIA, (("dpages", 12, 4, 16), ("dpagesT", 12, 4, 16))),
    ((), (), _DIA, (("dpages", 12, 4, 16), ("dpagesT", 12, 4, 16),
                    ("dscatter", (), False), ("dscatterT", (), True))),
    ((_PRUN[:4] + (("fs", (), False, 128),),), (), (),
     (("fall", (("delta",),), (), (), (("bres", 0, 0),)),)),
    ((), (_PBLK[:5] + (("fblk", (), 0),),), (), ()),
    ((_PRUN[:4] + (((), False, 1024),),), (), (), ()),
])
def test_check_slice_admits_the_legacy_routes(runs, blocks, dias, extras):
    """The paged delta's scatter route (``dscatter``), the merged plan's
    ``bres`` residuals, fused block tables (``fblk``) and a paged run
    table's legacy scatter plan run since ROADMAP Queue 1 item 10 was
    ported, a symmetric shard's ``dpagesT`` and ``dscatterT`` since item 8
    (they were refused before)."""
    check_slice((1 << 14, 1 << 14, runs, blocks, dias) + extras)


def test_check_slice_admits_partial_segments():
    """Paged run and block tables routed through a partial segment (``fs``)
    run since the fs route was ported."""
    fs = ("fs", (), False, 128)
    check_slice((1 << 14, 1 << 14, (_PRUN[:4] + (fs,),), (_PBLK[:4] + (fs,),),
                 _DIA, ("dpages", 12, 4, 16)))
