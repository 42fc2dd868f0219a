"""The legacy routed scatters and the fblk chain of sparsex_tpu_torch on the
CPU (ROADMAP Queue 1 item 10).

With the fused pipeline kept off (``spx.tpu.min_fused_nnz`` above the
nonzeros) the planners route a paged delta stream's products through a
static scatter plan (``dscatter``: ``route.apply_scatter_plan``, five lane
gathers per route instance), and a block table whose fused run plan fails
takes the fblk chain: the unit-page gather of its x values in (T, 8, 128)
grid form, per block row a multiply and log-step lane-roll sums, each
row's stream through a routed segment of its own or through the merged
plan (``blk`` segments, ``bres`` residuals).  Small inputs that take these
classes, each against the reference (Pallas in interpret mode) and a
float64 COO oracle:

- (a) ``apply_scatter_plan`` alone, on ``build_scatter_plan`` over seeded
  random destinations (4096 and 16384 rows, padding lanes, over-capacity
  residuals), against the reference's and the NumPy twin;
- (b) the routed delta end to end: 4096 random singles rows
  (``tests/test_route.py:220-250``, ``xform=none``, its thresholds);
- (c) the fblk chain alone: the 4x2-block matrix of
  ``tests/test_fused.py:317-356`` (its ``MIN_ELEMS`` = 64) with
  ``build_fused_run`` failing in both packages, with and without its
  merged plan, and an unpageable tail;
- (d) ``test_torch_plan.py``'s ``paged_routed`` case (blocky 2^16 under
  ``spx.tpu.min_fused_nnz`` and ``MIN_PAGE_NNZ`` / ``MIN_ELEMS`` = 1024:
  ``dscatter``, an ``fs`` run table, an fblk table in a merged plan) and
  its SpMM (k = 3);
- (e) a paged run table routed through a legacy scatter plan, against the
  same table scatter-added by ``index_add_``;
- chip_smoke.py's two nofuse paths at their full 2^20 rows on the CPU,
  against the oracle only.

Bars: 1e-5 relative (max |y - ref| / max |ref|) in float32, 1e-10 in
float64; equal where the same sums run in the same order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import sparsex_tpu.ops.exec as ref_exec
import sparsex_tpu.ops.fused as fused
import sparsex_tpu.ops.pallas_kernels as pk
from sparsex_tpu.config import Config as RefConfig
from sparsex_tpu.csx import CsxMatrix as RefCsxMatrix
from sparsex_tpu.ops import route as route_mod
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.ops import convert
from sparsex_tpu_torch.ops import exec as texec
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import kernels as tk
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from test_torch_cuda import route_singles
from test_torch_fs import run_per_row_matrix

torch.set_num_threads(1)
L = 128
BARS = {"float32": 1e-5, "float64": 1e-10}
_NO_FUSE = {"spx.tpu.min_fused_nnz": str(1 << 30)}


@pytest.fixture(autouse=True)
def fresh_port_config():
    """The port's Config is its own singleton: reset it around every test,
    as tests/conftest.py resets the reference's."""
    spt.Config.reset()
    yield
    spt.Config.reset()


def _thresholds(monkeypatch, page_nnz=None, elems=None):
    """The paged and routed planners' gates, alike on both packages."""
    for mod, name, value in ((pk, "MIN_PAGE_NNZ", page_nnz),
                             (tpk, "MIN_PAGE_NNZ", page_nnz),
                             (route_mod, "MIN_ELEMS", elems),
                             (troute, "MIN_ELEMS", elems)):
        if value is not None:
            monkeypatch.setattr(mod, name, value)
    # the reference's paged variant on the CPU (interpret mode)
    monkeypatch.setattr(pk, "dia_pallas_ok", lambda: True)


def _tune(n, rows, cols, vals, dtype, **options):
    """The port's matrix on the CPU and the reference executor of the same
    matrix, tuned under the same options, both planned."""
    vals = np.asarray(vals).astype(dtype)
    opts = {"spx.tpu.value_dtype": dtype, "spx.preproc.xform": "all",
            "spx.preproc.sampling": "portion", **options}
    for cfg in (spt.Config.instance(), RefConfig.instance()):
        for key, value in opts.items():
            cfg.set(key, value)
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    ref = RefCsxMatrix.from_coo(n, n, rows, cols, vals).executors[0]
    ref._maybe_build_pages()
    assert A.csx.executors[0].meta == ref._pages_meta
    return vals, A, ref


def _oracle(rows, cols, vals, x, n):
    return np.bincount(rows, weights=np.asarray(vals, np.float64)
                       * np.asarray(x, np.float64)[cols], minlength=n)


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    return (np.abs(np.asarray(got, dtype=np.float64) - want).max()
            / np.abs(want).max())


def _against_both(A, ref, rows, cols, vals, dtype, seed=1):
    """One SpMV of the port against the reference executor and the COO
    oracle, within the type's bar; returns the port's y."""
    n = A.nrows
    x = np.random.default_rng(seed).standard_normal(n).astype(dtype)
    before = tf.launch_counts()
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    assert tf.launch_counts() == before          # no launch on the CPU
    assert y.shape == (n,) and y.dtype == getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        if dtype == "float32":                   # the reference's paged run
            assert ref._pages_active()
        yr = np.asarray(ref(jnp.asarray(x)))
    assert _rel(y.numpy(), yr) < BARS[dtype]
    assert _rel(y.numpy(), _oracle(rows, cols, vals, x, n)) < BARS[dtype]
    return y


def _extras(meta):
    return {e[0] for e in meta[5:] if e}


# ---------------------------------------------------------------------------
# (a) apply_scatter_plan alone
# ---------------------------------------------------------------------------

def _scatter_case(n_dest, M, seed):
    """Destinations grouped by capacity fold (as the planner's callers sort
    them), 5 % padding lanes; a plan with residuals."""
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, n_dest, M)
    dest = dest[np.argsort(troute.fold_sort_key(dest, n_dest, np.arange(M)),
                           kind="stable")]
    dest[rng.random(M) < 0.05] = -1
    plan = troute.build_scatter_plan(dest, n_dest, min_elems=64)
    assert plan is not None and plan[2].size
    return dest, plan


@pytest.mark.parametrize("n_dest,M", [(4096, 128 * 256),
                                      (16384, 128 * 1024)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_apply_scatter_plan_matches_reference(n_dest, M, dtype):
    """The port's routed scatter-add equals the reference's (interpret
    mode) bit for bit and the NumPy twin's, and with its residuals added
    the dense scatter-add of the source."""
    dest, (metas, arrays, res_pos, res_dest) = _scatter_case(n_dest, M, M)
    src = np.random.default_rng(1).standard_normal(M).astype(dtype)
    up = convert._upload_scatter({"chunks": arrays, "res_pos": res_pos,
                                  "res_dest": res_dest}, "cpu")
    assert all(w.dim() == 3 for c in up["chunks"] for w in c.values())
    got = troute.apply_scatter_plan(metas, up["chunks"],
                                    torch.from_numpy(src), n_dest)
    assert got.shape == (n_dest,) and got.dtype == getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(route_mod.apply_scatter_plan(
            metas, arrays, jnp.asarray(src), n_dest))
    assert np.array_equal(got.numpy(), want)
    np_y = troute.apply_scatter_plan_np(metas, arrays, src, n_dest)
    assert _rel(got.numpy(), np_y) < BARS[dtype]
    full = got.clone()
    tf.add_totals(full, torch.from_numpy(src)[up["res_pos"]],
                  up["res_dest"])
    ok = dest >= 0
    assert _rel(full.numpy(), np.bincount(dest[ok], weights=src[ok].astype(
        np.float64), minlength=n_dest)) < BARS[dtype]


def test_apply_scatter_plan_stages():
    """``gather`` sees the five lane gathers of each instance, each input
    whole 128-lane rows, contiguous, in the shapes the route metas give."""
    _dest, (metas, arrays, rp, rd) = _scatter_case(4096, 128 * 256, 7)
    up = convert._upload_scatter({"chunks": arrays, "res_pos": rp,
                                  "res_dest": rd}, "cpu")
    seen = []

    def gather(x, idx):
        seen.append((tuple(x.shape), x.is_contiguous(), tuple(idx.shape)))
        return troute.lane_gather(x, idx)

    troute.apply_scatter_plan(metas, up["chunks"], torch.ones(128 * 256),
                              4096, gather=gather)
    want = []
    for m in metas:
        S1c, S1p, A2R, D2R, Dp, K, W2 = m[:7]
        want += [((S1p, L), True, (1, S1p, L)),
                 ((L * A2R, L), True, (1, L * A2R, L)),
                 ((L * W2, L), True, (1, L * W2, L)),
                 ((L * D2R, L), True, (1, L * D2R, L)),
                 ((Dp, L), True, (K, Dp, L))]
    assert seen == want


# ---------------------------------------------------------------------------
# (b) the routed delta (dscatter) end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dscatter_matches_reference_and_oracle(monkeypatch, dtype):
    n = 4096
    _thresholds(monkeypatch, page_nnz=64, elems=64)
    rows, cols, vals = route_singles(n)
    vals, A, ref = _tune(n, rows, cols, vals, dtype,
                         **{"spx.preproc.xform": "none"})
    ex = A.csx.executors[0]
    assert _extras(ex.meta) == {"dpages", "dscatter"}
    ds = ex.arrays["delta_scatter"]
    assert all(w.dtype == torch.int8 for c in ds["chunks"]
               for w in c.values())
    _against_both(A, ref, rows, cols, vals, dtype)


# ---------------------------------------------------------------------------
# (c) the fblk chain
# ---------------------------------------------------------------------------

def _fblk_matrix(n=1 << 15):
    """8000 4x2 blocks at random (row, col) on a 4 x 2 grid
    (tests/test_fused.py:317-356)."""
    rng = np.random.default_rng(4)
    br0 = rng.integers(0, (n - 4) // 4, 8000) * 4
    bc0 = rng.integers(0, (n - 2) // 2, 8000) * 2
    ii, jj = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
    rows = (br0[:, None, None] + ii[None]).ravel()
    cols = (bc0[:, None, None] + jj[None]).ravel()
    key = rows.astype(np.int64) * n + cols
    _, u = np.unique(key, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    return rows, cols, rng.standard_normal(rows.size)


def _fblk_tune(monkeypatch, dtype, merged):
    """The fblk matrix with ``build_fused_run`` failing in both packages
    (and, unless ``merged``, the merged plan too)."""
    _thresholds(monkeypatch, page_nnz=1024, elems=64)
    fail = lambda *a, **k: (None, None, None, 0)   # noqa: E731
    monkeypatch.setattr(fused, "build_fused_run", fail)
    monkeypatch.setattr(texec, "build_fused_run", fail)
    if not merged:
        for cls in (ref_exec.CsxExecutor, texec.HostPlan):
            monkeypatch.setattr(cls, "_merge_fused_segments",
                                lambda *a, **k: None)
    n = 1 << 15
    rows, cols, vals = _fblk_matrix(n)
    vals, A, ref = _tune(n, rows, cols, vals, dtype)
    meta = A.csx.executors[0].meta
    (entry,) = [e for e in meta[3] if tk._kind(e) == "fblk"]
    assert ("fall" in _extras(meta)) is merged
    return n, rows, cols, vals, A, ref


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fblk_matches_reference_and_oracle(monkeypatch, dtype, merged):
    """The fblk chain alone: each block row's stream through its own
    routed segment with its residuals (``fb_{r}``, raw g2b wires at
    upload), or through the merged plan with ``bres`` residuals."""
    n, rows, cols, vals, A, ref = _fblk_tune(monkeypatch, dtype, merged)
    ex = A.csx.executors[0]
    (bi, entry), = chip_smoke.fblk_tables(ex.meta)
    t = ex.arrays["blocks"][bi]
    assert t["valsg"].shape[0] == entry[1] == len(entry[5][1])
    for r, (inst, _res, _m) in enumerate(entry[5][1]):
        assert (f"fb_{r}" in t) is not merged
        for i, m in enumerate(inst if not merged else ()):
            if m[9] & 1:      # an unmasked instance: raw wires
                assert int(t[f"fb_{r}"][f"g2b_{i}"].max()) < -(
                    -m[2] // 8) * 8
    if merged:
        res = {rd[0] for rd in next(e for e in ex.meta[5:]
                                    if e[0] == "fall")[4]}
        assert res <= {"bres"}
        fa = ex.arrays["fall"]
        assert all(v.dtype == torch.int64 for k, v in fa.items()
                   if k.startswith("bres_"))
    _against_both(A, ref, rows, cols, vals, dtype)


def test_fblk_streams_are_the_reference_partials(monkeypatch):
    """Each block row's stream (``kernels.fblk_streams``: the unit-page
    gather, the products with ``valsg[r]``, the lane rolls) sums, at each
    unit's last lane, that unit's block row; every other lane is a partial
    sum the routes never read (their destination is the padding row)."""
    n, rows, cols, vals, A, _ref = _fblk_tune(monkeypatch, "float64", False)
    ex = A.csx.executors[0]
    (bi, entry), = chip_smoke.fblk_tables(ex.meta)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(n))
    streams = tk.fblk_streams(ex.meta, ex.arrays, x, n,
                              tk.paged_grid(ex.meta, x, n))
    _enc, br, bc, (T, q, g, _np) = entry[:4]
    t = ex.arrays["blocks"][bi]
    xg = tpk.gather_plain(t["plan"]["plo"], t["plan"]["sl"],
                          tk.paged_grid(ex.meta, x, n), q).reshape(T * g, bc)
    vg = t["valsg"].reshape(br, T * g, bc)
    for r in range(br):
        flat = streams[(bi, r)]
        assert flat.shape == (T * 1024,)
        ends = flat.view(T * g, bc)[:, bc - 1]
        assert torch.allclose(ends, (vg[r] * xg).sum(1), rtol=1e-13,
                              atol=1e-13)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fblk_unpageable_tail(monkeypatch, dtype):
    """An fblk table's unpageable tail (``tail_rows`` / ``tail_cols`` /
    ``tail_vals``, ``n_tail`` in its meta: the reference's einsum into the
    residual adds, kernels.py:629-640) adds its blocks' products; the
    planner demotes a tail to the delta, so the tail here is made by
    hand: 300 random 4x2 blocks."""
    n, rows, cols, vals, A, _ref = _fblk_tune(monkeypatch, dtype, False)
    ex = A.csx.executors[0]
    (bi, entry), = chip_smoke.fblk_tables(ex.meta)
    rng = np.random.default_rng(9)
    nt = 300
    tr = rng.integers(0, n - 4, nt)
    tc = rng.integers(0, n - 2, nt)
    tv = rng.standard_normal((nt, 4, 2)).astype(dtype)
    meta = list(ex.meta)
    blocks = list(meta[3])
    blocks[bi] = entry[:5] + (("fblk", entry[5][1], nt),)
    meta[3] = tuple(blocks)
    arrs = dict(ex.arrays)
    arrs["blocks"] = list(arrs["blocks"])
    arrs["blocks"][bi] = dict(arrs["blocks"][bi], **{
        "tail_rows": torch.from_numpy(tr), "tail_cols": torch.from_numpy(tc),
        "tail_vals": torch.from_numpy(tv)})
    x = np.random.default_rng(3).standard_normal(n).astype(dtype)
    xt = torch.from_numpy(x)
    got = tk.local_contrib(tuple(meta), arrs, xt, nrows_part=n, ncols=n)
    base = tk.local_contrib(ex.meta, ex.arrays, xt, nrows_part=n, ncols=n)
    r4 = (tr[:, None, None] + np.arange(4)[None, :, None]).repeat(2, 2)
    c2 = (tc[:, None, None] + np.arange(2)[None, None, :]).repeat(4, 1)
    want = _oracle(rows, cols, vals, x, n) + _oracle(
        r4.ravel(), c2.ravel(), tv.ravel(), x, n)
    assert _rel(got.numpy(), want) < BARS[dtype]
    assert not torch.equal(got, base)


# ---------------------------------------------------------------------------
# (d) the paged_routed plan end to end
# ---------------------------------------------------------------------------

def _paged_routed(monkeypatch, dtype):
    _thresholds(monkeypatch, page_nnz=1024, elems=1024)
    n = 1 << 16
    rows, cols, vals = chip_smoke.build_blocky_matrix(n)
    vals, A, ref = _tune(n, rows, cols, vals, dtype, **_NO_FUSE)
    meta = A.csx.executors[0].meta
    assert _extras(meta) == {"dpages", "dscatter", "fall"}
    assert [k for k, _i, _e in chip_smoke.fs_tables(meta)] == ["runs"]
    assert len(chip_smoke.fblk_tables(meta)) == 1
    return n, rows, cols, vals, A, ref


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_paged_routed_matches_reference_and_oracle(monkeypatch, dtype):
    n, rows, cols, vals, A, ref = _paged_routed(monkeypatch, dtype)
    _against_both(A, ref, rows, cols, vals, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_paged_routed_spmm(monkeypatch, dtype):
    """SpMM k = 3: the plan runs the SpMV per column (``fused_mm_ok`` is
    false: no fused segment), bit-equal to three matvecs and within the
    bar of the oracle."""
    n, rows, cols, vals, A, _ref = _paged_routed(monkeypatch, dtype)
    assert not tk.fused_mm_ok(A.csx.executors[0].meta)
    X = np.random.default_rng(2).standard_normal((n, 3)).astype(dtype)
    Y = spt.matmat_mult(1.0, A, X)
    cols_y = torch.stack([spt.matvec_kernel(1.0, A, X[:, j], 0.0, None)
                          for j in range(3)], dim=1)
    assert Y.shape == (n, 3) and torch.equal(Y, cols_y)
    want = np.stack([_oracle(rows, cols, vals, X[:, j], n)
                     for j in range(3)], axis=1)
    assert _rel(Y.numpy(), want) < BARS[dtype]


def test_chip_smoke_nofuse_phase_feeds_the_path_inputs(monkeypatch):
    """chip_smoke's plan check passes on the paged_routed plan, its kernel
    phase calls every wrapper with exactly the inputs the port's SpMV
    gives it (the paged-units kernel's unit-page gather on the fs table's
    windows aside, which the path does not run), and the launch counts it
    derives from the plan are the SpMV's calls and, per column, the
    SpMM's."""
    from collections import Counter
    from types import SimpleNamespace
    from test_torch_pages import record_calls
    n, *_, A, _ref = _paged_routed(monkeypatch, "float64")
    calls = []
    wrappers = ((tf, "t1"), (tf, "k2"), (tf, "k3"), (troute, "lane_gather"),
                (tpk, "paged_units"), (tpk, "gather"),
                (tpk, "delta_pages"), (tpk, "dia"))
    names = {"gather": "paged_gather"}
    record_calls(monkeypatch, [(mod, fn, names.get(fn, fn))
                               for mod, fn in wrappers], calls)
    ex = A.csx.executors[0]
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    ex(x)
    path = list(calls)
    calls.clear()
    chip_smoke.check_nofuse_plan("blocky")(SimpleNamespace(csx=A.csx), "cpu")
    res = chip_smoke.kernel_phase(ex, x, "cpu", timed=False)
    assert set(calls) == set(path)
    counted = Counter(c[0] for c in path)
    assert set(res) == set(counted)
    want = chip_smoke.expected_counts(ex.meta)
    assert {k: v for k, v in want.items() if v} == dict(counted)
    assert counted["lane_gather"] == 5 + 1 + 1   # dscatter, merged, fs
    calls.clear()
    ex(torch.as_tensor(np.random.default_rng(2).standard_normal((n, 2))))
    assert {k: v for k, v in chip_smoke.expected_counts(
        ex.meta, 2).items() if v} == {k: 2 * v for k, v in counted.items()}
    assert Counter(c[0] for c in calls) == {k: 2 * v
                                            for k, v in counted.items()}


# ---------------------------------------------------------------------------
# (e) a table routed through a legacy scatter plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_legacy_routed_table_matches_index_add(monkeypatch, dtype):
    """A paged width-5 run table (one run per row, 2^15 rows) whose
    partials go through a legacy scatter plan (``build_scatter_plan`` over
    the table's destination rows; ``_scatter_partials``, kernels.py:516-528)
    gives the y of the same table scatter-added by ``index_add_``, and the
    oracle's."""
    n = 1 << 15
    rows, cols, vals = run_per_row_matrix(n, 5)
    vals, A, _ref = _tune(n, rows, cols, vals, dtype)
    plan = texec.HostPlan(A.csx.shards[0])
    plan._maybe_build_pages()
    meta, host = plan._pages_meta, plan._pages_arrays
    (kind, i, e), = chip_smoke.fs_tables(meta)
    t = dict(host[kind][i])
    t.pop("fscatter")
    dest = np.asarray(tk.unit_dest(kind, e, {k: torch.from_numpy(
        np.asarray(v)) for k, v in t.items() if k == "rows"}, n))
    m_pad = -(-dest.size // L) * L
    dest = np.concatenate([dest, np.full(m_pad - dest.size, -1)])
    smetas, chunks, res_pos, res_dest = troute.build_scatter_plan(
        dest, n, min_elems=64)
    t["scatter"] = {"chunks": chunks, "res_pos": res_pos,
                    "res_dest": res_dest}
    tables = list(meta[2] if kind == "runs" else meta[3])
    tables[i] = e[:4] + ((smetas, bool(res_pos.size), m_pad),)
    routed_meta = list(meta)
    routed_meta[2 if kind == "runs" else 3] = tuple(tables)
    routed_meta = tuple(routed_meta)
    tk.check_slice(routed_meta)
    assert chip_smoke.routed_tables(routed_meta) == [(kind, i, tables[i])]
    routed_host = dict(host, **{kind: [t if j == i else h for j, h in
                                       enumerate(host[kind])]})
    plain_meta = list(routed_meta)
    plain_meta[2 if kind == "runs" else 3] = tuple(
        tables[:i] + [e[:4] + (None,)] + tables[i + 1:])
    dt = getattr(torch, dtype)
    routed = convert.plan_to_torch(routed_meta, routed_host, "cpu", dt)
    plain = convert.plan_to_torch(tuple(plain_meta), routed_host, "cpu", dt)
    x = np.random.default_rng(5).standard_normal(n).astype(dtype)
    xt = torch.from_numpy(x)
    got = tk.local_contrib(routed_meta, routed, xt, nrows_part=n, ncols=n)
    want = tk.local_contrib(tuple(plain_meta), plain, xt, nrows_part=n,
                            ncols=n)
    assert _rel(got.numpy(), want.numpy()) < BARS[dtype]
    assert _rel(got.numpy(), _oracle(rows, cols, vals, x, n)) < BARS[dtype]
    bad = dict(t["scatter"], res_pos=np.zeros(1, np.int32),
               res_dest=np.full(1, n, np.int32))
    with pytest.raises(ValueError, match="residuals outside"):
        convert.plan_to_torch(routed_meta, dict(host, **{kind: [
            dict(t, scatter=bad) if j == i else h
            for j, h in enumerate(host[kind])]}), "cpu", dt)


@pytest.mark.parametrize("build,extras", [
    (chip_smoke.build_matrix, {"dpages", "dscatter"}),
    (chip_smoke.build_blocky_matrix, {"dpages", "dscatter", "fall"}),
])
def test_full_size_nofuse_plans_run_on_the_cpu(build, extras):
    """``chip_smoke.py``'s two nofuse paths at their full 2^20 rows, tuned
    and run on the CPU under ``spx.tpu.min_fused_nnz`` alone (default
    thresholds), within ``chip_smoke.CHECK_TOL`` of the oracle."""
    n = 1 << 20
    rows, cols, vals = build(n)
    cfg = spt.Config.instance()
    options = (("spx.tpu.value_dtype", "float32"),
               ("spx.preproc.xform", "all"),
               ("spx.preproc.sampling", "portion")) + chip_smoke.NO_FUSE
    for key, value in options:
        cfg.set(key, value)
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    assert _extras(A.csx.executors[0].meta) == extras
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    assert chip_smoke._mixed_rel_err(
        y.numpy(), _oracle(rows, cols, vals, x, n)) < chip_smoke.CHECK_TOL
