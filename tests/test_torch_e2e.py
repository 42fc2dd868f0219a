"""The fused slice of sparsex_tpu_torch end to end on the CPU.

The same plan (``sparsex_tpu.ops.fused.build_fused_delta`` +
``pad_dias_for_k3``, which the port's copies reproduce:
tests/test_torch_plan.py) runs through the port's executor path
(``check_slice``, ``plan_to_torch``, ``local_contrib``) on CPU tensors (the
plain kernel versions) and through the reference's, with
its Pallas kernels in interpret mode; both are held against a float64 COO
oracle.  Bars: 1e-5 of the largest value in float32 (as tests/test_fused.py)
and 1e-12 in float64.  The public API (``mat_tune`` / ``matvec_kernel`` with
``device="cpu"``) is covered on a matrix whose plan carries DIA and
anti-diagonal tables in K3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import sparsex_tpu.ops.fused as fused
import sparsex_tpu.ops.pallas_kernels as pk
from sparsex_tpu.ops import route as route_mod
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.ops import convert, kernels
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def small_thresholds(monkeypatch):
    """Small planner thresholds, set alike on both packages so that they
    plan the same arrays; the port's Config reset around the test, as
    tests/conftest.py resets the reference's."""
    for mod in (fused, tf):
        monkeypatch.setattr(mod, "MIN_FUSED_NNZ", 256)
    for mod in (pk, tpk):
        monkeypatch.setattr(mod, "MIN_PAGE_NNZ", 64)
    for mod in (route_mod, troute):
        monkeypatch.setattr(mod, "MIN_ELEMS", 64)
    spt.Config.reset()
    yield
    spt.Config.reset()


def _singles(rng, n, ncols, m):
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, ncols, m)
    _, u = np.unique(rows * ncols + cols, return_index=True)
    return rows[u], cols[u]


def _dias(rng, n, ncols, offs, anti_offs):
    r = np.arange(n)
    meta, arrays = [], []
    for anti, os_ in ((False, offs), (True, anti_offs)):
        if not os_:
            continue
        v = rng.standard_normal((len(os_), n))
        for k, o in enumerate(os_):
            c = o - r if anti else r + o
            v[k, (c < 0) | (c >= ncols)] = 0
        meta.append((anti, tuple(os_), len(os_)))
        arrays.append({"vals": v})
    return meta, arrays


def _oracle(n, ncols, rows, cols, vals, dias_meta, dias_arrays, x):
    want = np.zeros(n)
    np.add.at(want, rows, vals.astype(np.float64) * x[cols])
    r = np.arange(n)
    for (anti, offs, _), t in zip(dias_meta, dias_arrays):
        for k, o in enumerate(offs):
            c = o - r if anti else r + o
            ok = (c >= 0) & (c < ncols)
            want[ok] += t["vals"][k, ok] * x[c[ok]]
    return want


def _case(name):
    """(rows, cols, n, ncols, max_k, dia offsets, anti offsets)."""
    rng = np.random.default_rng(len(name))
    if name == "square":
        n = ncols = 1 << 14
        rows, cols = _singles(rng, n, ncols, 6000)
        return rng, rows, cols, n, ncols, 2, (-13, -1, 0, 1, 8), ()
    if name == "ragged":
        n, ncols = 100000, 90000
        rows, cols = _singles(rng, n, ncols, 20000)
        return rng, rows, cols, n, ncols, 8, (0, 5, -7), (n - 1, n + 3)
    # multi-fold: ~280 elements into each of 40 hot dest pages
    n = ncols = 1 << 14
    hot = (np.repeat(np.arange(40), 280) * 128
           + rng.integers(0, 128, 40 * 280))
    rows = np.concatenate([hot, rng.integers(40 * 128, n, 6000)])
    cols = np.concatenate([rng.integers(0, 4096, 40 * 280),
                           rng.integers(0, n, 6000)])
    _, u = np.unique(rows * n + cols, return_index=True)
    return rng, rows[u], cols[u], n, ncols, 128, (), ()


def _port_apply(meta, arrays, dpack, x, n, ncols, dtype):
    """The executor's path: the plan as ``_maybe_build_pages`` lays it out,
    checked, uploaded and run through ``local_contrib``."""
    offs, dv, aoffs, adv = dpack
    pages_meta = (n, ncols, (), (), (), ("dfused", meta),
                  ("k3dias", tuple(offs), tuple(aoffs)))
    pages_arrays = {"fused": arrays, "dias_fused_dv": dv,
                    "dias_fused_adv": adv}
    kernels.check_slice(pages_meta)
    tarr = convert.plan_to_torch(pages_meta, pages_arrays, "cpu", dtype)
    y = kernels.local_contrib(pages_meta, tarr,
                              torch.from_numpy(x).to(dtype), nrows_part=n,
                              ncols=ncols)
    return y.double().numpy()


def _pallas_apply(meta, arrays, dpack, x, n, ncols):
    import jax
    with pltpu.force_tpu_interpret_mode():
        acc = fused.fused_delta_dia_apply(
            meta, jax.device_put({k: v for k, v in arrays.items()
                                  if not k.startswith("_")}),
            dpack, jnp.asarray(x), n, ncols)
    return np.asarray(acc, dtype=np.float64)


@pytest.mark.parametrize("name", ["square", "ragged", "multifold"])
def test_fused_apply_f32_matches_pallas_and_oracle(name):
    rng, rows, cols, n, ncols, max_k, offs, aoffs = _case(name)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    meta, arrays = fused.build_fused_delta(cols, rows, vals, ncols, n,
                                           max_k=max_k)
    assert meta is not None and meta[6] == "lp"
    if name == "square":
        assert meta[4] > 0, "expected over-capacity residuals"
    if name == "ragged":
        assert len(meta) > 7 and meta[7] is not None, "expected a tail"
    if name == "multifold":
        assert len(meta[3]) > 1, "expected several route instances"
    dmeta, darr = _dias(rng, n, ncols, offs, aoffs)
    for t in darr:
        t["vals"] = t["vals"].astype(np.float32)
    dpack = fused.pad_dias_for_k3(dmeta, darr, n)
    x = rng.standard_normal(ncols).astype(np.float32)
    got = _port_apply(meta, arrays, dpack, x, n, ncols, torch.float32)
    pal = _pallas_apply(meta, arrays, dpack, x, n, ncols)
    want = _oracle(n, ncols, rows, cols, vals, dmeta, darr,
                   x.astype(np.float64))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-5
    assert np.abs(got - pal).max() / scale < 1e-5


@pytest.mark.parametrize("name", ["square", "ragged"])
def test_fused_apply_f64_matches_oracle(name):
    rng, rows, cols, n, ncols, max_k, offs, aoffs = _case(name)
    vals = rng.standard_normal(rows.size)
    meta, arrays = fused.build_fused_delta(cols, rows, vals, ncols, n,
                                           max_k=max_k)
    assert meta is not None and arrays["vals"].dtype == np.float64
    dmeta, darr = _dias(rng, n, ncols, offs, aoffs)
    dpack = fused.pad_dias_for_k3(dmeta, darr, n)
    x = rng.standard_normal(ncols)
    got = _port_apply(meta, arrays, dpack, x, n, ncols, torch.float64)
    want = _oracle(n, ncols, rows, cols, vals, dmeta, darr, x)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
    # the Pallas interpreter runs f64 too: same plan, same bar
    pal = _pallas_apply(meta, arrays, dpack, x, n, ncols)
    assert np.abs(got - pal).max() / np.abs(want).max() < 1e-12


def _api_matrix(rng, n, m, dtype):
    rows_l, cols_l = [], []
    for b in (0, 3, -2):
        r = np.arange(max(0, -b), min(n, n - b))
        rows_l.append(r)
        cols_l.append(r + b)
    r = np.arange(n)
    rows_l.append(r)
    cols_l.append(n - r)                       # an anti-diagonal (s = n)
    rows_l.append(rng.integers(0, n, m))
    cols_l.append(rng.integers(0, n, m))
    rows, cols = np.concatenate(rows_l), np.concatenate(cols_l)
    keep = cols < n
    rows, cols = rows[keep], cols[keep]
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    vals = rng.standard_normal(rows.size).astype(dtype)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return rows, cols, vals, spt.input_load_csr(rowptr, cols, vals, n, n)


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5),
                                       ("float64", 1e-12)])
def test_api_matvec_kernel_cpu(dtype, bar):
    rng = np.random.default_rng(6)
    n = 8192
    rows, cols, vals, inp = _api_matrix(rng, n, 9000, dtype)
    cfg = spt.Config.instance()
    cfg.set("spx.tpu.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "all")
    A = spt.mat_tune(inp, device="cpu")
    extras = {e[0]: e[1:] for e in A.csx.executors[0].meta[5:] if e}
    assert set(extras) == {"dfused", "k3dias"}
    assert extras["k3dias"][1], "expected an anti-diagonal table in K3"
    x = rng.standard_normal(n).astype(dtype)
    y0 = rng.standard_normal(n).astype(dtype)
    before = tf.launch_counts()
    y = spt.matvec_kernel(1.0, A, x, 0.0, None, device="cpu")
    y2 = spt.matvec_kernel(2.5, A, torch.from_numpy(x), 0.5, y0)
    y3 = spt.matvec_mult(-1.0, A, x)
    assert y.dtype == getattr(torch, dtype) and y.shape == (n,)
    ref = np.zeros(n)
    np.add.at(ref, rows, vals.astype(np.float64) * x.astype(np.float64)[cols])
    scale = np.abs(ref).max()
    assert np.abs(y.double().numpy() - ref).max() / scale < bar
    ref2 = 2.5 * ref + 0.5 * y0
    assert (np.abs(y2.double().numpy() - ref2).max()
            / np.abs(ref2).max() < bar)
    assert np.abs(y3.double().numpy() + ref).max() / scale < bar
    assert tf.launch_counts() == before   # CPU: no kernel launched


def test_api_errors():
    rng = np.random.default_rng(1)
    n = 8192
    rows, cols, vals, inp = _api_matrix(rng, n, 9000, "float32")
    spt.Config.instance().set("spx.tpu.value_dtype", "float32")
    A = spt.mat_tune(inp, device="cpu")
    with pytest.raises(spt.SparsexError) as ei:
        spt.matvec_kernel(1.0, A, np.ones(n + 1, np.float32), 0.0, None)
    assert ei.value.code == spt.ErrorCode.SPX_ERR_VEC_DIM
    with pytest.raises(spt.SparsexError) as ei:
        spt.matvec_kernel(1.0, A, np.ones(n, np.float32), 1.0,
                          np.ones(n - 1, np.float32))
    assert ei.value.code == spt.ErrorCode.SPX_ERR_VEC_DIM
    # an (n, 2) x is an SpMM now, with the oracle's result
    X = np.stack([np.ones(n), np.arange(n) % 7], axis=1).astype(np.float32)
    Y = spt.matvec_mult(1.0, A, X)
    want = np.zeros((n, 2))
    np.add.at(want, rows, vals.astype(np.float64)[:, None]
              * X.astype(np.float64)[cols])
    assert Y.shape == (n, 2)
    assert np.abs(Y.double().numpy() - want).max() / np.abs(want).max() < 1e-5
    # a bf16 x is computed in the matrix's dtype and gives a bf16 y
    yb = spt.matvec_mult(1.0, A, torch.ones(n, dtype=torch.bfloat16))
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, spt.matvec_mult(1.0, A, torch.ones(n)).bfloat16())
    # symmetric matrices (ROADMAP Queue 1 item 8): an unsymmetric pattern
    # is refused; the matrix's symmetric part tunes and runs in both modes
    spt.Config.instance().set("spx.matrix.symmetric", "true")
    with pytest.raises(spt.SparsexError) as ei:
        spt.mat_tune(inp, device="cpu")
    assert ei.value.code == spt.ErrorCode.SPX_ERR_INPUT_MAT
    strict = rows > cols
    keep = rows >= cols
    rs = np.concatenate([rows[keep], cols[strict]])
    cs = np.concatenate([cols[keep], rows[strict]])
    vs = np.concatenate([vals[keep], vals[strict]])
    order = np.lexsort((cs, rs))
    rs, cs, vs = rs[order], cs[order], vs[order]
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rs, minlength=n))
    sym = spt.input_load_csr(rowptr, cs, vs, n, n)
    x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    want = np.bincount(rs, weights=vs.astype(np.float64)
                       * x.astype(np.float64)[cs], minlength=n)
    for mode in ("on", "off"):
        spt.Config.instance().set("spx.tpu.sym_full", mode)
        y = spt.matvec_mult(1.0, spt.mat_tune(sym, device="cpu"), x)
        assert np.abs(y.double().numpy() - want).max() < (
            1e-5 * np.abs(want).max())
    # two shards (spx.rt.nr_threads, ROADMAP Queue 1 item 5) run, plain
    # and symmetric in both modes; a class no planner of the port makes is
    # refused by name (the reference's stacked sharded delta)
    spt.Config.instance().set("spx.rt.nr_threads", "2")
    for mode in ("on", "off"):
        spt.Config.instance().set("spx.tpu.sym_full", mode)
        A2 = spt.mat_tune(sym, device="cpu")
        assert len(A2.csx.shards) == 2
        y = spt.matvec_mult(1.0, A2, x)
        assert np.abs(y.double().numpy() - want).max() < (
            1e-5 * np.abs(want).max())
    spt.Config.instance().set("spx.matrix.symmetric", "false")
    A2 = spt.mat_tune(inp, device="cpu")
    assert A2.csx.partition.nparts == 2
    want = np.bincount(rows, weights=vals.astype(np.float64)
                       * x.astype(np.float64)[cols], minlength=n)
    y = spt.matvec_mult(1.0, A2, x)
    assert np.abs(y.double().numpy() - want).max() < (
        1e-5 * np.abs(want).max())
    with pytest.raises(NotImplementedError, match="'dsfused'"):
        kernels.check_slice((n, n, (), (), (), ("dsfused", None)))
