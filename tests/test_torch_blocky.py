"""The blocky slice of sparsex_tpu_torch on the CPU.

Fused horizontal runs (K1 in the lane-placed run styles ``rlp{W}``), the
merged route plan (``fall``: per-instance G1 lane gather + T1 + K2) and
the plain run and delta tables, through the port's plain kernel versions:

- K1 ``rlp{2,4,8}`` and the lane gather against the Pallas kernels
  (``fused._build_k1``, ``route._build_lane_gather``) in interpret mode,
  bit for bit;
- ``merged_e1s`` against the reference's on a planner's merged plan;
- the whole path (``CsxExecutor.from_tables`` → ``local_contrib``)
  against the reference executor in interpret mode and a float64 COO
  oracle: 1e-5 of the largest value in float32 (as tests/test_fused.py),
  1e-12 in float64;
- ``chip_smoke.py``'s blocky kernel phase calls each kernel with the
  inputs the port's SpMV gives it;
- ``mat_tune(..., device="cpu")`` on ``bench.build_blocky_matrix(1 << 18)``,
  whose merged instances overlap in source rows;
- ``plan_to_torch`` on the new arrays, and the refusals that remain.
"""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import bench
import sparsex_tpu.ops.fused as fused
import sparsex_tpu.ops.pallas_kernels as pk
from sparsex_tpu.config import Config
from sparsex_tpu.csx import CsxMatrix
from sparsex_tpu.ops import route as route_mod
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.ops import convert
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.exec import CsxExecutor
from sparsex_tpu_torch.ops.kernels import check_slice

torch.set_num_threads(1)
L = 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def fresh_port_config():
    """The port's Config is its own singleton: reset it around every test,
    as tests/conftest.py resets the reference's."""
    spt.Config.reset()
    yield
    spt.Config.reset()


def _thresholds(monkeypatch, **values):
    """Set planner thresholds (``MIN_FUSED_NNZ``, ``MIN_PAGE_NNZ``,
    ``MIN_ELEMS``) alike on both packages, so that they plan the same
    arrays."""
    mods = {"MIN_FUSED_NNZ": (fused, tf), "MIN_PAGE_NNZ": (pk, tpk),
            "MIN_ELEMS": (route_mod, troute)}
    for name, value in values.items():
        for mod in mods[name]:
            monkeypatch.setattr(mod, name, value)


@pytest.fixture
def small_thresholds(monkeypatch):
    _thresholds(monkeypatch, MIN_FUSED_NNZ=256, MIN_PAGE_NNZ=64,
                MIN_ELEMS=64)
    monkeypatch.setattr(pk, "dia_pallas_ok", lambda: True)


# ---------------------------------------------------------------------------
# the two new kernels against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W,q8,dtype", [
    (W, q8, np.float32) for W in (2, 4, 8) for q8 in (1, 4, 32)
] + [(W, 4, np.float64) for W in (2, 4, 8)])
def test_k1_rlp_matches_pallas(W, q8, dtype):
    """Every lane holds a product, so the circular roll-right adds mix
    lanes across the 127 -> 0 wrap as the Pallas kernel does; low reaches
    past a q8 > 1 window, whose pages read 0."""
    rng = np.random.default_rng(W * 100 + q8)
    T, npages = 16, 64
    low = rng.integers(0, q8 * 8 + (8 if q8 > 1 else 0), (T, 8, L))
    mg = fused.pack_k1_meta(low, rng.integers(-1, L, (T, 8, L)))
    plo = rng.integers(0, npages // q8, T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(dtype)
    x2 = rng.standard_normal((npages, 8, L)).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused._build_k1(T, q8, f"rlp{W}",
                                          np.dtype(dtype).name)(
            jnp.asarray(plo), jnp.asarray(mg), jnp.asarray(vals),
            jnp.asarray(x2)))
    got = tf.k1(_t(plo), _t(mg), _t(vals), _t(x2), q8, f"rlp{W}")
    assert got.shape == (T, 8, L) and got.dtype == _t(vals).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.5
    # the sliding sum really differs from the plain lp product
    lp = tf.k1(_t(plo), _t(mg), _t(vals), _t(x2), q8, "lp").numpy()
    assert not np.array_equal(lp, want)


@pytest.mark.parametrize("style", ["run3", "run256", "rlp3", "lp2"])
def test_k1_refuses_unported_styles(style):
    """Every style the planners make is ported since the dense-tile ones
    (``sl``, ``run{W}``) were; a name outside the four families, or a run
    width that does not divide 128, is refused."""
    rng = np.random.default_rng(0)
    T = 8
    args = (_t(np.zeros(T, np.int32)), _t(np.zeros((T, 8, L), np.int32)),
            _t(rng.standard_normal((T, 8, L)).astype(np.float32)),
            _t(np.zeros((4, 8, L), np.float32)), 4)
    with pytest.raises(ValueError, match="not a K1 style"):
        tf.k1(*args, style)


@pytest.mark.parametrize("K,pattern", [
    pytest.param(K, pattern, id=str(K) if pattern == "random"
                 else f"{K}-{pattern}")
    for pattern in ("random", "masked", "one_lane") for K in (1, 3, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lane_gather_matches_pallas(K, pattern, dtype):
    """Random wires (-1 masks a slot), an all-(-1) plane among random ones
    (the middle plane), and every wire on one lane."""
    rng = np.random.default_rng(K)
    R = 192
    x = rng.standard_normal((R, L)).astype(dtype)
    idx = rng.integers(-1, L, (K, R, L)).astype(np.int8)
    if pattern == "masked":
        idx[K // 2] = -1
    elif pattern == "one_lane":
        idx[:] = 77
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(route_mod._build_lane_gather(
            R, K, np.dtype(dtype).name)(jnp.asarray(x), jnp.asarray(idx)))
    got = troute.lane_gather(_t(x), _t(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    if pattern == "random":
        assert (want != 0).mean() > 0.9


def test_lane_gather_rejects_bad_arguments():
    x = torch.zeros(64, L)
    with pytest.raises(TypeError):
        troute.lane_gather(x, torch.zeros(1, 64, L, dtype=torch.int16))
    with pytest.raises(ValueError):
        troute.lane_gather(x, torch.zeros(1, 32, L, dtype=torch.int8))
    with pytest.raises(ValueError):
        troute.lane_gather(x.t(), torch.zeros(1, L, 64, dtype=torch.int8))


# ---------------------------------------------------------------------------
# matrices and their plans
# ---------------------------------------------------------------------------

def _dedup(rows, cols, n, rng, dtype):
    key = rows.astype(np.int64) * n + cols
    _, u = np.unique(key, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    return rows[o], cols[o], rng.standard_normal(rows.size).astype(dtype)


def _merged_matrix(dtype, n_runs=4000):
    """tests/test_fused.py's test_merged_plan_all_segments matrix: 4x2
    blocks, width-8 runs and singles at n = 2^15.  With its 2000 runs the
    width-8 table is too sparse for lane placement and plans the dense-tile
    ``run8`` style; 4000 runs plan ``rlp8``."""
    rng = np.random.default_rng(4)
    n = 1 << 15
    br0 = rng.integers(0, (n - 4) // 4, 8000) * 4
    bc0 = rng.integers(0, (n - 2) // 2, 8000) * 2
    ii, jj = np.meshgrid(np.arange(4), np.arange(2), indexing="ij")
    hr = rng.integers(0, n, n_runs)
    hc = rng.integers(0, n - 8, n_runs)
    rows = np.concatenate([(br0[:, None, None] + ii[None]).ravel(),
                           np.repeat(hr, 8), rng.integers(0, n, 12000)])
    cols = np.concatenate([(bc0[:, None, None] + jj[None]).ravel(),
                           (hc[:, None] + np.arange(8)[None]).ravel(),
                           rng.integers(0, n, 12000)])
    return (n,) + _dedup(rows, cols, n, rng, dtype)


def _run_matrix(dtype):
    """tests/test_fused.py's test_fused_run_kernel_end_to_end matrix (width-8
    runs, n = 2^14) with 4000 runs in place of 1200, so that the run table
    plans ``rlp8`` and its spills stay plain delta singles, plus 30
    vertical runs of 6 that stay a plain vertical run table."""
    rng = np.random.default_rng(11)
    n, nu, nv = 1 << 14, 4000, 30
    hr = rng.integers(0, n, nu)
    hc = rng.integers(0, n - 8, nu)
    vr = rng.integers(0, n - 6, nv)
    vc = rng.integers(0, n, nv)
    rows = np.concatenate([np.repeat(hr, 8),
                           (vr[:, None] + np.arange(6)).ravel()])
    cols = np.concatenate([(hc[:, None] + np.arange(8)[None]).ravel(),
                           np.repeat(vc, 6)])
    return (n,) + _dedup(rows, cols, n, rng, dtype)


def _tune(n, rows, cols, vals, xform="all", **options):
    """The reference executor and the port's, planned by each package from
    the same options (the port from the reference's tables, which its own
    encoder reproduces: tests/test_torch_plan.py)."""
    options = {"spx.tpu.value_dtype": np.dtype(vals.dtype).name,
               "spx.preproc.xform": xform, **options}
    for cfg in (Config.instance(), spt.Config.instance()):
        for key, value in options.items():
            cfg.set(key, value)
    mat = CsxMatrix.from_coo(n, n, rows, cols, vals)
    ex = mat.executors[0]
    ex._maybe_build_pages()
    port = CsxExecutor.from_tables(ex.tables, "cpu")
    return ex, port


def _extras(meta):
    return {e[0]: e[1:] for e in meta[5:] if e}


def _oracle(n, rows, cols, vals, x):
    return np.bincount(rows, weights=vals.astype(np.float64)
                       * x.astype(np.float64)[cols], minlength=n)


# ---------------------------------------------------------------------------
# merged_e1s and the whole path
# ---------------------------------------------------------------------------

def test_merged_e1s_matches_reference(small_thresholds):
    n, rows, cols, vals = _merged_matrix(np.float32)
    ex, port = _tune(n, rows, cols, vals)
    _segs, inst, bounds, _res = _extras(ex._pages_meta)["fall"]
    assert len(inst) > 1 and any(m[9] & 1 for m in inst)
    src = np.random.default_rng(3).standard_normal(
        (bounds[-1], L)).astype(np.float32)
    fa = {k: jnp.asarray(v) for k, v in ex._pages_arrays["fall"].items()}
    with pltpu.force_tpu_interpret_mode():
        want = fused.merged_e1s(inst, fa, jnp.asarray(src), n)
    got = tf.merged_e1s(inst, port.arrays["fall"], _t(src), n)
    assert len(got) == len(want)
    for (e1, g3, K, um3), (we1, wg3, wK, wum3) in zip(got, want):
        assert (K, um3) == (wK, wum3)
        np.testing.assert_array_equal(e1.numpy(), np.asarray(we1))
        np.testing.assert_array_equal(g3.numpy(), np.asarray(wg3))


def _whole_path(ex, port, n, rows, cols, vals, bar):
    """The port's SpMV against the oracle and the reference executor.  The
    reference runs its Pallas path in float32 only (exec.py:834-847: f64
    takes its XLA path), which the port's answer must also match."""
    x = np.random.default_rng(1).standard_normal(n).astype(vals.dtype)
    got = port(x).double().numpy()
    want = _oracle(n, rows, cols, vals, x)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < bar
    with pltpu.force_tpu_interpret_mode():
        assert ex._pages_active() == (vals.dtype == np.float32)
        ref = np.asarray(ex(jnp.asarray(x)), dtype=np.float64)
    assert np.abs(got - ref).max() / scale < bar


@pytest.mark.parametrize("dtype,bar", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
def test_merged_plan_path_matches_reference(small_thresholds, monkeypatch,
                                            dtype, bar):
    """delta (hybrid lp) + rlp8 runs + 4x2 blocks as rlp2 pseudo-runs in
    one merged plan, with dres/rres residuals and a plain run table."""
    _thresholds(monkeypatch, MIN_PAGE_NNZ=1024)
    n, rows, cols, vals = _merged_matrix(dtype)
    ex, port = _tune(n, rows, cols, vals)
    meta = ex._pages_meta
    assert port.meta == meta
    ex_ = _extras(meta)
    assert set(ex_) == {"dfused", "fall"}
    segs, inst, _bounds, res_desc = ex_["fall"]
    assert [s[0] for s in segs] == ["delta", "run", "run"]
    styles = sorted(e[5][1][5] for e in meta[2]
                    if len(e) > 5 and e[5] and e[5][0] == "frun")
    assert styles == ["rlp2", "rlp8"]
    assert any(len(e) <= 5 or not e[5] for e in meta[2]), "plain run table"
    assert any(e[5][0] == "cvt" for e in meta[3])
    assert {r[0] for r in res_desc} == {"dres", "rres"}
    assert inst[0][7] == inst[1][7], "instances overlap in source rows"
    _whole_path(ex, port, n, rows, cols, vals, bar)


@pytest.mark.parametrize("dtype,bar", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
def test_fused_run_path_matches_reference(small_thresholds, monkeypatch,
                                          dtype, bar):
    """A fused run table on its own route instances (no merged plan), with
    over-capacity residual units; plain horizontal and vertical run tables
    (too small for a route plan at MIN_ELEMS 1024) and plain delta singles
    (the run table's spills)."""
    _thresholds(monkeypatch, MIN_ELEMS=1024)
    n, rows, cols, vals = _run_matrix(dtype)
    ex, port = _tune(n, rows, cols, vals, xform="h,v",
                     **{"spx.matrix.min_coverage": "0.001",
                        "spx.preproc.sampling": "none"})
    meta = ex._pages_meta
    assert set(_extras(meta)) == set()
    fruns = [e[5][1] for e in meta[2]
             if len(e) > 5 and e[5] and e[5][0] == "frun"]
    assert len(fruns) == 1 and fruns[0][5] == "rlp8" and fruns[0][4] > 0
    plain = [e[:3] for e in meta[2] if len(e) <= 5 or not e[5]]
    assert {e[0] for e in plain} == {1, 2}, "horizontal and vertical"
    assert ex._pages_arrays["delta"] is not None
    _whole_path(ex, port, n, rows, cols, vals, bar)


def _sig(v):
    """A call argument as something comparable: tensors by shape, dtype
    and bytes."""
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype),
                hashlib.sha1(v.contiguous().numpy().tobytes()).hexdigest())
    if isinstance(v, (list, tuple)):
        return tuple(_sig(a) for a in v)
    return v


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chip_smoke_blocky_kernel_phase_feeds_the_path_inputs(
        small_thresholds, monkeypatch, dtype):
    """chip_smoke's blocky kernel phase calls every kernel wrapper with
    exactly the inputs the port's SpMV gives it: the same set of calls,
    argument by argument, here on a merged plan whose instances take raw
    g2b wires (um & 1) and masked g3 wires (um & 2 == 0)."""
    import chip_smoke
    _thresholds(monkeypatch, MIN_PAGE_NNZ=1024)
    n, rows, cols, vals = _merged_matrix(dtype)
    _ex, port = _tune(n, rows, cols, vals)
    calls = []
    for mod, name in ((tf, "k1"), (tf, "t1"), (tf, "k2"), (tf, "k3"),
                      (troute, "lane_gather")):
        def rec(*a, _f=getattr(mod, name), _n=name):
            calls.append((_n, _sig(a)))
            return _f(*a)
        monkeypatch.setattr(mod, name, rec)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n)
                        .astype(dtype))
    port(x)
    path = set(calls)
    calls.clear()
    ex = chip_smoke.check_blocky_plan(
        SimpleNamespace(csx=SimpleNamespace(executors=[port])), "cpu")
    assert {m[9] for m in chip_smoke.extras_of(ex.meta)["fall"][1]} == {1}
    res = chip_smoke.kernel_phase(ex, x, "cpu", timed=False)
    assert set(res) == {"k1", "k1_rlp", "lane_gather", "t1", "k2", "k3"}
    assert set(calls) == path
    assert {c[0] for c in path} == {"k1", "t1", "k2", "k3", "lane_gather"}


@pytest.mark.parametrize("dtype,bar", [("float32", 2e-4),
                                       ("float64", 1e-12)])
def test_mat_tune_blocky_bench_matrix(dtype, bar):
    """bench.py's blocky matrix at 2^18 under bench.py's config: its merged
    plan has two instances over the same source rows."""
    n = 1 << 18
    rows, cols, vals = bench.build_blocky_matrix(n)
    cfg = spt.Config.instance()
    cfg.set("spx.tpu.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    A = spt.mat_tune(spt.input_load_csr(rowptr, cols, vals, n, n),
                     device="cpu")
    ex_ = _extras(A.csx.executors[0].meta)
    assert set(ex_) == {"dfused", "fall"}
    inst = ex_["fall"][1]
    assert len(inst) == 2 and inst[0][7:9] == inst[1][7:9]
    x = np.random.default_rng(1).standard_normal(n).astype(dtype)
    before = tf.launch_counts()
    y = spt.matvec_kernel(2.0, A, x, 0.5, x)
    assert tf.launch_counts() == before      # CPU: no kernel launched
    want = 2.0 * _oracle(n, rows, cols, vals, x) + 0.5 * x
    assert y.shape == (n,) and y.dtype == getattr(torch, dtype)
    assert bench._mixed_rel_err(y.double().numpy(), want) < bar


# ---------------------------------------------------------------------------
# plan_to_torch on the new arrays, and what is still refused
# ---------------------------------------------------------------------------

def test_plan_to_torch_blocky_arrays(small_thresholds, monkeypatch):
    _thresholds(monkeypatch, MIN_PAGE_NNZ=1024)
    n, rows, cols, vals = _merged_matrix(np.float32)
    ex, port = _tune(n, rows, cols, vals)
    meta, host = ex._pages_meta, ex._pages_arrays
    inst = _extras(meta)["fall"][1]
    dev = port.arrays
    index = ("cols", "_dest", "rows", "cols_u")   # the int64 streams

    def check(h, d, inst=()):
        assert set(d) == {k for k in h if not k.startswith("_")}
        for key, a in d.items():
            a0 = np.asarray(h[key])
            if a0.dtype.kind == "f":
                assert a.dtype == torch.float32
            elif key.endswith(index):
                assert a.dtype == torch.int64
            else:
                assert a.dtype == _t(a0).dtype, key
            back = a.numpy()
            if key.startswith("g2b_") and inst and inst[int(key[4:])][9] & 1:
                back = fused._g2b_lane_offset(back, inst[int(key[4:])][2])
            np.testing.assert_array_equal(back, a0)

    check(host["fall"], dev["fall"], inst)
    assert any(k.startswith("g1_") and v.dtype == torch.int8
               for k, v in dev["fall"].items())
    assert any(k.startswith("rres_") for k in dev["fall"])
    n_frun = 0
    for entry, h, d in zip(meta[2], host["runs"], dev["runs"]):
        if "frun" in h:
            n_frun += 1
            check(h["frun"], d["frun"], entry[5][1][3])
        else:
            check(h, d)
    assert n_frun == 2
    # a fused run table's window outside its page grid is refused
    fr = next(h["frun"] for h in host["runs"] if "frun" in h)
    fr["plo"] = fr["plo"].copy()
    fr["plo"][0] = 1 << 20
    with pytest.raises(ValueError, match="K1 windows"):
        convert.plan_to_torch(meta, host, "cpu", torch.float32)


def test_check_slice_refuses_the_run8_plan(small_thresholds, monkeypatch):
    """The sparse-run matrix plans the dense-tile run8 style, which the
    port now runs (against the COO oracle), its SpMM too: a 2-column X gives
    the oracle's result, where it was refused before SpMM was ported."""
    _thresholds(monkeypatch, MIN_PAGE_NNZ=1024)
    n, rows, cols, vals = _merged_matrix(np.float32, n_runs=2000)
    ex, port = _tune(n, rows, cols, vals)
    assert port.meta == ex._pages_meta
    assert "run8" in {e[5][1][5] for e in port.meta[2]
                      if len(e) > 5 and e[5] and e[5][0] == "frun"}
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    want = _oracle(n, rows, cols, vals, x)
    got = port(x).double().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    X = np.stack([x, np.ones(n, np.float32)], axis=1)
    got2 = port(X).double().numpy()
    want2 = np.stack([want, _oracle(n, rows, cols, vals, X[:, 1])], axis=1)
    assert got2.shape == (n, 2)
    assert np.abs(got2 - want2).max() / np.abs(want2).max() < 1e-5


_DF = ("dfused", (8, 4, 32, (), 0, 0, "lp"))
_FR = (1, 1, 8, None, None, ("frun", (8, 4, 32, (), 0, "rlp8"), 0))


@pytest.mark.parametrize("runs,blocks,extras,item", [
    ((), (), (("dfused", (8, 4, 32, (), 0, 0, "sl")),
              ("dsfused", 8, 4, 32, (), False, "lp")), "'dsfused'"),
    ((_FR[:5] + (("frun", (8, 4, 32, (), 0, "run8"), 0),),), (),
     (_DF, ("dsfused", 8, 4, 32, (), False, "lp")), "'dsfused'"),
])
def test_check_slice_refusals(runs, blocks, extras, item):
    """What the port does not run is refused, naming the class;
    a paged run table, a paged plan without a fused segment and an ``fs``
    route are admitted (ported since), so their cases carry a refused
    class."""
    meta = (1 << 14, 1 << 14, runs, blocks, ()) + extras
    with pytest.raises(NotImplementedError, match=item):
        check_slice(meta)


@pytest.mark.parametrize("runs,blocks,extras", [
    (((1, 1, 8, (15, 3, 128, 32), None),),
     ((14, 4, 2, (15, 4, 512, 32), None, ("fblk", (), 0)),), (_DF,)),
    (((1, 1, 8, None, ("fs", (), False, 128)),), (),
     (_DF, ("dpages", 12, 4, 32), ("dscatter", (), False))),
    ((), ((14, 4, 2, (15, 4, 512, 32), None, ("fblk", (), 0)),), (_DF,)),
    ((), ((14, 4, 2, None, ((), False, 1024)),), (_DF,)),
    ((), (), (_DF, ("dpages", 12, 4, 32), ("dscatter", (), False))),
    ((_FR,), (), (_DF, ("fall", (("delta",), ("blk", 0, 0)), (), (), ()))),
    ((_FR,), (), (_DF, ("fall", (("delta",), ("run", 0)), (), (),
                        (("bres", 0, 0),)))),
    (((1, 1, 16, None, ((), False, 1024)),), (), ()),
    ((), (), (("dpages", 12, 4, 32), ("dpagesT", 12, 4, 32),
              ("dscatter", (), False), ("dscatterT", (), False))),
])
def test_check_slice_admits_the_routed_classes(runs, blocks, extras):
    """The legacy routed classes run since ROADMAP Queue 1 item 10 was
    ported (they were refused before): fused block tables (``fblk``), the
    merged plan's ``blk`` segments and ``bres`` residuals, the paged
    delta's scatter route (``dscatter``) and run or block tables routed
    through a legacy scatter plan; a symmetric shard's transposed delta
    stream and its route (``dpagesT``, ``dscatterT``) since item 8."""
    check_slice((1 << 14, 1 << 14, runs, blocks, ()) + extras)


def test_check_slice_admits_the_blocky_classes():
    runs = (_FR, (1, 1, 16, None, None), (2, 1, 4, None, None, ("cvt",)))
    blocks = ((14, 4, 2, None, None, ("cvt",)),)
    fall = ("fall", (("delta",), ("run", 0)), (), (),
            (("dres",), ("rres", 0)))
    check_slice((1 << 14, 1 << 14, runs, blocks, (), _DF, fall))
