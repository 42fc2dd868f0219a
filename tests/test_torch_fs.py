"""The partial-segment route (``fs``) of sparsex_tpu_torch on the CPU.

The planner routes a paged run table whose width does not divide 128 and a
block table with bc not dividing 128 through a partial segment: the
table's partials (one per unit, or per block row) are the source grid of
route instances (G1 lane gather, T1, K2) that feed the shared K3, with the
instances' over-capacity residuals added after it.  Small inputs that take
this route:

- ``run_per_row_matrix(1 << 15, 5)``: one width-5 horizontal run per row
  at a random start column (numpy seed 0): a paged run table with an
  ``fs`` route of one instance;
- ``chip_smoke.block3_matrix(3 << 14)``: a 3x3 block on the diagonal and
  one at a random block column per block row: a paged block table with an
  ``fs`` route of two instances;
- ``chip_smoke.wide_run_matrix(1 << 16, 5)`` with ``route.MIN_ELEMS`` =
  1024 on both packages: an ``fs`` route with residuals beside the fused
  delta pipeline (``dfused``), the 2^21 chip path in small.

Each runs through ``mat_tune(..., device="cpu")`` against the reference
executor (Pallas in interpret mode) and a float64 COO oracle, within 1e-10
relative in float64 and ``chip_smoke.CHECK_TOL`` in float32.  Its SpMM
(k = 3) equals the per-column ``matvec`` bit for bit where the plan runs
the SpMV per column; beside a fused segment the k-major SpMM keeps the row
scatter for ``fs`` tables, as the reference's does (kernels.py:497-501),
and agrees within the same bars.  ``partial_segment_e1s`` gives the
reference's E1s on the plan's partials.
"""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import sparsex_tpu.ops.fused as fused
from sparsex_tpu.config import Config as RefConfig
from sparsex_tpu.csx import CsxMatrix as RefCsxMatrix
from sparsex_tpu.ops import route as route_mod
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.kernels import fused_mm_ok
from test_torch_pages import record_calls

torch.set_num_threads(1)
L = 128


@pytest.fixture(autouse=True)
def fresh_port_config():
    """The port's Config is its own singleton: reset it around every test,
    as tests/conftest.py resets the reference's."""
    spt.Config.reset()
    yield
    spt.Config.reset()


def run_per_row_matrix(n, W, seed=0):
    """One width-W horizontal run per row at a random start column."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), W)
    c0 = rng.integers(0, n - W + 1, n)
    cols = (c0[:, None] + np.arange(W)).ravel()
    return rows, cols, rng.standard_normal(rows.size)


# name -> (rows, builder, route.MIN_ELEMS, table kind, fs instances,
# residuals, extras of the plan)
CASES = {
    "runs": (1 << 15, lambda n: run_per_row_matrix(n, 5), None, 2, 1,
             False, set()),
    "blocks": (3 << 14, chip_smoke.block3_matrix, None, 3, 2, False, set()),
    "runs_res": (1 << 16, lambda n: chip_smoke.wide_run_matrix(n, 5), 1024,
                 2, 1, True, {"dfused"}),
}


def _tune(monkeypatch, name, dtype):
    """The port's matrix on the CPU and the reference executor of the same
    matrix, tuned under the same options and thresholds."""
    n, build, min_elems, *_ = CASES[name]
    if min_elems is not None:
        for mod in (route_mod, troute):
            monkeypatch.setattr(mod, "MIN_ELEMS", min_elems)
    rows, cols, vals = build(n)
    vals = np.asarray(vals).astype(dtype)
    for cfg in (spt.Config.instance(), RefConfig.instance()):
        cfg.set("spx.tpu.value_dtype", dtype)
        cfg.set("spx.preproc.xform", "all")
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    A = spt.mat_tune(spt.input_load_csr(rowptr, cols, vals, n, n),
                     device="cpu")
    ref = RefCsxMatrix.from_coo(n, n, rows, cols, vals).executors[0]
    ref._maybe_build_pages()
    return n, rows, cols, vals, A, ref


def _fs_entries(meta):
    return [e for e in meta[2] + meta[3] if len(e) > 4 and e[4]
            and e[4][0] == "fs"]


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    return (np.abs(np.asarray(got, dtype=np.float64) - want).max()
            / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_fs_plan(monkeypatch, name):
    """The plan holds one paged table with an ``fs`` route of the expected
    instances; its uploaded route takes raw g2b wires and int64 residual
    positions."""
    _n, _b, _m, kind, n_inst, has_res, extras = CASES[name]
    *_, A, ref = _tune(monkeypatch, name, "float64")
    ex = A.csx.executors[0]
    assert ex.meta == ref._pages_meta and ex.variant == "paged"
    (entry,) = _fs_entries(ex.meta)
    assert entry in ex.meta[kind] and entry[3] is not None
    _, inst, res, m_pad = entry[4]
    assert len(inst) == n_inst and res is has_res and m_pad % L == 0
    assert {e[0] for e in ex.meta[5:] if e} == extras
    t = ex.arrays["runs" if kind == 2 else "blocks"][0]
    fs = t["fscatter"]
    for i, m in enumerate(inst):
        assert fs[f"g1_{i}"].dtype == torch.int8
        assert fs[f"g2b_{i}"].shape == (L, m[6], L)
        if m[9] & 1:   # an unmasked instance: raw wires below ceil8(A2R)
            assert int(fs[f"g2b_{i}"].max()) < -(-m[2] // 8) * 8
    if has_res:
        assert fs["res_pos"].dtype == torch.int64
        assert fs["res_dest"].dtype == torch.int64


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype,bar", [("float32", chip_smoke.CHECK_TOL),
                                       ("float64", 1e-10)])
def test_fs_matches_reference_and_oracle(monkeypatch, name, dtype, bar):
    n, rows, cols, vals, A, ref = _tune(monkeypatch, name, dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n).astype(dtype)
    y0 = rng.standard_normal(n).astype(dtype)
    want = np.bincount(rows, weights=vals.astype(np.float64)
                       * x.astype(np.float64)[cols], minlength=n)
    before = tf.launch_counts()
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    y2 = spt.matvec_kernel(2.0, A, x, 0.5, y0)
    assert tf.launch_counts() == before        # no launch on the CPU
    assert y.shape == (n,) and y.dtype == getattr(torch, dtype)
    assert _rel(y.numpy(), want) < bar
    assert _rel(y2.numpy(), 2.0 * want + 0.5 * y0) < bar
    with pltpu.force_tpu_interpret_mode():
        yr = np.asarray(ref(jnp.asarray(x)))
    assert _rel(y.numpy(), yr) < bar


@pytest.mark.parametrize("name", sorted(CASES))
def test_fs_spmm(monkeypatch, name):
    """SpMM k = 3: bit-equal to the per-column matvec where the plan runs
    the SpMV per column; beside a fused segment (k-major, the fs table by
    row scatter) within 1e-10 of it and of the oracle."""
    n, rows, cols, vals, A, _ref = _tune(monkeypatch, name, "float64")
    X = np.random.default_rng(2).standard_normal((n, 3))
    Y = spt.matmat_mult(1.0, A, X)
    cols_y = torch.stack([spt.matvec_kernel(1.0, A, X[:, j], 0.0, None)
                          for j in range(3)], dim=1)
    assert Y.shape == (n, 3)
    if fused_mm_ok(A.csx.executors[0].meta):
        assert name == "runs_res"
        assert _rel(Y.numpy(), cols_y.numpy()) < 1e-10
    else:
        assert torch.equal(Y, cols_y)
    want = np.stack([np.bincount(rows, weights=vals * X[cols, j],
                                 minlength=n) for j in range(3)], axis=1)
    assert _rel(Y.numpy(), want) < 1e-10


@pytest.mark.parametrize("name", ["runs", "blocks"])
def test_partial_segment_e1s_matches_reference(monkeypatch, name):
    """The port's G1 + T1 + K2 per instance over a partial stream against
    the reference's ``partial_segment_e1s`` in interpret mode (float32,
    the Pallas kernels' type): the E1s bit for bit."""
    *_, A, ref = _tune(monkeypatch, name, "float32")
    ex = A.csx.executors[0]
    (entry,) = _fs_entries(ex.meta)
    _, inst, _res, m_pad = entry[4]
    kind = "runs" if entry in ex.meta[2] else "blocks"
    flat = np.random.default_rng(3).standard_normal(m_pad).astype(
        np.float32)
    got = tf.partial_segment_e1s(inst, ex.arrays[kind][0]["fscatter"],
                                 torch.from_numpy(flat), ex.nrows)
    host = ref._pages_arrays[kind][0]["fscatter"]
    with pltpu.force_tpu_interpret_mode():
        want = fused.partial_segment_e1s(inst, host, jnp.asarray(flat),
                                         ex.nrows)
    assert len(got) == len(want) == len(inst)
    for (e1, g3, K, um3), (we1, wg3, wK, _w) in zip(got, want):
        assert torch.equal(e1, torch.from_numpy(np.array(we1)))
        assert np.array_equal(g3.numpy(), np.asarray(wg3)) and K == wK
    with pytest.raises(ValueError, match="whole 128-lane rows"):
        tf.partial_segment_e1s(inst, ex.arrays[kind][0]["fscatter"],
                               torch.zeros(m_pad + 1), ex.nrows)


@pytest.mark.parametrize("name", ["blocks", "runs_res"])
def test_chip_smoke_fs_phase_feeds_the_path_inputs(monkeypatch, name):
    """chip_smoke's plan check passes on the fs paths, its kernel phase
    calls every kernel wrapper with exactly the inputs the port's SpMV
    gives it (the unit-page gather aside, which only the phase calls), and
    the launch counts it derives from the plan are the SpMV's calls and,
    k-batched, the SpMM's."""
    *_, A, _ref = _tune(monkeypatch, name, "float64")
    n = A.nrows
    calls = []
    wrappers = ((tf, "k1"), (tf, "t1"), (tf, "k2"), (tf, "k3"),
                (troute, "lane_gather"), (tpk, "paged_units"),
                (tpk, "gather"))
    record_calls(monkeypatch, [(mod, fn, fn) for mod, fn in wrappers], calls)
    ex =A.csx.executors[0]
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    ex(x)
    path = list(calls)
    calls.clear()
    kind = "runs" if name == "runs_res" else "blocks"
    chip_smoke.check_fs_plan(kind)(SimpleNamespace(csx=A.csx), "cpu")
    res = chip_smoke.kernel_phase(ex, x, "cpu", timed=False)
    assert set(c for c in calls if c[0] != "gather") == set(path)
    assert "paged_gather" in res and "gather" not in {c[0] for c in path}
    want = chip_smoke.expected_counts(ex.meta)
    counted = Counter(c[0] for c in path)
    assert {k: v for k, v in want.items() if v} == dict(counted)
    calls.clear()
    ex(torch.as_tensor(np.random.default_rng(2).standard_normal((n, 3))))
    mm = Counter(c[0] for c in calls)
    want = chip_smoke.expected_counts(ex.meta, 3)
    if fused_mm_ok(ex.meta):     # one k-batched chunk: fused kernels only
        assert {k[:-3]: v for k, v in want.items() if v} == dict(mm)
    else:                        # three SpMVs
        assert {k: v for k, v in want.items() if v} == {
            k: 3 * v for k, v in counted.items()}
