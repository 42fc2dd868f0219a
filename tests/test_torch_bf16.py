"""bf16 matrices on sparsex_tpu_torch, computed in float32, on the CPU.

The reference computes a bf16 matrix in f32 on its paged layouts (f32
copies of the value streams, x upcast, the result cast back:
``sparsex_tpu/ops/exec.py:267-270``, ``:861-867``); the port does the same
on every plan, its plain tables included (the reference's plain variant
runs in bf16 through XLA).  The port's host tables hold the bf16-rounded
values as float32 arrays, so that no ``ml_dtypes`` is needed
(tests/test_torch_nojax.py runs it with ``ml_dtypes`` blocked).

Matrices: tests/test_route.py:246's (n = 4096, the diagonal plus 5000
random singles, seed 8) under small planner thresholds (the fused delta
pipeline with its DIA table in K3) and under the default ones (no paged
table: the plain tables), a blocky matrix at 2^14 under small thresholds
(fused runs and a merged plan) and the HPCG stencil at 8^3 (one DIA table).

Bars: against a float64 COO oracle on the bf16-rounded values and x,
max |y - y_oracle| / max |y_oracle| < 2e-2 (the reference's bar,
tests/test_route.py:246); against the reference executor (Pallas in
interpret mode) on its paged layouts, where both sum the same bf16 values
in f32, elementwise within one bf16 rounding: |y - y_ref| <= 2^-7 *
max(|y|, |y_ref|) + 1e-5 * max |y_ref|; against the reference's plain
variant, which sums in bf16, the oracle's bar.
"""

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
from sparsex_tpu_torch.csx import CsxMatrix
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute

torch.set_num_threads(1)

_SMALL = {"MIN_FUSED_NNZ": 256, "MIN_PAGE_NNZ": 64, "MIN_ELEMS": 64}
BAR = 2e-2


@pytest.fixture(autouse=True)
def fresh_port_config():
    """The port's Config is its own singleton: reset it around every test,
    as tests/conftest.py resets the reference's."""
    spt.Config.reset()
    yield
    spt.Config.reset()


def route_matrix():
    """tests/test_route.py:246's matrix and its rng, past the values."""
    rng = np.random.default_rng(8)
    n = 4096
    rows = np.concatenate([np.arange(n), rng.integers(0, n, 5000)])
    cols = np.concatenate([np.arange(n), rng.integers(0, n, 5000)])
    _, u = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    rows, cols = rows[o], cols[o]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return n, rows, cols, vals, rng


def _blocky():
    n = 1 << 14
    rows, cols, vals = chip_smoke.build_blocky_matrix(n)
    return n, rows, cols, vals, np.random.default_rng(9)


def _hpcg():
    n, rows, cols, vals = chip_smoke.hpcg_matrix(8)
    return n, rows, cols, vals.astype(np.float32), np.random.default_rng(10)


# case -> (matrix, thresholds, options, extras of the port's plan, whether
# the reference runs its paged layouts)
CASES = {
    "route_small": (route_matrix, _SMALL, {}, ["dfused", "k3dias"], True),
    "route_plain": (route_matrix, {}, {}, [], False),
    "blocky_small": (_blocky, _SMALL, {}, ["dfused", "fall"], True),
    "hpcg_plain": (_hpcg, {}, {"spx.preproc.sampling": "none"}, [], False),
}


def _set_thresholds(monkeypatch, values):
    mods = {"MIN_FUSED_NNZ": (fused, tf), "MIN_PAGE_NNZ": (pk, tpk),
            "MIN_ELEMS": (route_mod, troute)}
    for name, value in values.items():
        for mod in mods[name]:
            monkeypatch.setattr(mod, name, value)


def _tuned(monkeypatch, case, reference=False):
    """(port matrix, reference matrix or None, n, rows, cols, vals, x)."""
    build, thresholds, options, extras, paged = CASES[case]
    n, rows, cols, vals, rng = build()
    _set_thresholds(monkeypatch, thresholds)
    cfgs = [spt.Config.instance()] + ([RefConfig.instance()]
                                      if reference else [])
    for cfg in cfgs:
        for key, value in {"spx.tpu.value_dtype": "bfloat16",
                           "spx.preproc.xform": "all", **options}.items():
            cfg.set(key, value)
    A = CsxMatrix.from_coo(n, n, rows, cols, vals, device="cpu")
    ex = A.executors[0]
    assert ex.dtype == torch.float32
    assert sorted(e[0] for e in ex.meta[5:] if e) == extras
    ref = None
    if reference:
        monkeypatch.setattr(pk, "dia_pallas_ok", lambda: paged)
        ref = RefCsxMatrix.from_coo(n, n, rows, cols, vals)
        with pltpu.force_tpu_interpret_mode():
            assert ref.executors[0]._pages_active() == paged
    x = rng.standard_normal((n, 3)).astype(np.float32)
    return A, ref, n, rows, cols, vals, x


def _bf16(a):
    """``a`` rounded to bf16, as float64 (the oracle's inputs)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)
                            ).bfloat16().double().numpy()


def _oracle(n, rows, cols, vals, x):
    vb, xb = _bf16(vals), _bf16(x)
    return np.stack([np.bincount(rows, weights=vb * xb[cols, j],
                                 minlength=n)
                     for j in range(x.shape[1])], axis=1)


def _err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_matches_oracle(monkeypatch, case):
    """SpMV and SpMM (k = 3) of a bf16 x give bf16 results within the bar
    of the oracle; an f32 x gives an f32 result of the same f32 sums; the
    host tables hold the bf16-rounded values in float32 arrays."""
    A, _ref, n, rows, cols, vals, x = _tuned(monkeypatch, case)
    tables = A.shards[0]
    assert tables.value_type == "bfloat16"
    for t in [tables.delta] + tables.runs + tables.blocks + tables.dias:
        if t is not None and t.vals.size:
            assert t.vals.dtype == np.float32
            assert np.array_equal(_bf16(t.vals), t.vals)
    want = _oracle(n, rows, cols, vals, x)
    xb = torch.from_numpy(x).bfloat16()
    y = A.matvec(xb[:, 0])
    Y = A.matmat(xb)
    assert y.dtype == Y.dtype == torch.bfloat16
    assert _err(y.double().numpy(), want[:, 0]) < BAR
    assert _err(Y.double().numpy(), want) < BAR
    y32 = A.matvec(xb[:, 0].float())
    assert y32.dtype == torch.float32
    assert torch.equal(y32.bfloat16(), y)
    # alpha / beta with a bf16 y
    y0 = torch.from_numpy(x[:, 1].copy()).bfloat16()
    y2 = A.matvec(xb[:, 0], alpha=2.0, beta=0.5, y=y0)
    assert y2.dtype == torch.bfloat16
    assert _err(y2.double().numpy(),
                2.0 * want[:, 0] + 0.5 * y0.double().numpy()) < BAR


@pytest.mark.parametrize("case", ["route_small", "blocky_small",
                                  "route_plain"])
def test_bf16_matches_reference(monkeypatch, case):
    """The same bf16 matrix and x through the reference executor (Pallas in
    interpret mode): on its paged layouts within one bf16 rounding of the
    port, SpMV and SpMM; against its plain variant (bf16 sums) within the
    oracle's bar."""
    A, ref, n, rows, cols, vals, x = _tuned(monkeypatch, case,
                                            reference=True)
    paged = CASES[case][4]
    xb = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(x, dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want_y = np.asarray(ref.matvec(xj[:, 0]).astype(jnp.float32))
        want_Y = (np.asarray(ref.matmat(xj).astype(jnp.float32))
                  if paged else None)
    got_y = A.matvec(xb[:, 0]).float().numpy()
    if not paged:
        assert _err(got_y, want_y) < BAR
        return
    got_Y = A.matmat(xb).float().numpy()
    for got, want in ((got_y, want_y), (got_Y, want_Y)):
        scale = 1e-5 * np.abs(want).max()
        assert np.all(np.abs(got - want)
                      <= 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
                      + scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_executor_results_are_fresh(dtype):
    """Two calls return two tensors, and the first keeps its values after
    the second (on the card a call replays a graph whose output buffer is
    reused; the CUDA tests check the same there)."""
    n, rows, cols, vals, rng = route_matrix()
    spt.Config.instance().set("spx.tpu.value_dtype", dtype)
    ex = CsxMatrix.from_coo(n, n, rows, cols, vals, device="cpu").executors[0]
    x1, x2 = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              for _ in range(2))
    y1 = ex(x1)
    kept = y1.clone()
    y2 = ex(x2)
    assert y1.data_ptr() != y2.data_ptr()
    assert torch.equal(y1, kept) and not torch.equal(y1, y2)
