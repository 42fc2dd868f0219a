"""Fused run tables whose route instances overlap, in sparsex_tpu_torch.

When ``build_fused_run``'s one-fold route plan is rejected, its fallback
(``route.build_scatter_plan(..., uniform_chunks=True)``) plans several
route instances over the same source rows, one per fold.  K1 applies one
G1 grid per source lane, so such a table runs right only inside the merged
plan (``fall``), whose lane gathers apply one G1 per instance.  The port's
``HostPlan`` re-plans a table that the merged plan does not take as its
paged units with their own partial-segment route (``fs``); the reference
keeps the fused run and its last fold's wires (an intended divergence,
``tests/test_torch_plan.py``).  On the CPU (``device="cpu"``, the plain
versions):

- ``chip_smoke.overlap_run_matrix(1 << 16)`` (3 width-16 runs a row)
  under default thresholds and ``overlap_run_matrix(4096, 17, 2)`` under
  ``test_torch_plan``'s ``_SMALL`` thresholds, against a float64 COO
  oracle: max |y - y_oracle| / max |y_oracle| within 2e-4 in float32 and
  1e-6 in float64 (before the re-plan: 0.87 and 0.99);
- 2^17 rows of 4 width-8 runs, whose overlapping instances the merged
  plan takes: the plan keeps ``dfused`` + ``fall`` and is right;
- the guards: ``instance_g1`` and ``build_fused_delta`` raise on
  overlapping instances, ``build_fused_run`` gives them identity wires
  rather than the last fold's, and ``check_slice`` refuses an overlapping
  fused run outside a merged plan.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.kernels import (check_slice,
                                           unmerged_overlapping_runs)

torch.set_num_threads(1)
L = 128
_SMALL = {(tf, "MIN_FUSED_NNZ"): 256, (tpk, "MIN_PAGE_NNZ"): 64,
          (troute, "MIN_ELEMS"): 64}
BARS = {"float32": 2e-4, "float64": 1e-6}


@pytest.fixture(autouse=True)
def fresh_port_config():
    """The port's Config is its own singleton: reset it around every test,
    as tests/conftest.py resets the reference's."""
    spt.Config.reset()
    yield
    spt.Config.reset()


def _tune(rows, cols, vals, n, dtype):
    cfg = spt.Config.instance()
    cfg.set("spx.tpu.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "all")
    vals = np.asarray(vals).astype(dtype)
    return spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                        device="cpu"), vals


def _oracle_error(A, rows, cols, vals, n, dtype):
    x = np.random.default_rng(1).standard_normal(n).astype(dtype)
    want = np.bincount(rows, weights=vals.astype(np.float64)
                       * x.astype(np.float64)[cols], minlength=n)
    y = spt.matvec_mult(1.0, A, x).numpy().astype(np.float64)
    return np.abs(y - want).max() / np.abs(want).max()


# name -> (rows, matrix of n rows, thresholds)
CASES = {
    "w16_2^16": (1 << 16, chip_smoke.overlap_run_matrix, {}),
    "w17_4096": (4096, lambda n: chip_smoke.overlap_run_matrix(n, 17, 2),
                 _SMALL),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_overlapping_run_is_replanned_and_right(monkeypatch, name, dtype):
    n, build, thresholds = CASES[name]
    for (mod, attr), value in thresholds.items():
        monkeypatch.setattr(mod, attr, value)
    rows, cols, vals = build(n)
    A, vals = _tune(rows, cols, vals, n, dtype)
    meta = A.csx.executors[0].meta
    assert unmerged_overlapping_runs(meta) == []
    # the re-planned table: paged, routed through a partial segment
    assert [k for k, _i, e in chip_smoke.fs_tables(meta) if e[3]] == ["runs"]
    assert _oracle_error(A, rows, cols, vals, n, dtype) < BARS[dtype]


def test_overlapping_run_in_a_merged_plan_keeps_it():
    """2^17 rows of 4 width-8 runs: the rlp8 run table's instances overlap,
    the merged plan takes it (its lane gathers apply each instance's G1),
    and the plan keeps the fused delta and the merged route."""
    n = 1 << 17
    rows, cols, vals = chip_smoke.overlap_run_matrix(n, 8, 4)
    A, vals = _tune(rows, cols, vals, n, "float32")
    meta = A.csx.executors[0].meta
    assert {"dfused", "fall"} <= set(chip_smoke.extras_of(meta))
    (_ri, m), = chip_smoke.fused_runs(meta)
    assert m[5] == "rlp8" and tf.instances_overlap(m[3])
    assert unmerged_overlapping_runs(meta) == []
    assert _oracle_error(A, rows, cols, vals, n, "float32") < BARS["float32"]


def _inst(a0, a1):
    """A route instance meta over source rows [a0, a1)."""
    return (a1 - a0, a1 - a0, 1, 1, 1, 1, 1, a0, a1, 0)


def test_instance_g1_raises_on_overlapping_instances():
    g1 = [{"g1": np.full((8, L), i, np.int8)} for i in range(2)]
    with pytest.raises(ValueError, match="overlap"):
        tf.instance_g1(16, [_inst(0, 8), _inst(4, 12)], g1)
    got = tf.instance_g1(24, [_inst(8, 16), _inst(0, 8)], g1)
    assert (got[:8] == 1).all() and (got[8:16] == 0).all()
    assert (got[16:] == -1).all()


def _duplicated_first_instance(monkeypatch):
    """Make every route plan hold its first instance twice (two instances
    over the same source rows), and keep small instances."""
    plan_fn = troute.build_scatter_plan

    def doubled(*a, **kw):
        plan = plan_fn(*a, **kw)
        if plan is None:
            return None
        metas, arrs, res_pos, res_dest = plan
        return ([metas[0]] + list(metas), [arrs[0]] + list(arrs), res_pos,
                res_dest)

    monkeypatch.setattr(troute, "build_scatter_plan", doubled)
    monkeypatch.setattr(troute, "RES_DEMOTE_ELEMS", 0)


def test_fused_delta_g1_guard_raises(monkeypatch):
    rng = np.random.default_rng(2)
    n = 1 << 15
    key = np.unique(rng.integers(0, n, 12000) * n + rng.integers(0, n, 12000))
    rows, cols = key // n, key % n
    vals = rng.standard_normal(rows.size).astype(np.float32)
    for (mod, attr), value in _SMALL.items():
        monkeypatch.setattr(mod, attr, value)
    assert tf.build_fused_delta(cols, rows, vals, n, n)[0] is not None
    _duplicated_first_instance(monkeypatch)
    with pytest.raises(ValueError, match="overlap"):
        tf.build_fused_delta(cols, rows, vals, n, n)


def test_fused_run_g1_fill_keeps_no_fold_wires(monkeypatch):
    """Overlapping instances never reach ``build_fused_run``'s G1 fill: K1
    gets identity wires (the merged plan's form), not the last fold's."""
    rng = np.random.default_rng(4)
    n, U, W = 1 << 14, 4096, 8
    cols_u = rng.integers(0, n - W, U)
    rows_u = np.sort(rng.integers(0, n, U))
    vals2d = rng.standard_normal((U, W)).astype(np.float32)
    for (mod, attr), value in _SMALL.items():
        monkeypatch.setattr(mod, attr, value)
    meta, arrays, _order, _n_page = tf.build_fused_run(cols_u, rows_u,
                                                       vals2d, n, n, W)
    assert meta is not None and not tf.instances_overlap(meta[3])
    wires = (arrays["mg"] >> 16) - 1
    assert (wires < 0).any()      # disjoint: the instances' own G1 grid
    _duplicated_first_instance(monkeypatch)
    meta, arrays, _order, _n_page = tf.build_fused_run(cols_u, rows_u,
                                                       vals2d, n, n, W)
    assert tf.instances_overlap(meta[3])
    np.testing.assert_array_equal((arrays["mg"] >> 16) - 1,
                                  np.broadcast_to(np.arange(L),
                                                  arrays["mg"].shape))


def test_check_slice_refuses_an_overlapping_fused_run():
    frun = ("frun", (8, 4, 32, (_inst(0, 8), _inst(0, 8)), 0, "rlp8"), 0)
    runs = ((1, 1, 8, None, None, frun),)
    with pytest.raises(NotImplementedError, match="overlap"):
        check_slice((1 << 14, 1 << 14, runs, (), ()))
    check_slice((1 << 14, 1 << 14, runs, (), (),
                 ("fall", (("run", 0),), (), (), ())))
