"""The multi-device executor (``sparsex_tpu_torch/parallel/shard.py``) on
the CPU, against the JAX package's ``ShardedCsx`` on the 8-device virtual
CPU mesh (conftest.py) and a float64 COO oracle.

(a) Layout, no processes: ``plan_layout`` gives the reference's
``x_mode``, ``halo_k`` and ``chunk``, and its demoted shards, column spans,
halo split (local and halo sets) and window-rebased symmetric tables equal
the reference's ``_demote_sr_run_tables``, ``_col_span``,
``_split_tables_for_halo`` and ``_rebase_tables_window`` array for array.

(b) Ranks: each case's matrix, tuned by the port on the CPU, runs on a
gloo group of N spawned ranks (``comm.run_ranks``; the bodies are
``tests/torch_ranks.py``, which imports no JAX), one process group a group
size for all cases.  In float64 every rank's y (alpha, beta and y given)
must equal every other rank's and lie within 1e-10 of the reference's
``ShardedCsx.matvec`` (relative to its largest value) and 1e-6 of the
oracle; the SpMM (k = 3) likewise against the reference's ``matmat``; CG
over the sharded A must take the reference's iteration count and give its
x within 1e-10.  Cases: the reference's ``test_shard.py`` and
``test_halo.py`` matrices (banded n = 257 at 2, 4 and 8 ranks, halo auto,
forced and wide, halo and replicated at 8 ranks, the wide-span fall-back,
symmetric replicated and halo at 2 and 4 ranks, a banded symmetric matrix
in halo mode, mixed shards some without DIA tables, restore-then-shard,
the fused delta per rank and a paged routed symmetric plan with the
planners' thresholds lowered in the ranks, vertical and diagonal runs
demoted), an s.p.d. matrix for CG, and a group of the wrong size, which
raises ``ValueError``.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import sparsex_tpu.ops.fused as fused
import sparsex_tpu.ops.pallas_kernels as pk
import sparsex_tpu.parallel.shard as ref_shard
from sparsex_tpu.config import Config as RefConfig
from sparsex_tpu.csx import CsxMatrix as RefCsxMatrix
from sparsex_tpu.ops import route as route_mod
from sparsex_tpu.solvers import cg as ref_cg
from sparsex_tpu.symmetric import build_symmetric_csx as ref_build_sym

import sparsex_tpu_torch as spt
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.parallel import shard as tshard
from sparsex_tpu_torch.parallel.comm import run_ranks
from sparsex_tpu_torch.parallel.shard import host_side
from sparsex_tpu_torch.persist import save_csx
from sparsex_tpu_torch.symmetric import build_symmetric_csx
from test_halo import banded_random
from test_solvers import spd_coo
from test_torch_plan import assert_same
import chip_smoke
import torch_ranks
from tests import fixtures

torch.set_num_threads(1)

# (against the reference, against the oracle) by value type: float64 as
# relative errors to the largest value, float32 as chip_smoke's mixed ones
BARS = {"float64": (1e-10, 1e-6),
        "float32": (chip_smoke.CHECK_TOL, chip_smoke.CHECK_TOL)}
ALPHA, BETA = 1.2, -0.3


# ---------------------------------------------------------------------------
# the matrices: (n, rows, cols, vals), each a full COO
# ---------------------------------------------------------------------------
def _symmetrized(n, rs, cs, vs):
    """The full symmetric COO of a lower triangle with its diagonal."""
    off = rs != cs
    rows = np.concatenate([rs, cs[off]])
    cols = np.concatenate([cs, rs[off]])
    vals = np.concatenate([vs, vs[off]])
    o = np.lexsort((cols, rows))
    return n, rows[o], cols[o], vals[o]


def _halo_symmetric(n=2048, seed=5):
    """test_halo.py:test_halo_symmetric_matches_replicated's banded
    symmetric matrix (float64 here)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 2 * n)
    off = rng.integers(0, 200, 2 * n)
    rs = np.concatenate([r, np.arange(n)])
    cs = np.concatenate([np.maximum(r - off, 0), np.arange(n)])
    k = np.unique(rs * n + cs)
    return _symmetrized(n, k // n, k % n, rng.standard_normal(k.size))


def _paged_symmetric(n=3000, seed=9):
    """test_shard.py:test_sharded_symmetric_paged_routed_interpret's."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 2 * n)
    c = rng.integers(0, n, 2 * n)
    lo = r >= c
    rs = np.concatenate([r[lo], np.arange(n)])
    cs = np.concatenate([c[lo], np.arange(n)])
    k = np.unique(rs * n + cs)
    return _symmetrized(n, k // n, k % n, rng.standard_normal(k.size))


def _dia_symmetric(n=4096, seed=13):
    """A symmetric matrix of full diagonals (0, 1, 2, 40 below the
    diagonal, the DIA tables) and singles within 150 of the diagonal (the
    delta, paged with the thresholds lowered): the symmetric halo mode's
    transposed DIA windows and paged transposed stream."""
    rng = np.random.default_rng(seed)
    rs = [np.arange(b, n) for b in (0, 1, 2, 40)]
    cs = [r - b for r, b in zip(rs, (0, 1, 2, 40))]
    r = rng.integers(150, n, 3 * n)
    rs.append(r)
    cs.append(r - rng.integers(3, 150, r.size))
    k = np.unique(np.concatenate(rs) * n + np.concatenate(cs))
    return _symmetrized(n, k // n, k % n, rng.standard_normal(k.size))


def _hpcg(perturb):
    """HPCG's 27-point stencil on a 16^3 grid (``chip_smoke.hpcg_matrix``):
    every shard all DIA tables; ``perturb`` scales each value by a seeded
    1 + 0.1 N(0, 1), so that float32 rounds."""
    def build():
        n, rows, cols, vals = chip_smoke.hpcg_matrix(16)
        if perturb:
            vals = vals * (1 + 0.1 * np.random.default_rng(17)
                           .standard_normal(vals.size))
        return n, rows, cols, vals
    return build


def _dedup(n, rows, cols, rng):
    _, u = np.unique(rows.astype(np.int64) * n + cols, return_index=True)
    rows, cols = rows[u], cols[u]
    o = np.lexsort((cols, rows))
    return n, rows[o], cols[o], rng.standard_normal(rows.size)


def _fused_random(n=8192, seed=3):
    """test_shard.py:test_sharded_fused_delta_interpret's random singles."""
    rng = np.random.default_rng(seed)
    return _dedup(n, rng.integers(0, n, 40000), rng.integers(0, n, 40000),
                  rng)


def _fused_near_diagonal(n=8192, seed=3):
    """The same test's halo matrix: two bands and near-diagonal singles."""
    rng = np.random.default_rng(seed)
    rows = [np.arange(n), np.arange(n - 1)]
    cols = [np.arange(n), np.arange(1, n)]
    r = rng.integers(0, n, 40000)
    rows.append(r)
    cols.append(np.clip(r + rng.integers(-700, 700, 40000), 0, n - 1))
    return _dedup(n, np.concatenate(rows), np.concatenate(cols), rng)


def _mixed(n=128, seed=11):
    """test_shard.py:test_mixed_shards_some_without_dias's: a dense
    diagonal on top, random singles below."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(n // 2), rng.integers(n // 2, n, 120)])
    cols = np.concatenate([np.arange(n // 2), rng.integers(0, n, 120)])
    return _dedup(n, rows, cols, rng)


def _superdiagonal(n=96, seed=12):
    """test_shard.py:test_restore_then_shard's."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n - 1)
    return n, rows, rows + 1, rng.standard_normal(n - 1)


def _diag_runs(n=8192, seed=31):
    """test_shard.py:test_sharded_diag_class_demotes's diagonal and
    vertical runs among random singles."""
    rng = np.random.default_rng(seed)
    j16 = np.arange(16)
    dr = rng.integers(0, n - 16, 300)
    dc = rng.integers(0, n - 16, 300)
    vr = rng.integers(0, n - 8, 300)
    vc = rng.integers(0, n, 300)
    rows = np.concatenate([(dr[:, None] + j16).ravel(),
                           (vr[:, None] + np.arange(8)).ravel(),
                           rng.integers(0, n, 20000)])
    cols = np.concatenate([(dc[:, None] + j16).ravel(), np.repeat(vc, 8),
                           rng.integers(0, n, 20000)])
    return _dedup(n, rows, cols, rng)


def _fixture(fn, **kw):
    def build():
        nrows, _ncols, rows, cols, vals = fn(**kw)
        return nrows, rows, cols, vals
    return build


def _banded_halo(n, bands, extra, seed):
    def build():
        return (n,) + banded_random(n, bands, extra, seed)
    return build


def _spd():
    return (128,) + spd_coo(128, seed=4)


XF = {"spx.preproc.xform": "all"}
XF_NS = {"spx.preproc.xform": "all", "spx.preproc.sampling": "none"}
SYM = {"spx.matrix.symmetric": "true"}
FUSED_T = {"MIN_PAGE_NNZ": 64, "MIN_ELEMS": 64}
PAGED_T = {"MIN_PAGE_NNZ": 64, "MIN_ELEMS": 128}
MV, MM, CG = "matvec", "matmat", "cg"

# name: (ranks, builder, options, planner thresholds (set in the ranks),
# operations, expected x mode or None)
CASES = {
    "banded257_x2": (2, _fixture(fixtures.banded_coo, n=257), XF, {},
                     (MV, MM), "replicated"),
    "banded257_x4": (4, _fixture(fixtures.banded_coo, n=257), XF, {},
                     (MV, MM), "halo"),
    "banded257_x8": (8, _fixture(fixtures.banded_coo, n=257), XF, {},
                     (MV,), "halo"),
    "halo_auto_x8": (8, _banded_halo(256, (0, 1, -1, 5), 0, 0), XF_NS, {},
                     (MV,), "halo"),
    "halo_forced_wide_x4": (4, _banded_halo(128, (0, 3), 300, 0),
                            dict(XF_NS, **{"spx.tpu.x_mode": "halo"}), {},
                            (MV, MM), "halo"),
    "halo_x8": (8, _banded_halo(192, (0, 2, -7), 24, 5),
                dict(XF_NS, **{"spx.tpu.x_mode": "halo"}), {}, (MV,),
                "halo"),
    "replicated_x8": (8, _banded_halo(192, (0, 2, -7), 24, 5),
                      dict(XF_NS, **{"spx.tpu.x_mode": "replicated"}), {},
                      (MV,), "replicated"),
    "wide_span_x8": (8, _banded_halo(128, (0,), 400, 0), XF_NS, {}, (MV,),
                     "replicated"),
    "symmetric_x2": (2, _fixture(fixtures.symmetric_coo, n=90, seed=8),
                     dict(XF, **SYM), {}, (MV, MM), "replicated"),
    "symmetric_x4": (4, _fixture(fixtures.symmetric_coo, n=90, seed=8),
                     dict(XF, **SYM), {}, (MV,), "replicated"),
    "symmetric_halo_x2": (2, _fixture(fixtures.symmetric_coo, n=90, seed=8),
                          dict(XF, **SYM, **{"spx.tpu.x_mode": "halo"}), {},
                          (MV, MM), "halo"),
    "symmetric_halo_x4": (4, _fixture(fixtures.symmetric_coo, n=90,
                                      seed=8),
                          dict(XF, **SYM, **{"spx.tpu.x_mode": "halo"}), {},
                          (MV,), "halo"),
    "symmetric_banded_halo_x4": (4, _halo_symmetric, dict(XF, **SYM), {},
                                 (MV, MM), "halo"),
    "symmetric_dia_halo_x4": (4, _dia_symmetric, dict(XF_NS, **SYM), PAGED_T,
                              (MV, MM), "halo"),
    "paged_symmetric_halo_x4": (4, _paged_symmetric,
                                dict(XF, **SYM, **{"spx.tpu.x_mode": "halo"}),
                                PAGED_T, (MV,), "halo"),
    "hpcg_f32_x4": (4, _hpcg(True),
                    dict(XF_NS, **{"spx.tpu.value_dtype": "float32"}), {},
                    (MV, MM), "halo"),
    "symmetric_hpcg_f32_x4": (4, _hpcg(False),
                              dict(XF_NS, **SYM,
                                   **{"spx.tpu.value_dtype": "float32"}),
                              {}, (MV,), "halo"),
    "mixed_shards_x2": (2, _mixed, XF_NS, {}, (MV,), None),
    "restore_x4": (4, _superdiagonal, XF_NS, {}, (MV,), None),
    "fused_x4": (4, _fused_random,
                 {"spx.tpu.min_fused_nnz": 256, "spx.preproc.xform": "none",
                  "spx.tpu.x_mode": "replicated"}, FUSED_T, (MV, MM),
                 "replicated"),
    "fused_halo_x4": (4, _fused_near_diagonal,
                      {"spx.tpu.min_fused_nnz": 256,
                       "spx.preproc.xform": "none",
                       "spx.tpu.x_mode": "halo"}, FUSED_T, (MV, MM), "halo"),
    "paged_symmetric_x4": (4, _paged_symmetric, dict(XF, **SYM), PAGED_T,
                           (MV,), None),
    "diag_demoted_x4": (4, _diag_runs,
                        {"spx.tpu.min_fused_nnz": 256,
                         "spx.preproc.xform": "v,d",
                         "spx.tpu.x_mode": "replicated"},
                        dict(FUSED_T, MIN_FUSED_NNZ=256), (MV,),
                        "replicated"),
    "cg_x4": (4, _spd, XF_NS, {}, (MV, CG), None),
}


def _options(case, nranks):
    return dict(CASES[case][2], **{"spx.rt.nr_threads": nranks})


def _set(cfg, options):
    for key, value in options.items():
        cfg.set(key, str(value))


def _tune_port(case, device="cpu"):
    """The port's matrix of ``case`` on ``device`` and its COO."""
    nranks, build, _opts, _t, _ops, _mode = CASES[case]
    n, rows, cols, vals = build()
    options = _options(case, nranks)
    _set(spt.Config.reset(), options)
    if options.get("spx.matrix.symmetric") == "true":
        csx = build_symmetric_csx(n, n, rows, cols, vals, device=device)
    else:
        csx = spt.mat_tune(spt.input_load_csr(*_csr(n, rows, cols, vals),
                                              n, n), device=device).csx
    spt.Config.reset()
    return csx, (n, rows, cols, vals)


def _tune_ref(case):
    nranks, build, _opts, _t, _ops, _mode = CASES[case]
    n, rows, cols, vals = build()
    options = _options(case, nranks)
    _set(RefConfig.instance(), options)
    if options.get("spx.matrix.symmetric") == "true":
        return ref_build_sym(n, n, rows, cols, vals)
    return RefCsxMatrix.from_coo(n, n, rows, cols, vals)


def _csr(n, rows, cols, vals):
    order = np.lexsort((cols, rows))
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return rowptr, np.asarray(cols)[order], np.asarray(vals)[order]


def _ops(case, n):
    """The operations of ``case`` with their operands (numpy, seeded)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    out = []
    for kind in CASES[case][4]:
        if kind == MV:
            out.append((MV, rng.standard_normal(n), ALPHA, BETA,
                        rng.standard_normal(n)))
        elif kind == MM:
            out.append((MM, rng.standard_normal((n, 3)), ALPHA))
        else:
            out.append((CG, rng.standard_normal(n), 1e-10, 500))
    return out


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("shards",))


def _thresholds(monkeypatch, values):
    """Planner thresholds set alike on both packages."""
    mods = {"MIN_FUSED_NNZ": (fused, tf), "MIN_PAGE_NNZ": (pk, tpk),
            "MIN_ELEMS": (route_mod, troute)}
    for name, value in values.items():
        for mod in mods[name]:
            monkeypatch.setattr(mod, name, value)


def _rel(got, want, dtype="float64"):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if dtype == "float32":
        return chip_smoke._mixed_rel_err(got, want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _oracle(n, rows, cols, vals, x):
    if x.ndim == 2:
        return np.stack([_oracle(n, rows, cols, vals, x[:, j])
                         for j in range(x.shape[1])], axis=1)
    return np.bincount(rows, weights=vals * x[cols], minlength=n)


# ---------------------------------------------------------------------------
# (a) the layout, without processes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_reference(monkeypatch, case):
    nranks, _build, _opts, thresholds, _ops_, mode = CASES[case]
    _thresholds(monkeypatch, thresholds)
    csx, _coo = _tune_port(case)
    ref = _tune_ref(case)
    assert_same(csx.shards, ref.shards, "shards")
    # the reference demotes only where its Pallas stacking runs; the
    # port's kernels run in every type, so the demotion is held against
    # the reference's with that gate open
    monkeypatch.setattr(ref_shard, "_pallas_stacking_ok", lambda vdt: True)
    ref_demoted = ref_shard._demote_sr_run_tables(ref.shards)
    monkeypatch.undo()
    _thresholds(monkeypatch, thresholds)
    demoted = tshard._demote_sr_run_tables(csx.shards)
    assert_same(demoted, ref_demoted, "demoted")
    if case == "diag_demoted_x4":
        assert demoted is not csx.shards and not any(
            rt.rows.size and tshard.run_step(rt.enc)[0]
            for t in demoted for rt in t.runs)
    assert [tshard._col_span(t) for t in demoted] == [
        ref_shard._col_span(t) for t in ref_demoted]
    _set(spt.Config.instance(), _options(case, nranks))
    lay = tshard.plan_layout(csx, nranks)
    spt.Config.reset()
    if demoted is csx.shards:   # the reference resolves on its own shards
        sh = ref_shard.ShardedCsx(ref, mesh=_mesh(nranks))
        assert (lay.x_mode, lay.halo_k, lay.chunk) == (
            sh.x_mode, sh.halo_k, sh.chunk)
    if mode is not None:
        assert lay.x_mode == mode
    k, chunk = lay.halo_k, lay.chunk
    for i, s in sorted(lay.sets.items()):
        t = ref_demoted[i]
        if lay.x_mode == "halo" and csx.symmetric:
            base_h = (i - k) * chunk
            assert_same(s.tables, ref_shard._rebase_tables_window(t, base_h),
                        f"rebased {i}")
            assert (s.gather_off, s.z_base) == (t.row_start - base_h,
                                                base_h)
            if demoted is csx.shards:
                assert s.gather_off == int(sh.arrays["row_start"][i, 0])
                assert s.z_base == int(sh.arrays["z_base"][i, 0])
        elif lay.x_mode == "halo":
            local, halo = ref_shard._split_tables_for_halo(t, i, k, chunk)
            assert_same(s.local, local, f"local {i}")
            assert_same(s.halo, halo, f"halo {i}")
        else:
            assert_same(s.tables, t, f"shard {i}")


def test_plan_layout_refuses_a_wrong_rank_count():
    csx, _coo = _tune_port("banded257_x4")
    with pytest.raises(ValueError, match="nr_threads=2"):
        tshard.plan_layout(csx, 2)


# ---------------------------------------------------------------------------
# (b) gloo ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's matrix tuned by the port and run on its group of
    spawned gloo ranks, once: the output directory."""
    d = tmp_path_factory.mktemp("ranks")
    cases = []
    for name, (nranks, _b, _o, thresholds, _ops_, _m) in CASES.items():
        old = torch_ranks._thresholds(thresholds)
        try:
            csx, (n, _r, _c, _v) = _tune_port(name)
        finally:
            torch_ranks._thresholds(old)
        case = {"name": name, "nranks": nranks,
                "options": _options(name, nranks),
                "thresholds": thresholds, "ops": _ops(name, n)}
        if name.startswith("restore"):
            case["archive"] = str(d / f"{name}.npz")
            save_csx(csx, case["archive"])
        else:
            case["host"] = host_side(csx)
        cases.append(case)
    # a group of 2 given a matrix of 4 shards
    csx, _coo = _tune_port("banded257_x4")
    cases.append({"name": "wrong_size", "nranks": 2, "raises": True,
                  "options": {}, "thresholds": {}, "ops": [],
                  "host": host_side(csx)})
    path = d / "cases.pkl"
    with open(path, "wb") as fp:
        pickle.dump(cases, fp)
    for nranks in sorted({c["nranks"] for c in cases}):
        run_ranks(torch_ranks.run_cases, nranks, (str(path), str(d)))
    return d


def _results(d, case, nranks):
    out = []
    for r in range(nranks):
        with open(os.path.join(d, f"{case}.{r}.pkl"), "rb") as fp:
            out.append(pickle.load(fp))
    return out


def _reference_results(case, ops):
    nranks = CASES[case][0]
    sh = ref_shard.ShardedCsx(_tune_ref(case), mesh=_mesh(nranks))
    out = []
    for op in ops:
        if op[0] == MV:
            _, x, alpha, beta, y = op
            out.append(np.asarray(sh.matvec(x, alpha=alpha, beta=beta,
                                            y=y)))
        elif op[0] == MM:
            out.append(np.asarray(sh.matmat(op[1], alpha=op[2])))
        else:
            x, it, res = ref_cg(lambda v: sh.matvec(v), op[1], tol=op[2],
                                maxiter=op[3])
            out.append((np.asarray(x), int(it), float(res)))
    return sh, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_match_reference(ranks, case):
    nranks, build, _o, _t, _ops_, mode = CASES[case]
    n, rows, cols, vals = build()
    ops = _ops(case, n)
    got = _results(ranks, case, nranks)
    sh, want = _reference_results(case, ops)
    assert got[0]["layout"] == (sh.x_mode, sh.halo_k, sh.chunk) or (
        case == "diag_demoted_x4")
    if mode is not None:
        assert got[0]["layout"][0] == mode
    dtype = CASES[case][2].get("spx.tpu.value_dtype", "float64")
    tol_ref, tol_oracle = BARS[dtype]
    for j, op in enumerate(ops):
        for r in range(nranks):   # the same result on every rank
            a, b = got[r]["results"][j], got[0]["results"][j]
            if op[0] == CG:
                assert a[1] == b[1]
                a, b = a[0], b[0]
            assert np.array_equal(a, b), (case, op[0], r)
        res = got[0]["results"][j]
        if op[0] == CG:
            x, it, _res = res
            assert it == want[j][1], (it, want[j][1])
            assert _rel(x, want[j][0]) < tol_ref
            resid = _rel(_oracle(n, rows, cols, vals, x), op[1])
            assert resid < 1e-8
            continue
        assert _rel(res, want[j], dtype) < tol_ref, (case, op[0])
        x = op[1].astype(dtype).astype(np.float64)
        oracle = ALPHA * _oracle(n, rows, cols,
                                 vals.astype(dtype).astype(np.float64), x)
        if op[0] == MV:
            oracle = oracle + BETA * op[4].astype(dtype)
        assert _rel(res, oracle, dtype) < tol_oracle, (case, op[0])
        assert res.dtype == np.dtype(dtype), (case, res.dtype)


def test_fused_and_paged_plans_ran_in_the_ranks(ranks):
    """The lowered thresholds reached the ranks' planners: each rank's
    shard planned the fused delta pipeline, or both paged delta streams
    with the transposed route, as in the reference's tests of the stacked
    plans (test_shard.py:149, :199)."""
    for case in ("fused_x4", "fused_halo_x4"):
        for out in _results(ranks, case, 4):
            assert "dfused" in out["classes"][0], (case, out["classes"])
    for case in ("paged_symmetric_x4", "paged_symmetric_halo_x4",
                 "symmetric_dia_halo_x4"):
        outs = _results(ranks, case, 4)
        for out in outs:
            assert {"dpages", "dpagesT"} <= set(out["classes"][0]), case
        assert any("dscatterT" in o["classes"][0] for o in outs), case


def test_symmetric_halo_ranks_run_dia_tables():
    """The symmetric halo case of full diagonals plans DIA tables on
    every rank, whose transposed windows land at the window's global
    columns (``z_off``)."""
    csx, _coo = _tune_port("symmetric_dia_halo_x4")
    assert all(t.dias for t in csx.shards)


@pytest.mark.parametrize("case", ["banded257_x4", "symmetric_halo_x2",
                                  "symmetric_x2", "banded257_x2",
                                  "hpcg_f32_x4"])
def test_exchange_bytes(ranks, case):
    """Each rank's collectives move what the mode needs, in the matrix's
    value type on every rank (a float32 matrix's ranks all compute in
    float32, those whose table sets hold no delta too): the ring 2 k
    chunks a call, the reduce-scatter on symmetric matrices only."""
    nranks, _b, _o, _t, ops, _m = CASES[case]
    for out in _results(ranks, case, nranks):
        x_mode, k, chunk = out["layout"]
        assert out["calls"]["all_gather"] == len(ops)
        ring = out["bytes"].get("ring", 0)
        if x_mode == "halo":
            # the SpMV's chunk, then the SpMM's (chunk, 3)
            size = 4 if "f32" in case else 8
            want = 2 * k * chunk * size * (1 + 3 * (MM in ops))
            assert ring == want, (ring, want)
        else:
            assert ring == 0
        sym = CASES[case][2].get("spx.matrix.symmetric") == "true"
        assert ("reduce_scatter" in out["bytes"]) == sym


def test_wrong_group_size_raises(ranks):
    for out in _results(ranks, "wrong_size", 2):
        assert "4 shards" in out["raised"] and "2 ranks" in out["raised"]
