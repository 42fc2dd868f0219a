"""sparsex_tpu_torch's own host side plans what the reference plans.

The port carries copies of the reference's host code (I/O, mining and
encoding, ``CsxTables``, every layout and route planner and the executor's
``_maybe_build_pages``).  Each case below tunes one matrix with both
packages, under the same options and the same planner thresholds, and
asserts that the port produces, array for array with the same dtypes:

- the same ``CsxTables`` (``sparsex_tpu_torch.csx.encode_coo`` against the
  reference's ``CsxMatrix.from_coo``);
- the same plain ``meta`` and arrays (``static_meta``,
  ``tables_to_arrays``);
- the same ``_pages_meta`` and every plan array of ``_pages_arrays``
  (``ops.exec.HostPlan._maybe_build_pages`` against the reference
  executor's), compared recursively through dicts and lists.

The cases cover the headline and blocky matrices, the HPCG stencil (no
paged plan), the legacy paged variant with and without its scatter
routes (``dscatter``, ``fs``, ``fblk`` with its merged ``blk`` segments and
``bres`` residuals), the partial-segment routes of a width-5 run table
and a 3x3 block table (their ``fscatter`` arrays), the dense-tile K1 styles
``run16`` and ``sl``, ``spx.preproc.xform=none``, and a width-8 run table
whose overlapping route instances a merged plan takes.

One case is the intended divergence of the port's plan (ROADMAP,
"Intended divergences"): a fused run table whose route instances overlap
in source rows outside a merged plan.  The reference keeps it, and K1's
one G1 grid keeps the last fold's wires (a wrong y wherever its paged
variant runs); the port re-plans that table as its paged units with their
own route.  Everything else of that plan is the reference's.  Last, no
file of the port, ``chip_smoke.py``, ``tools/*_torch.py`` or
``examples/*_torch.py`` imports ``sparsex_tpu``, ``jax`` or ``bench`` at
any depth.
"""

import ast
import dataclasses
import enum
import glob
import os

import numpy as np
import pytest
import torch

import chip_smoke
import sparsex_tpu.ops.fused as fused
import sparsex_tpu.ops.pallas_kernels as pk
from sparsex_tpu.config import Config as RefConfig
from sparsex_tpu.csx import CsxMatrix as RefCsxMatrix
from sparsex_tpu.ops import route as route_mod
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.csx import encode_coo
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import pallas_kernels as tpk
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.exec import HostPlan

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SMALL = {"MIN_FUSED_NNZ": 256, "MIN_PAGE_NNZ": 64, "MIN_ELEMS": 64}
_NO_FUSE = {"spx.tpu.min_fused_nnz": str(1 << 30)}


@pytest.fixture(autouse=True)
def fresh_port_config():
    """The port's Config is its own singleton: reset it around every test,
    as tests/conftest.py resets the reference's."""
    spt.Config.reset()
    yield
    spt.Config.reset()


def _thresholds(monkeypatch, values):
    """Set planner thresholds alike on both packages."""
    mods = {"MIN_FUSED_NNZ": (fused, tf), "MIN_PAGE_NNZ": (pk, tpk),
            "MIN_ELEMS": (route_mod, troute)}
    for name, value in values.items():
        for mod in mods[name]:
            monkeypatch.setattr(mod, name, value)


def _hpcg(n):
    _n, rows, cols, vals = chip_smoke.hpcg_matrix(16)
    return rows, cols, vals


# name -> (builder, rows, value dtype, options, thresholds, extras the
# port's plan must hold)
CASES = {
    "headline": (chip_smoke.build_matrix, 1 << 15, "float32", {}, _SMALL,
                 {"dfused", "k3dias"}),
    "blocky": (chip_smoke.build_blocky_matrix, 1 << 16, "float64", {},
               _SMALL, {"dfused", "fall"}),
    "hpcg": (_hpcg, 16 ** 3, "float32", {"spx.preproc.sampling": "none"},
             {}, None),
    "paged": (chip_smoke.build_blocky_matrix, 1 << 16, "float32", _NO_FUSE,
              {"MIN_PAGE_NNZ": 1024, "MIN_ELEMS": 1 << 30}, {"dpages"}),
    "paged_routed": (chip_smoke.build_blocky_matrix, 1 << 16, "float32",
                     _NO_FUSE, {"MIN_PAGE_NNZ": 1024, "MIN_ELEMS": 1024},
                     {"dpages", "dscatter", "fall"}),
    "run16": (lambda n: chip_smoke.wide_run_matrix(n, 16), 1 << 15,
              "float32", {}, {"MIN_ELEMS": 1024}, {"dfused", "fall"}),
    "sl": (chip_smoke.lane_skew_matrix, 1 << 15, "float64", {}, {},
           {"dfused"}),
    "xform_none": (chip_smoke.build_matrix, 1 << 15, "float32",
                   {"spx.preproc.xform": "none"}, _SMALL, {"dfused"}),
    "fs_runs": (lambda n: chip_smoke.wide_run_matrix(n, 5), 1 << 16,
                "float64", {}, {"MIN_ELEMS": 1024}, {"dfused"}),
    "fs_blocks": (chip_smoke.block3_matrix, 3 << 14, "float32", {}, {},
                  set()),
    "overlap_merged": (lambda n: chip_smoke.overlap_run_matrix(n, 8, 4),
                       1 << 17, "float32", {}, {}, {"dfused", "fall"}),
}


def assert_same(a, b, path="plan"):
    """``a`` (the port's) equals ``b`` (the reference's) value for value:
    arrays by dtype, shape and content; dicts by keys in order; lists and
    tuples item by item; dataclasses field by field; enums by value."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), (path, list(a),
                                                            list(b))
        for k in b:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(b):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(b, enum.Enum):
        assert type(a).__name__ == type(b).__name__, path
        assert a.value == b.value, path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _tune_both(monkeypatch, build, n, dtype, thresholds, options=()):
    """The port's HostPlan and the reference executor of one matrix, tuned
    under the same options and thresholds, both planned, after holding
    their tables and plain metas and arrays equal."""
    _thresholds(monkeypatch, thresholds)
    options = {"spx.tpu.value_dtype": dtype, "spx.preproc.xform": "all",
               "spx.preproc.sampling": "portion", **dict(options)}
    for cfg in (spt.Config.instance(), RefConfig.instance()):
        for key, value in options.items():
            cfg.set(key, value)
    rows, cols, vals = build(n)
    ref = RefCsxMatrix.from_coo(n, n, rows, cols, vals)
    (ref_tables,), (ref_ex,) = ref.shards, ref.executors
    _part, tables, _log = encode_coo(n, n, rows, cols, vals,
                                     spt.Config.instance())
    assert_same(tables, ref_tables, "tables")
    plan = HostPlan(tables)
    assert_same(plan.meta, ref_ex.meta, "meta")
    assert_same(plan.arrays, ref_ex.arrays, "arrays")
    ref_ex._maybe_build_pages()
    plan._maybe_build_pages()
    return plan, ref_ex


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_plans_the_reference_arrays(monkeypatch, name):
    build, n, dtype, options, thresholds, extras = CASES[name]
    plan, ref_ex = _tune_both(monkeypatch, build, n, dtype, thresholds,
                              options)
    assert_same(plan._pages_meta, ref_ex._pages_meta, "pages_meta")
    assert_same(plan._pages_arrays, ref_ex._pages_arrays, "pages_arrays")
    if extras is None:
        assert plan._pages_meta is None
    else:
        assert {e[0] for e in plan._pages_meta[5:] if e} >= extras
    if name == "run16":
        assert "run16" in {m[5] for _, m in
                           chip_smoke.fused_runs(plan._pages_meta)}
    if name == "sl":
        fmeta = next(e for e in plan._pages_meta[5:] if e[0] == "dfused")[1]
        assert fmeta[6] == "sl"
    if name == "paged_routed":   # an fs run table and an fblk block table
        kinds = {e[5][0] for e in plan._pages_meta[3] if len(e) > 5}
        kinds |= {e[4][0] for e in plan._pages_meta[2] if e[4]}
        assert kinds == {"fs", "fblk"}
    if name == "overlap_merged":  # the merged plan takes overlapping runs
        (_ri, m), = chip_smoke.fused_runs(plan._pages_meta)
        assert tf.instances_overlap(m[3])
    if name.startswith("fs_"):   # the routed table carries its fscatter
        (fs,) = chip_smoke.fs_tables(plan._pages_meta)
        kind, i, _e = fs
        assert "g1_0" in plan._pages_arrays[kind][i]["fscatter"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_port_replans_overlapping_fused_runs(monkeypatch, dtype):
    """The intended divergence: ``overlap_run_matrix(4096, 17, 2)`` under
    the small thresholds.  The reference plans a fused run32 table whose
    two route instances cover the same source rows, outside any merged
    plan; the port plans that table as a paged run table with an ``fs``
    route.  Every other meta entry and array is the reference's."""
    plan, ref_ex = _tune_both(
        monkeypatch, lambda n: chip_smoke.overlap_run_matrix(n, 17, 2),
        4096, dtype, _SMALL)
    ref_meta, meta = ref_ex._pages_meta, plan._pages_meta
    (ri, m), = chip_smoke.fused_runs(ref_meta)
    assert "fall" not in {e[0] for e in ref_meta[5:] if e}
    assert tf.instances_overlap(m[3])
    entry = meta[2][ri]
    assert len(entry) == 5 and entry[3] is not None and entry[4][0] == "fs"
    assert chip_smoke.fused_runs(meta) == []
    others = [i for i in range(len(ref_meta[2])) if i != ri]
    assert_same([meta[2][i] for i in others],
                [ref_meta[2][i] for i in others], "run_meta")
    assert_same(meta[:2] + meta[3:], ref_meta[:2] + ref_meta[3:], "meta")
    arrays, ref_arrays = plan._pages_arrays, ref_ex._pages_arrays
    assert_same([arrays["runs"][i] for i in others],
                [ref_arrays["runs"][i] for i in others], "runs")
    assert_same({k: v for k, v in arrays.items() if k != "runs"},
                {k: v for k, v in ref_arrays.items() if k != "runs"},
                "pages_arrays")
    assert "fscatter" in arrays["runs"][ri]


def test_assert_same_sees_a_difference():
    """The comparison itself catches a changed value, dtype or key."""
    a = {"x": np.arange(3), "t": (1, "lp")}
    assert_same({"x": np.arange(3), "t": (1, "lp")}, a)
    for bad in ({"x": np.arange(3) + 1, "t": (1, "lp")},
                {"x": np.arange(3, dtype=np.int32), "t": (1, "lp")},
                {"x": np.arange(3), "t": (1, "sl")},
                {"t": (1, "lp"), "x": np.arange(3)}):
        with pytest.raises(AssertionError):
            assert_same(bad, a)


def _imports(path):
    """Every module name an ``import`` or ``from ... import`` in ``path``
    names, at any depth (module level or inside a function)."""
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


def test_port_imports_nothing_of_the_reference():
    files = sorted(glob.glob(os.path.join(ROOT, "sparsex_tpu_torch", "**",
                                          "*.py"), recursive=True))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    files += sorted(glob.glob(os.path.join(ROOT, "tools", "*_torch.py")))
    files += sorted(glob.glob(os.path.join(ROOT, "examples", "*_torch.py")))
    # the rank bodies of the multi-device tests, which spawned ranks import
    files.append(os.path.join(ROOT, "tests", "torch_ranks.py"))
    assert len(files) > 20
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {"sparsex_tpu_torch/persist.py",
            "sparsex_tpu_torch/ops/vector.py",
            "sparsex_tpu_torch/solvers.py",
            "sparsex_tpu_torch/ops/spgemm.py",
            "sparsex_tpu_torch/ops/oracle.py",
            "examples/cg_example_torch.py",
            "sparsex_tpu_torch/parallel/shard.py",
            "sparsex_tpu_torch/parallel/comm.py",
            "tests/torch_ranks.py"} <= names
    assert len([n for n in names if n.startswith("examples/")]) == 9
    bad = {}
    for path in files:
        top = {m.split(".")[0] for m in _imports(path)}
        hit = top & {"sparsex_tpu", "jax", "jaxlib", "bench"}
        if hit:
            bad[os.path.relpath(path, ROOT)] = sorted(hit)
    assert bad == {}
