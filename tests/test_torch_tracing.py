"""The port's spans and counters (``sparsex_tpu_torch.timing``) on the CPU.

The registry's count, seconds, self seconds and parent on nested spans;
nothing handed to a profiler when none records, and under
``torch.profiler`` the ``spx.*`` ranges nested in the caller's own range;
every name the port records starts with ``spx.`` (never ``port.`` or
``loop.``, the benchmark's own ranges); the tune's sort, encode, plan and
upload spans against ``csx.timers["preproc"]``; rejected planner time
counted once; one ``spx.exec.call`` a call; the plan's bytes; the solver's
spans; ``trace_reset``.  The tests marked ``cuda`` (the executor's graph
counters, the solver's capture and first replay) run on the card:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_tracing.py``.  This file imports no JAX.
"""

import ast
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
import sparsex_tpu_torch as spt
from sparsex_tpu_torch import solvers, timing
from sparsex_tpu_torch.ops import route as troute

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUNE_PARTS = ("spx.tune.sort", "spx.tune.encode", "spx.tune.plan",
              "spx.tune.upload")


@pytest.fixture(autouse=True)
def fresh():
    spt.Config.reset()
    timing.trace_reset()
    yield
    spt.Config.reset()


def spans():
    return spt.trace_snapshot()["spans"]


def random_graph(n, per_row, seed=0):
    """A CSR of about ``per_row`` random entries a row: its delta singles
    plan ``dpages`` with both scatter-route plans rejected (over the
    network's capacity), as the urand cell's do."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, n, per_row * n) * n
                     + rng.integers(0, n, per_row * n))
    rows, cols = keys // n, keys % n
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return rowptr, cols, rng.random(keys.size)


def tune_graph(n=1 << 12, per_row=16):
    rowptr, cols, vals = random_graph(n, per_row)
    return spt.mat_tune(spt.input_load_csr(rowptr, cols, vals, n, n),
                        device="cpu")


def tune_hpcg(nx=16):
    n, rows, cols, vals = chip_smoke.hpcg_matrix(nx)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return spt.mat_tune(spt.input_load_csr(rowptr, cols, vals, n, n),
                        device="cpu")


def busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_nested_spans_record_count_seconds_self_and_parent():
    for _ in range(2):
        with timing.span("spx.t.outer") as outer:
            busy(0.002)
            with timing.span("spx.t.inner") as inner:
                busy(0.004)
            with timing.span("spx.t.inner"):
                busy(0.001)
    got = spans()
    o, i = got["spx.t.outer"], got["spx.t.inner"]
    assert (o["count"], i["count"]) == (2, 4)
    assert (o["parent"], i["parent"]) == (None, "spx.t.outer")
    assert outer.seconds >= 0.007 and inner.seconds >= 0.004
    assert o["seconds"] >= 0.014 and i["seconds"] >= 0.010
    # self seconds: the outer's own 2 ms a time, the inner's child-free
    assert o["self_seconds"] == pytest.approx(o["seconds"] - i["seconds"])
    assert i["self_seconds"] == pytest.approx(i["seconds"])
    assert 0.004 <= o["self_seconds"] < o["seconds"]


def test_a_timer_with_a_span_is_that_span():
    tc = timing.TimerCollection()
    tc.create_timer("preproc", span="spx.t.timer")
    for _ in range(3):
        tc.start_timer("preproc")
        with timing.span("spx.t.child"):
            busy(0.001)
        tc.pause_timer("preproc")
    got = spans()
    assert got["spx.t.timer"]["count"] == 3
    assert got["spx.t.timer"]["seconds"] == tc.get_secs("preproc")
    assert got["spx.t.child"]["parent"] == "spx.t.timer"
    # a plain timer records nothing
    plain = timing.Timer()
    plain.start()
    plain.pause()
    assert set(spans()) == {"spx.t.timer", "spx.t.child"}


def test_counters_add_and_keep_the_largest():
    timing.count("spx.t.n")
    timing.count("spx.t.n", 4)
    for v in (3, 9, 2):
        timing.count_max("spx.t.max", v)
    assert spt.trace_snapshot()["counters"] == {"spx.t.n": 5, "spx.t.max": 9}


def test_trace_reset_empties_the_registry():
    with timing.span("spx.t.a"):
        timing.count("spx.t.c")
    with timing.span("spx.t.open"):
        spt.trace_reset()
        assert spt.trace_snapshot() == {"spans": {}, "counters": {}}
    # a span open across the reset records when it closes
    assert list(spans()) == ["spx.t.open"]
    spt.trace_reset()
    assert spt.trace_snapshot() == {"spans": {}, "counters": {}}


def test_the_registry_outlives_the_matrix_and_the_options():
    A = tune_graph(1 << 10, 4)
    spt.matvec_mult(1.0, A, np.ones(A.ncols), device="cpu")
    spt.mat_destroy(A)
    spt.Config.reset()
    assert spans()["spx.exec.call"]["count"] == 1
    assert spans()["spx.tune"]["count"] == 1


def test_a_span_left_open_by_an_exception_does_not_become_a_parent():
    with pytest.raises(ValueError):
        with timing.span("spx.t.outer"):
            timing.span("spx.t.leaked").__enter__()
            raise ValueError
    with timing.span("spx.t.after"):
        pass
    assert spans()["spx.t.after"]["parent"] is None
    assert "spx.t.leaked" not in spans()


def test_spans_of_worker_threads_name_the_callers_span():
    def work(i):
        with timing.span("spx.t.worker"):
            busy(0.001)
        return threading.get_ident()

    from concurrent.futures import ThreadPoolExecutor
    with timing.span("spx.t.caller"):
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(timing.carry(work), range(4)))
    got = spans()
    assert got["spx.t.worker"] == {**got["spx.t.worker"], "count": 4,
                                   "parent": "spx.t.caller"}
    # another thread's spans are not taken out of the caller's self time
    assert got["spx.t.caller"]["self_seconds"] == got["spx.t.caller"][
        "seconds"]


def test_no_update_is_lost_across_threads():
    """More threads than cores, switching as often as the interpreter
    allows: every span and count lands once."""
    import sys
    workers, each = 4 * (os.cpu_count() or 1), 300

    def work():
        for _ in range(each):
            with timing.span("spx.t.shared"):
                timing.count("spx.t.n")
                timing.count_max("spx.t.max", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = spt.trace_snapshot()
    assert snap["spans"]["spx.t.shared"]["count"] == workers * each
    assert snap["counters"] == {"spx.t.n": workers * each, "spx.t.max": 1}


def test_a_tune_in_shards_keeps_its_spans_under_the_tune():
    spt.option_set("spx.rt.nr_threads", "2")
    tune_graph(1 << 11, 4)
    got = spans()
    assert got["spx.tune.encode"]["count"] == 2
    assert got["spx.tune.plan"]["count"] == 2
    assert {got[p]["parent"] for p in TUNE_PARTS} == {"spx.tune"}


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def test_no_profiler_range_when_none_records():
    with timing.span("spx.t.quiet") as s:
        assert not s._range
    from torch.profiler import ProfilerActivity, profile
    with timing.span("spx.t.before"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(2).add_(1)
    names = {e.name for e in prof.events()}
    assert not {n for n in names if n.startswith("spx.")}


def test_spans_nest_in_the_callers_profiler_range(tmp_path):
    A = tune_graph(1 << 10, 4)
    x = torch.ones(A.ncols, dtype=torch.float64)
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("port.matvec_kernel"):
            spt.matvec_kernel(0.5, A, x, 1.0, torch.zeros(A.nrows,
                                                          dtype=x.dtype))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in ("user_annotation",
                                                   "cpu_op"):
            ranges[e["name"]] = (e["ts"], e["ts"] + e["dur"])

    def inside(a, b):
        return ranges[b][0] <= ranges[a][0] and ranges[a][1] <= ranges[b][1]

    assert inside("spx.api.matvec_kernel", "port.matvec_kernel")
    assert inside("spx.exec.call", "spx.api.matvec_kernel")
    assert inside("spx.exec.epilogue", "spx.exec.call")


# ---------------------------------------------------------------------------
# the names
# ---------------------------------------------------------------------------

def span_literals():
    """Every name given to ``span(...)`` or a timer's ``span=`` in the
    port's source."""
    names = []
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT,
                                                      "sparsex_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                args = list(node.args[:1]) if getattr(
                    node.func, "id", getattr(node.func, "attr", "")) == \
                    "span" else []
                args += [k.value for k in node.keywords if k.arg == "span"]
                names += [a.value for a in args
                          if isinstance(a, ast.Constant)
                          and isinstance(a.value, str)]
    return names


def test_every_span_name_is_the_ports_own():
    literals = span_literals()
    assert {"spx.tune", "spx.tune.sort", "spx.exec.call",
            "spx.solver.capture"} <= set(literals)
    A = tune_graph(1 << 10, 4)
    spt.matvec_kernel(1.0, A, np.ones(A.ncols), 0.0, None, device="cpu")
    spt.matmat_kernel(1.0, A, np.ones((A.ncols, 2)), 0.0, None,
                      device="cpu")
    solvers.cg(A.csx.matvec, np.ones(A.nrows), device="cpu", maxiter=3)
    names = list(spans()) + literals
    assert all(n.startswith("spx.") for n in names), names
    assert not [n for n in names if n.startswith(("port.", "loop."))]


# ---------------------------------------------------------------------------
# the tune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [tune_graph, tune_hpcg],
                         ids=["graph", "hpcg"])
def test_the_tune_split_covers_preproc(make):
    A = make()
    got = spans()
    preproc = A.csx.timers.get_secs("preproc")
    assert got["spx.tune"]["seconds"] == preproc
    assert all(got[p]["parent"] == "spx.tune" for p in TUNE_PARTS)
    parts = sum(got[p]["seconds"] for p in TUNE_PARTS)
    assert parts <= preproc
    assert parts >= 0.97 * preproc


def test_the_tune_split_is_logged(capsys):
    spt.option_set("spx.log.level", "info")
    tune_graph(1 << 10, 4)
    err = capsys.readouterr()
    line = [ln for ln in (err.out + err.err).splitlines()
            if "tune split:" in ln]
    assert line and all(f"{p} " in line[0]
                        for p in ("sort", "encode", "plan", "upload"))


def rejected(got):
    return sum(d["rejected_seconds"] for n, d in got.items()
               if n.startswith("spx.tune.plan."))


def test_rejected_planner_time_is_counted_once():
    A = tune_graph()
    got = spans()
    assert A.csx.executors[0].variant == "paged"
    # the fused delta plan and the direct scatter plan were rejected; the
    # scatter plan inside the fused one is not counted again
    fd, sp = (got["spx.tune.plan.build_fused_delta"],
              got["spx.tune.plan.build_scatter_plan"])
    assert fd["rejected_seconds"] == fd["seconds"] > 0
    assert sp["count"] == 2
    assert 0 < sp["rejected_seconds"] < sp["seconds"]
    assert rejected(got) <= got["spx.tune.plan"]["seconds"]
    assert got["spx.tune.plan.build_delta_pages"]["rejected_seconds"] == 0


def test_rejection_counts_the_outermost_rejected_planner():
    def make(name, reject, inner=None):
        def fn():
            busy(0.002)
            if inner:
                inner()
            return None if reject else "plan"
        fn.__name__ = name
        return timing.planner(lambda out: out is None)(fn)

    # rejected around rejected: the outer alone
    make("a", True, make("b", True))()
    # accepted around rejected: the inner
    make("c", False, make("d", True))()
    got = spans()
    for name, counted in (("a", True), ("b", False), ("c", False),
                          ("d", True)):
        s = got["spx.tune.plan." + name]
        assert s["rejected_seconds"] == (s["seconds"] if counted else 0)
    assert got["spx.tune.plan.b"]["parent"] == "spx.tune.plan.a"


def test_a_rejected_scatter_plan_is_a_rejected_span():
    dest = np.zeros(4096, dtype=np.int64)      # every element one row
    assert troute.build_scatter_plan(dest, 8, max_folds=1) is None
    got = spans()["spx.tune.plan.build_scatter_plan"]
    assert got["count"] == 1 and got["parent"] is None
    assert got["rejected_seconds"] == got["seconds"] > 0


def test_plan_bytes_count_the_uploaded_tensors():
    A = tune_graph()
    counters = spt.trace_snapshot()["counters"]
    ex = A.csx.executors[0]

    def nbytes(tree):
        if isinstance(tree, torch.Tensor):
            return tree.numel() * tree.element_size()
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(nbytes(v) for v in tree)
        return 0

    assert counters["plan.bytes"] == nbytes(ex.arrays) > 0
    parts = {k: v for k, v in counters.items()
             if k.startswith("plan.bytes.")}
    # the paged delta stream, laid out in row blocks (ops/exec.device_layout)
    assert "plan.bytes.drows" in parts and "plan.bytes.dpages" not in parts
    assert sum(parts.values()) == counters["plan.bytes"]


# ---------------------------------------------------------------------------
# the calls and the solver
# ---------------------------------------------------------------------------

def test_one_exec_call_a_call():
    A = tune_graph(1 << 10, 4)
    x = np.ones(A.ncols)
    for _ in range(3):
        spt.matvec_kernel(0.85, A, x, 1.0, np.zeros(A.nrows), device="cpu")
    spt.matvec_mult(1.0, A, x)
    spt.matmat_mult(1.0, A, np.ones((A.ncols, 3)))
    got = spans()
    assert got["spx.exec.call"]["count"] == 5
    assert got["spx.api.matvec_kernel"]["count"] == 3
    assert got["spx.api.matvec_mult"]["count"] == 1
    assert got["spx.api.matmat_mult"]["count"] == 1
    assert got["spx.exec.epilogue"]["count"] == 5
    assert got["spx.exec.epilogue"]["parent"] == "spx.exec.call"
    # the CPU runs the body eagerly: no graph to capture or replay
    assert "spx.exec.replay" not in got and "spx.exec.capture" not in got


def test_the_solver_records_its_solves():
    A = tune_hpcg(8)
    st = {}
    solvers.cg(lambda v: spt.matvec_mult(1.0, A, v), np.ones(A.nrows),
               device="cpu", stats=st)
    solvers.cg(A.csx.matvec, np.ones(A.nrows), device="cpu")
    got = spans()
    assert got["spx.solver.solve"]["count"] == 2
    assert got["spx.api.matvec_mult"]["parent"] == "spx.solver.solve"
    assert st["capture_s"] == 0 and "spx.solver.capture" not in got


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_the_executor_counts_its_graph_on_the_card():
    dev = card()
    n, rows, cols, vals = chip_smoke.hpcg_matrix(16)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    A = spt.mat_tune(spt.input_load_csr(rowptr, cols, vals, n, n),
                     device=dev)
    x = torch.ones(n, dtype=torch.float64, device=dev)
    for _ in range(4):
        spt.matvec_kernel(0.5, A, x, 1.0, x)
    got, counters = spans(), spt.trace_snapshot()["counters"]
    assert got["spx.exec.capture"]["count"] == 1
    assert got["spx.exec.replay"]["count"] == 4
    assert got["spx.exec.replay"]["parent"] == "spx.exec.call"
    g = A.csx._executor()._graphs[("mv",)]
    from sparsex_tpu_torch.device import graph_node_types
    types = graph_node_types(g.graph)
    assert counters["exec.graph_nodes.mv"] == sum(types.values())
    assert counters["exec.graph_nodes.mv.kernel"] == types["kernel"] >= 1
    assert counters["graph.bytes_max"] >= g.nbytes


@pytest.mark.cuda
def test_the_solver_spans_its_capture_and_first_replay_on_the_card():
    dev = card()
    n, rows, cols, vals = chip_smoke.hpcg_matrix(16)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    A = spt.mat_tune(spt.input_load_csr(rowptr, cols, vals, n, n),
                     device=dev)
    st = {}
    for _ in range(2):
        solvers.cg(lambda v: spt.matvec_mult(1.0, A, v),
                   torch.ones(n, dtype=torch.float64, device=dev), stats=st)
    got = spans()
    assert got["spx.solver.capture"]["count"] == 2
    assert st["capture_s"] > 0
    assert got["spx.solver.instantiate"]["count"] == 2
    assert got["spx.solver.instantiate"]["parent"] == "spx.solver.solve"
    assert got["spx.solver.capture.graph"]["parent"] == "spx.solver.capture"
    assert spt.trace_snapshot()["counters"]["graph.bytes_max"] >= st[
        "graph_bytes"]
