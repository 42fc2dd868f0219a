"""The readers of the port's own spans and counters, on a traced CPU run of
each cell at the control's size (``test_bench_control.SMALL``): every
reader finds its number where the CPU has it and gives none where only the
card has it (graphs, the device trace); the tune's parts cover the port's
``preproc`` timer; and against a port without spans (no
``trace_snapshot``) every reader gives none and raises nothing."""

import pytest

import sparsex_tpu_torch as spx
from benchmark import harness
from test_bench_control import SMALL

NEW = {
    "urand19-pagerank": {
        "on_cpu": ["tune.encode_s", "tune.plan_s", "tune.plan_rejected_s",
                   "tune.upload_s", "plan.mib", "exec.call_us"],
        "card_only": ["graph.mib", "exec.replay_us", "exec.graph_nodes",
                      "exec.idle_pct"]},
    "hpcg256-cg": {
        "on_cpu": ["tune.encode_s", "tune.plan_s", "tune.upload_s",
                   "plan.mib"],
        "card_only": ["graph.mib", "solver.instantiate_ms"]},
}


def traced_small_run(workload):
    """The run's result and the port's registry after it."""
    spx.trace_reset()
    config, mix = SMALL[workload]
    r = harness.run_cell(workload, 2 ** 33 + 7, 0.3, True, device="cpu",
                         config_override=config,
                         mix_override={**mix, "trace_solves": 2})
    return r, spx.trace_snapshot()


@pytest.fixture(scope="module")
def runs():
    return {w: traced_small_run(w) for w in sorted(NEW)}


@pytest.mark.parametrize("workload", sorted(NEW))
def test_each_cell_lists_the_new_readers(workload):
    names = {m["name"] for m in harness.cell_spec(workload)["per_layer"]}
    assert set(NEW[workload]["on_cpu"] + NEW[workload]["card_only"]) \
        <= names


@pytest.mark.parametrize("workload", sorted(NEW))
def test_readers_on_a_traced_cpu_run(runs, workload):
    r = runs[workload][0]
    assert r["correct"], r["checks"]
    got = r["metrics"]
    for name in NEW[workload]["on_cpu"]:
        assert got[name]["value"] >= 0, name
    for name in NEW[workload]["card_only"]:
        assert name not in got, name
    assert got["tune.plan_s"]["value"] > 0
    assert got["plan.mib"]["value"] > 0


@pytest.mark.parametrize("workload", sorted(NEW))
def test_the_tune_parts_cover_preproc(runs, workload):
    result, snap = runs[workload]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    parts = (got["tune.encode_s"] + got["tune.plan_s"]
             + got["tune.upload_s"]
             + snap["spans"]["spx.tune.sort"]["seconds"])
    assert 0.97 * got["tune.preproc_s"] <= parts <= got["tune.preproc_s"]


def test_rejected_plans_and_calls_on_the_graph(runs):
    got = {k: v["value"] for k, v in runs["urand19-pagerank"][0][
        "metrics"].items()}
    assert got["tune.plan_rejected_s"] <= got["tune.plan_s"]
    assert got["exec.call_us"] > 0


@pytest.mark.parametrize("workload", sorted(NEW))
def test_readers_give_none_without_the_ports_spans(runs, workload,
                                                   monkeypatch):
    monkeypatch.delattr(spx, "trace_snapshot")

    class Run:
        trace = {"window_us": 1000.0, "busy_us": 500.0,
                 "idle_gaps": [["spx.exec.call", 1e-4]]}

    for name in NEW[workload]["on_cpu"] + NEW[workload]["card_only"]:
        assert harness.metric_reader(name).read(Run()) is None, name


def test_the_idle_share_under_the_ports_spans():
    class Run:
        trace = {"window_us": 1000.0, "busy_us": 600.0,
                 "idle_gaps": [["spx.exec.call", 1e-4],
                               ["cudaGraphLaunch", 2e-4],
                               ["spx.api.matvec_kernel", 5e-5]]}

    assert harness.metric_reader("exec.idle_pct").read(Run()) \
        == pytest.approx(15.0)
    Run.trace = {}
    assert harness.metric_reader("exec.idle_pct").read(Run()) is None
