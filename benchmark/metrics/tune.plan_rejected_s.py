"""Host planning: the seconds of the port's planner spans
(``spx.tune.plan.<planner>``) whose planner made no plan, each counted
once: a rejected planner inside a rejected planner is left out."""


def read(run):
    import sparsex_tpu_torch as spx
    snap = getattr(spx, "trace_snapshot", None)   # a port without spans
    spans = snap()["spans"] if snap else {}
    if "spx.tune.plan" not in spans:
        return None
    return sum(s["rejected_seconds"] for name, s in spans.items()
               if name.startswith("spx.tune.plan."))
