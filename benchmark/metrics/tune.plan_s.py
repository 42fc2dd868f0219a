"""Host planning: the seconds of the port's span ``spx.tune.plan``
(``HostPlan`` and its paged plan, ``_maybe_build_pages``: every planner,
the rejected ones included) over the run's process, which tunes once."""


def read(run):
    import sparsex_tpu_torch as spx
    snap = getattr(spx, "trace_snapshot", None)   # a port without spans
    span = snap and snap()["spans"].get("spx.tune.plan")
    return span["seconds"] if span else None
