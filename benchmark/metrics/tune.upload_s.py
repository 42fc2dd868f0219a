"""Host planning: the seconds of the port's span ``spx.tune.upload``
(``plan_to_torch``, until the plan's copies to the card are complete) over
the run's process, which tunes once."""


def read(run):
    import sparsex_tpu_torch as spx
    snap = getattr(spx, "trace_snapshot", None)   # a port without spans
    span = snap and snap()["spans"].get("spx.tune.upload")
    return span["seconds"] if span else None
