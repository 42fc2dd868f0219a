"""API and executor graphs: the host microseconds of an executor call
(the port's span ``spx.exec.call``: x checked, copied into the graph,
the replay and the alpha/beta epilogue), without its graph's capture
(``spx.exec.capture``), over every call of the run's process."""


def read(run):
    import sparsex_tpu_torch as spx
    snap = getattr(spx, "trace_snapshot", None)   # a port without spans
    spans = snap()["spans"] if snap else {}
    call = spans.get("spx.exec.call")
    if not call:
        return None
    capture = spans.get("spx.exec.capture", {"seconds": 0.0})["seconds"]
    return (call["seconds"] - capture) / call["count"] * 1e6
