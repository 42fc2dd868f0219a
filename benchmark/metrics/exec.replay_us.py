"""API and executor graphs: the host microseconds of one replay of the
executor's CUDA graph (the port's span ``spx.exec.replay``, around
``graph.replay()``; the first instantiates the graph), over every replay
of the run's process.  The CPU runs no graph."""


def read(run):
    import sparsex_tpu_torch as spx
    snap = getattr(spx, "trace_snapshot", None)   # a port without spans
    span = snap and snap()["spans"].get("spx.exec.replay")
    return span["seconds"] / span["count"] * 1e6 if span else None
