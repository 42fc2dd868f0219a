"""Solver: the mean milliseconds of the first replay of each solve's
captured block (the port's span ``spx.solver.instantiate``, in which the
CUDA graph kept at the capture is instantiated), over the solves of the
run's process.  The CPU runs no graph."""


def read(run):
    import sparsex_tpu_torch as spx
    snap = getattr(spx, "trace_snapshot", None)   # a port without spans
    span = snap and snap()["spans"].get("spx.solver.instantiate")
    return span["seconds"] / span["count"] * 1e3 if span else None
