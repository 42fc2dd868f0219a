"""API and executor graphs: the MiB of the largest memory pool one CUDA
graph capture took, the executor's or the solver's (the port's counter
``graph.bytes_max``; no graph is captured on the CPU)."""


def read(run):
    import sparsex_tpu_torch as spx
    snap = getattr(spx, "trace_snapshot", None)   # a port without spans
    n = snap and snap()["counters"].get("graph.bytes_max")
    return n / 2 ** 20 if n is not None else None
