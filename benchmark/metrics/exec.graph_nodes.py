"""API and executor graphs: the nodes of the executor's SpMV graph (key
``("mv",)``), kernels, copies and fills, counted through the CUDA driver
at its capture (the port's counter ``exec.graph_nodes.mv``).  The CPU runs
no graph."""


def read(run):
    import sparsex_tpu_torch as spx
    snap = getattr(spx, "trace_snapshot", None)   # a port without spans
    return snap and snap()["counters"].get("exec.graph_nodes.mv")
