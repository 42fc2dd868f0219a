"""Host planning: the seconds of the port's span ``spx.tune.encode`` (each
shard's slice of the sorted COO, its mining and encoding and the tables'
``finalize``) over the run's process, which tunes once."""


def read(run):
    import sparsex_tpu_torch as spx
    snap = getattr(spx, "trace_snapshot", None)   # a port without spans
    span = snap and snap()["spans"].get("spx.tune.encode")
    return span["seconds"] if span else None
