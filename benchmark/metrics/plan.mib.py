"""Host planning: the MiB of the plan's tensors that the tune uploaded to
the card (the port's counter ``plan.bytes``, summed by ``plan_to_torch``
over every plan class)."""


def read(run):
    import sparsex_tpu_torch as spx
    snap = getattr(spx, "trace_snapshot", None)   # a port without spans
    n = snap and snap()["counters"].get("plan.bytes")
    return n / 2 ** 20 if n is not None else None
