"""API and executor graphs: the mean host time of a ``matvec_kernel``
call in the window, from the call until it returns, with no synchronise:
what the host pays to enqueue one product."""


def read(run):
    recs = [r for r in run.records if "enqueue_s" in r]
    calls = sum(r["products"] for r in recs)   # a call a product
    return sum(r["enqueue_s"] for r in recs) / calls * 1e6 if calls else None
