"""Device: the share of the traced stretch in which no device operation
runs (one minus the union of the profiler's device intervals)."""

from benchmark import devtrace


def read(run):
    return devtrace.idle_pct(run.trace)
