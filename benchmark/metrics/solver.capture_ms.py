"""Solver: the mean of the solver's ``stats["capture_s"]`` over the
window's solves (the CUDA graph of a block of iterations captured for
each solve)."""


def read(run):
    caps = [r["capture_s"] for r in run.records if "capture_s" in r]
    return sum(caps) / len(caps) * 1e3 if caps else None
