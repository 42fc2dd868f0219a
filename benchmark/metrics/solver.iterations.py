"""Solver: the mean of the solver's ``stats["iterations"]`` over the
window's solves."""


def read(run):
    its = [r["iterations"] for r in run.records if "capture_s" in r]
    return sum(its) / len(its) if its else None
