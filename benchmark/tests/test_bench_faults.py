"""A run with the timed path broken underneath comes out not correct:
for each fault a one-chip cell can have, planted in the port's entry
points that the loops call (the exchange between chips does not exist on
one chip)."""

import pytest
import torch

import sparsex_tpu_torch.api as api
import sparsex_tpu_torch.solvers as solvers
from test_bench_control import small_run


def unchanged_step(real):
    # the product hands back its x: the scores never move
    return lambda alpha, A, x, beta, y, **kw: x.clone()


def half_left_out(real):
    def product(*args, **kw):
        y = real(*args, **kw).clone()
        half = y.shape[0] // 2
        y[half:] = y[:half].mean()     # the rest's mean for the left-out rows
        return y
    return product


def answer_altered(real):
    def product(*args, **kw):
        y = real(*args, **kw).clone()
        y[y.shape[0] // 3] *= 2
        return y
    return product


def unchanged_solve(real):
    # the solver's state never leaves x0 = 0
    def cg(matvec, b, *args, **kw):
        x, it, res = real(matvec, b, *args, **kw)
        return torch.zeros_like(x), it, res
    return cg


FAULTS = {
    "urand19-pagerank": [(api, "matvec_kernel", unchanged_step),
                         (api, "matvec_kernel", half_left_out),
                         (api, "matvec_kernel", answer_altered)],
    "hpcg256-cg": [(solvers, "cg", unchanged_solve),
                   (api, "matvec_mult", half_left_out),
                   (api, "matvec_mult", answer_altered)],
}
CASES = [(w, m, name, fault) for w, fs in FAULTS.items()
         for m, name, fault in fs]


@pytest.mark.parametrize("workload,module,name,fault", CASES,
                         ids=[f"{c[0]}-{c[3].__name__}" for c in CASES])
def test_fault_comes_out_not_correct(monkeypatch, workload, module, name,
                                     fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    r = small_run(workload, "cpu")
    assert not r["correct"], r["checks"]
