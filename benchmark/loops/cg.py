"""Back-to-back CG solves of A x = b through the port's solver.

Each solve gets a fresh b, uniform in [0, 1), drawn on the device from the
run's seed and the solve's index, and runs
``solvers.cg(lambda v: api.matvec_mult(1.0, A, v), b, tol, maxiter)`` from
x0 = 0; one that reaches ``maxiter`` is counted failed.  A solve is timed
from its call into the port until the port returns, which is after the
host has read the stop flag and synchronised.

The check takes ``check_solves`` solves drawn from the seed among the
first ``sample_from_first`` (and the last solve, if none of them ran),
and compares each solution's true residual in float64, and its iteration
count with the float64 reference CG's on the same b.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import plain


class Loop:
    def __init__(self, run):
        from sparsex_tpu_torch import api, solvers
        self.api, self.solvers = api, solvers
        self.run = run
        mix = run.mix
        self.tol, self.maxiter = float(mix["tol"]), int(mix["maxiter"])
        self.n = run.mat.nrows
        self.gen = torch.Generator(device=run.device)
        self.sampled = set(run.rng(1).choice(
            int(mix["sample_from_first"]), int(mix["check_solves"]),
            replace=False).tolist())
        self.saved = {}           # solve index -> (x on the host, iterations)
        self.last = None

    def rhs(self, i: int) -> torch.Tensor:
        """Solve i's b, the same whenever it is drawn again."""
        seq = np.random.SeedSequence([self.run.seed, 2, i % (1 << 63)])
        self.gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]))
        return torch.rand(self.n, generator=self.gen, dtype=self.run.dtype,
                          device=self.run.device)

    def solve(self, i: int) -> dict:
        run, api, A = self.run, self.api, self.run.mat
        b = self.rhs(i)
        st = {}
        with run.annotate("loop.solve"):
            t0 = time.perf_counter()
            with run.annotate("port.cg"):
                x, it, _ = self.solvers.cg(
                    lambda v: api.matvec_mult(1.0, A, v), b, tol=self.tol,
                    maxiter=self.maxiter, stats=st)
            t1 = time.perf_counter()
        rec = {"t0": t0, "t1": t1, "products": it, "iterations": it,
               "ok": it < self.maxiter, "capture_s": st["capture_s"]}
        if i in self.sampled:
            self.saved[i] = (x.cpu(), it)
        elif i >= 0:
            self.last = (i, x, it)
        return rec

    def release(self):
        if not self.saved and self.last is not None:
            i, x, it = self.last
            self.saved[i] = (x.cpu(), it)
        self.last = None

    def check(self) -> dict:
        """The largest gaps over the checked solves."""
        run = self.run
        if not self.saved:
            return {}
        n, rowptr, colind, values = run.csr
        A = plain.Csr(n, rowptr, colind, values, device=run.device)
        res = gap = 0.0
        for i, (x, it) in self.saved.items():
            b = self.rhs(i)
            res = max(res, plain.true_residual(A, b, x))
            _, ref_it = plain.cg(A, b, self.tol, self.maxiter)
            gap = max(gap, abs(it - ref_it))
        lim = run.limits
        return {"residual": {"value": res, "limit": lim["residual"]},
                "iter_gap": {"value": gap, "limit": lim["iter_gap"]}}
