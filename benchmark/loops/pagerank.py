"""Back-to-back PageRanks as GAP's ``pr`` kernel runs them.

Scores start at 1/n.  Each iteration fills y with (1 - d)/n, calls
``matvec_kernel(d, A, x, 1.0, y)`` and reads the L1 change on the host;
a PageRank stops when the change is under ``tol`` or after ``max_iters``
products, and one that ends on ``max_iters`` is counted failed.

The check compares, for ``check_ranks`` PageRanks drawn from the seed
among the first ``sample_from_first``, every product the port returned
(on the x it was given) and the scores at the stop with the float64
reference, and the number of products with the reference's.
"""

from __future__ import annotations

import time

import torch

from benchmark.reference import plain


class Loop:
    def __init__(self, run):
        from sparsex_tpu_torch import api
        self.api = api
        self.run = run
        mix = run.mix
        self.d, self.tol = float(mix["damping"]), float(mix["tol"])
        self.max_iters = int(mix["max_iters"])
        n = run.mat.nrows
        self.base = (1.0 - self.d) / n
        self.x0 = torch.full((n,), 1.0 / n, dtype=run.dtype,
                             device=run.device)
        self.y = torch.empty_like(self.x0)
        self.x0_host = self.x0.cpu()
        self.sampled = set(run.rng(1).choice(
            int(mix["sample_from_first"]), int(mix["check_ranks"]),
            replace=False).tolist())
        self.saved = {}           # sampled PageRank -> its products' y

    def solve(self, i: int) -> dict:
        run, api = self.run, self.api
        keep = [] if i in self.sampled else None
        enqueue = 0.0
        x = self.x0
        with run.annotate("loop.solve"):
            t0 = time.perf_counter()
            for it in range(1, self.max_iters + 1):
                with run.annotate("loop.fill"):
                    self.y.fill_(self.base)
                te = time.perf_counter()
                with run.annotate("port.matvec_kernel"):
                    y = api.matvec_kernel(self.d, run.mat, x, 1.0, self.y)
                enqueue += time.perf_counter() - te
                with run.annotate("loop.l1_change"):
                    err = float((y - x).abs().sum())
                if keep is not None:
                    keep.append(y.cpu())
                x = y
                if err < self.tol:
                    break
            t1 = time.perf_counter()
        if keep is not None:
            self.saved[i] = keep
        return {"t0": t0, "t1": t1, "products": it, "ok": err < self.tol,
                "enqueue_s": enqueue}

    def release(self):
        self.x0 = self.y = None

    def check(self) -> dict:
        """The largest gaps over the sampled PageRanks the window ran."""
        run = self.run
        if not self.saved:
            return {}
        n, rowptr, colind, values = run.csr
        A = plain.Csr(n, rowptr, colind, values, device=run.device)
        ref, ref_it = plain.pagerank(A, self.d, self.tol, self.max_iters)
        ref = ref.cpu().numpy()
        prod = rank = gap = 0.0
        for ys in self.saved.values():
            # the x the port was given, and the y it returned
            for x, y in zip([self.x0_host] + ys[:-1], ys):
                want = self.base + self.d * A.mv(x.double())
                prod = max(prod, plain.mixed_rel_err(
                    y.double().numpy(), want.cpu().numpy()))
            rank = max(rank, plain.mixed_rel_err(ys[-1].double().numpy(),
                                                 ref))
            gap = max(gap, abs(len(ys) - ref_it))
        lim = run.limits
        return {"product_err": {"value": prod, "limit": lim["product_err"]},
                "rank_err": {"value": rank, "limit": lim["rank_err"]},
                "iter_gap": {"value": gap, "limit": lim["iter_gap"]}}
