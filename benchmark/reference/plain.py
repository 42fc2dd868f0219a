"""The plain reference that decides ``correct``.

Plain PyTorch in float64 on the CSR arrays that the generator made, the
same arrays the harness hands the port: no kernel, plan, layout, weight or
table of the port, and nothing imported from it.  It runs on any torch
device; the harness runs it on the card after the window, once the port's
state is freed.

``mixed_rel_err`` is a frozen copy of the port's ``ops/oracle.py``
(``bench.py``'s ``_mixed_rel_err``): relative where the reference is
large, scaled absolute near its zeros.
"""

from __future__ import annotations

import numpy as np
import torch


class Csr:
    """A CSR matrix as the reference holds it: row and column of every
    stored entry and its value, all on ``device``, the value in float64
    unless ``dtype`` says otherwise."""

    def __init__(self, n, rowptr, colind, values, device="cpu",
                 dtype=torch.float64):
        counts = torch.as_tensor(np.diff(np.asarray(rowptr, np.int64)))
        self.n = int(n)
        self.rows = torch.repeat_interleave(
            torch.arange(self.n), counts).to(device)
        self.cols = torch.as_tensor(np.asarray(colind, np.int64),
                                    device=device)
        self.vals = torch.as_tensor(np.asarray(values), device=device,
                                    dtype=dtype)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x, accumulated in float64 (or the values' dtype)."""
        x = x.to(self.vals.device, self.vals.dtype)
        out = torch.zeros(self.n, dtype=self.vals.dtype,
                          device=self.vals.device)
        return out.index_add_(0, self.rows, self.vals * x[self.cols])


def pagerank(A: Csr, damping: float, tol: float, max_iters: int):
    """GAP's ``pr`` recurrence in float64: scores start at 1/n; each
    iteration takes ``(1 - d)/n + d * P @ scores`` and stops once the L1
    change is under ``tol`` or after ``max_iters`` products.  Returns the
    scores and the number of products."""
    n = A.n
    x = torch.full((n,), 1.0 / n, dtype=torch.float64, device=A.vals.device)
    base = (1.0 - damping) / n
    for it in range(1, max_iters + 1):
        y = base + damping * A.mv(x)
        err = float((y - x).abs().sum())
        x = y
        if err < tol:
            break
    return x, it


def cg(A: Csr, b: torch.Tensor, tol: float, maxiter: int):
    """Textbook conjugate gradients in float64 from x0 = 0, stopping when
    r.r <= tol^2 * b.b or after ``maxiter`` iterations.  Returns x and the
    iteration count."""
    b = b.to(A.vals.device, torch.float64)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = float(r @ r)
    stop = tol * tol * float(b @ b)
    it = 0
    while rs > stop and it < maxiter:
        ap = A.mv(p)
        alpha = rs / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = float(r @ r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return x, it


def true_residual(A: Csr, b: torch.Tensor, x: torch.Tensor) -> float:
    """||b - A x|| / ||b|| in float64."""
    b = b.to(A.vals.device, torch.float64)
    return float(torch.linalg.vector_norm(b - A.mv(x))
                 / torch.linalg.vector_norm(b))


def mixed_rel_err(a, b) -> float:
    """max |a-b| / (|b| + 1e-3*max|b|)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if not a.size:
        return 0.0
    scale = 1e-3 * float(np.max(np.abs(b))) + 1e-30
    return float(np.max(np.abs(a - b) / (np.abs(b) + scale)))
