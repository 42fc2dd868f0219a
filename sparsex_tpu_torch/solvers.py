"""Iterative solvers built on the port's SpMV and SpMM executors.

Counterpart of ``sparsex_tpu/solvers.py``: ``cg`` and ``block_cg`` with
the reference's recurrences, on any callable that multiplies by the
matrix (a ``CsxMatrix``'s or a ``SymCsxMatrix``'s ``matvec`` /
``matmat``, one of several shards, ``spx.matvec_mult`` in a lambda).

The reference runs the loop as one ``lax.while_loop`` on the device.  Here
the loop body runs in blocks of ``BLOCK`` iterations, and the host reads
the stop flag once a block.  Each iteration masks its own update on the
device: an iteration past the stop point (``rs <= tol² · (b·b)`` or
``it == maxiter``) takes ``alpha = beta = 0``, keeps ``rs`` and does not
count, so ``x``, the iteration count and the residual are those of the
unblocked loop.  On a CUDA device the first residual ``b - A x0`` runs
eagerly (it may plan a written shard again, build the kernels and capture
the executors' own graphs), then one block is captured into a CUDA graph,
once per solve, and replayed until the flag says the solve is done; each
SpMV inside the block launches its kernels straight into that graph
(``CsxExecutor._replayed`` runs its eager body under a caller's capture).
On the CPU, and on the card with ``graph=False``, the same block function
runs eagerly.  A capture that fails raises ``RuntimeError`` naming the
block; nothing falls back to the eager loop.

The vectors keep ``b``'s dtype (a NumPy ``b`` goes to ``device``, by
default ``cuda:0``; a tensor stays where it is): each product is cast to
it.  That is JAX's promotion where an f32 plan meets an f64 ``b`` (the
product widens); where an f64 plan meets an f32 ``b`` the reference's
vectors widen to f64, the port's stay f32.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from sparsex_tpu_torch.device import resolve_device
from sparsex_tpu_torch.timing import count_max, span

# iterations a block runs between two reads of the stop flag on the host
BLOCK = 16


def cg(matvec: Callable, b, x0=None, *, tol: float = 1e-8,
       maxiter: int = 1000, device=None, graph: bool = True,
       stats: Optional[dict] = None) -> Tuple:
    """Conjugate gradients: solve A x = b for s.p.d. A.

    ``matvec(x) -> A @ x``.  Returns (x, iterations, final residual norm)
    as (a tensor on b's device, an int, a 0-d tensor).  ``graph=False``
    runs the blocks eagerly on a CUDA device too; ``stats``, a dict, is
    filled as :func:`_solve` says."""
    return _solve(_CG, matvec, b, x0, tol, maxiter, device, graph, stats)


def block_cg(matmat: Callable, B, X0=None, *, tol: float = 1e-8,
             maxiter: int = 1000, device=None, graph: bool = True,
             stats: Optional[dict] = None) -> Tuple:
    """Block conjugate gradients: solve A X = B for s.p.d. A, B (n, k).

    Each right-hand side runs its own CG recurrence, but every iteration
    issues ONE SpMM (``matmat(P) -> A @ P``), so the k-batched kernels read
    the matrix once for all columns.  Columns that have converged keep
    iterating with alpha = 0 (inert) until all are done, as in the
    reference.  Returns (X, iterations, per-column residual norms)."""
    return _solve(_BLOCK_CG, matmat, B, X0, tol, maxiter, device, graph,
                  stats)


# ---------------------------------------------------------------------------
# the recurrences: one iteration each, every update masked on the device;
# each vector update is one in-place addcmul (read two vectors, write one)
# ---------------------------------------------------------------------------

def _apply(fn, v: torch.Tensor) -> torch.Tensor:
    """``fn(v)`` as a tensor of v's dtype on v's device."""
    return torch.as_tensor(fn(v), dtype=v.dtype, device=v.device)


def _safe(d: torch.Tensor) -> torch.Tensor:
    """``d`` with its zeros replaced by 1 (a masked division's
    denominator: a converged iteration makes no NaN or Inf)."""
    return torch.where(d == 0, 1, d)


class _CG:
    """State: x, r, p, rs = r·r, it, tol2, maxiter, go (the stop flag's
    negation after the last block)."""

    name = "cg"

    @staticmethod
    def start(fn, b, x):
        r = b - _apply(fn, x)
        return {"x": x, "r": r, "p": r.clone(), "rs": torch.dot(r, r),
                "tol2": torch.dot(b, b)}

    @staticmethod
    def going(s):
        return (s["rs"] > s["tol2"]) & (s["it"] < s["maxiter"])

    @staticmethod
    def step(fn, s):
        x, r, p, rs = s["x"], s["r"], s["p"], s["rs"]
        live = _CG.going(s)
        ap = _apply(fn, p)
        alpha = torch.where(live, rs / _safe(torch.dot(p, ap)), 0)
        x.addcmul_(alpha, p)                  # x + alpha p
        r.addcmul_(alpha, ap, value=-1)       # r - alpha A p
        rs_new = torch.dot(r, r)
        beta = torch.where(live, rs_new / _safe(rs), 0)
        torch.addcmul(r, beta, p, out=p)      # r + beta p
        torch.where(live, rs_new, rs, out=rs)
        s["it"].add_(live)


class _BLOCK_CG:
    """State as :class:`_CG`'s, with X, R, P of shape (n, k) and rs, tol2
    of shape (k,)."""

    name = "block_cg"

    @staticmethod
    def start(fn, B, X):
        R = B - _apply(fn, X)
        return {"x": X, "r": R, "p": R.clone(), "rs": (R * R).sum(0),
                "tol2": (B * B).sum(0)}

    @staticmethod
    def going(s):
        return (s["rs"] > s["tol2"]).any() & (s["it"] < s["maxiter"])

    @staticmethod
    def step(fn, s):
        X, R, P, rs = s["x"], s["r"], s["p"], s["rs"]
        go = _BLOCK_CG.going(s)
        live = (rs > s["tol2"]) & go
        AP = _apply(fn, P)
        alpha = torch.where(live, rs / _safe((P * AP).sum(0)), 0)
        X.addcmul_(alpha, P)
        R.addcmul_(alpha, AP, value=-1)
        rs_new = (R * R).sum(0)
        beta = torch.where(live, rs_new / _safe(rs), 0)
        torch.addcmul(R, beta, P, out=P)
        torch.where(go, rs_new, rs, out=rs)
        s["it"].add_(go)


def _block(kind, fn, s) -> None:
    """``BLOCK`` iterations, then the stop flag into ``s["go"]``: the one
    body that runs eagerly and that the CUDA graph captures."""
    for _ in range(BLOCK):
        kind.step(fn, s)
    s["go"].copy_(kind.going(s))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _operand(v, device) -> torch.Tensor:
    """A tensor stays on its device (``device``, when given, must name
    it); anything else goes to ``device`` (default ``cuda:0``)."""
    if isinstance(v, torch.Tensor):
        if device is not None and resolve_device(device) != v.device:
            raise ValueError(f"b is on {v.device}, the solver was asked "
                             f"for {device}")
        return v
    return torch.as_tensor(np.asarray(v), device=resolve_device(device))


def _solve(kind, fn, b, x0, tol, maxiter, device, graph, stats):
    """Run ``kind``'s recurrence to its stop point.  ``stats`` (a dict)
    gets ``iterations``, ``blocks`` (host reads of the flag), ``seconds``
    (the whole solve, synchronised), ``capture_s`` (the seconds of the
    span ``spx.solver.capture``; 0 without a graph),
    ``graph`` (the captured ``torch.cuda.CUDAGraph``, kept for its kernel
    nodes, or None), ``state`` (the tensors the graph reads and writes,
    kept with it: a further replay runs ``BLOCK`` more iterations on them,
    masked past the stop point) and ``graph_bytes`` (its pool at the
    capture)."""
    with span("spx.solver.solve"):
        return _run(kind, fn, b, x0, tol, maxiter, device, graph, stats)


def _run(kind, fn, b, x0, tol, maxiter, device, graph, stats):
    t0 = time.perf_counter()
    b = _operand(b, device)
    if x0 is None:
        x = torch.zeros_like(b)
    else:
        x = torch.as_tensor(np.asarray(x0) if not isinstance(
            x0, torch.Tensor) else x0, dtype=b.dtype,
            device=b.device).clone()
    s = kind.start(fn, b, x)
    # tol squared in b's dtype, as the reference squares it
    s["tol2"] = s["tol2"] * (torch.tensor(tol, dtype=b.dtype) ** 2).item()
    s["it"] = torch.zeros((), dtype=torch.int64, device=b.device)
    s["maxiter"] = torch.full((), int(maxiter), dtype=torch.int64,
                              device=b.device)
    s["go"] = kind.going(s)
    blocks, captured, nbytes, capture_s = 0, None, 0, 0.0
    on_card = b.device.type == "cuda"
    with (torch.cuda.device(b.device) if on_card
          else contextlib.nullcontext()):
        if bool(s["go"]):
            if on_card and graph:
                with span("spx.solver.capture") as sp:
                    captured, nbytes = _capture(kind, fn, s)
                capture_s = sp.seconds
                count_max("graph.bytes_max", nbytes)
                # the first replay instantiates the kept graph
                with span("spx.solver.instantiate"):
                    captured.replay()
                blocks = 1
                run = captured.replay
            else:
                def run():
                    _block(kind, fn, s)
            going = not blocks or bool(s["go"])
            while going:
                run()
                blocks += 1
                going = bool(s["go"])
    it = int(s["it"])
    if stats is not None:
        if on_card:
            torch.cuda.synchronize(b.device)
        stats.update(iterations=it, blocks=blocks, capture_s=capture_s,
                     graph=captured, state=s, graph_bytes=nbytes,
                     seconds=time.perf_counter() - t0)
    return s["x"], it, torch.sqrt(s["rs"])


def _capture(kind, fn, s):
    """``(graph, bytes)``: one block of ``kind`` captured on the static
    state ``s``.  One iteration runs first on scratch copies of the state,
    on the capturing side stream (the torch ops' lazy set-up cannot happen
    under a capture); the solve's own state is not touched by it."""
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with span("spx.solver.capture.warm"), torch.cuda.stream(side):
        kind.step(fn, {k: v.clone() for k, v in s.items()})
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    what = f"{kind.name}'s block of {BLOCK} iterations"
    try:
        # entering the graph context collects garbage and empties the
        # allocator's cache
        with span("spx.solver.capture.graph"), torch.cuda.graph(
                graph, stream=side):
            reserved = torch.cuda.memory_reserved()
            _block(kind, fn, s)
    except Exception as e:
        # free the failed graph now: kept alive by the exception's frames,
        # it would be freed later, maybe in the middle of another capture,
        # which a graph's destruction invalidates
        with contextlib.suppress(RuntimeError):
            graph.reset()
        raise RuntimeError(f"capturing the CUDA graph of {what} failed: "
                           f"{e}") from e
    nbytes = torch.cuda.memory_reserved() - reserved
    current.wait_stream(side)
    return graph, nbytes
