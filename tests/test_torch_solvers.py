"""The port's solvers (``sparsex_tpu_torch.solvers``) against the JAX
package's on the CPU.

The counterparts of ``tests/test_solvers.py:31-82`` and
``tests/test_spmm.py:142-163``: the same seeded COO tuned by both packages
under the same options, the same right-hand sides, and each port solve
held to the reference's ``cg`` / ``block_cg`` (its ``lax.while_loop``):
the same iteration count and x within 1e-10 of the largest value
(float64).  The 4-shard case runs the shards on one device
(``ShardsExecutor``) against the reference's 4-device mesh
(``ShardedCsx``).  The port runs its loop in blocks of
``solvers.BLOCK`` iterations with the updates masked past the stop
point; the cases that stop mid-block, at ``maxiter``, from an ``x0``, and
a block CG whose columns converge on different iterations show that the
blocks change nothing.  The same block function is what the card replays
from a CUDA graph (``tests/test_torch_cuda.py``, ``-k solver``).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from sparsex_tpu.config import Config as RefConfig
from sparsex_tpu.csx import CsxMatrix as RefCsxMatrix
from sparsex_tpu.parallel.shard import ShardedCsx
from sparsex_tpu.solvers import block_cg as ref_block_cg
from sparsex_tpu.solvers import cg as ref_cg
from sparsex_tpu.symmetric import build_symmetric_csx as ref_build_sym

import sparsex_tpu_torch as spt
from sparsex_tpu_torch import solvers
from sparsex_tpu_torch.csx import CsxMatrix
from sparsex_tpu_torch.symmetric import build_symmetric_csx
from test_solvers import spd_coo

torch.set_num_threads(1)
TOL = 1e-10


@pytest.fixture(autouse=True)
def fresh_port_config():
    spt.Config.reset()
    yield
    spt.Config.reset()


def _options(**options):
    for cfg in (spt.Config.instance(), RefConfig.instance()):
        for key, value in options.items():
            cfg.set(key, str(value))


def _both(n, rows, cols, vals, symmetric=False, **options):
    """The port's matrix on the CPU and the reference's, from one COO."""
    _options(**{"spx.preproc.xform": "all", **options})
    if symmetric:
        return (build_symmetric_csx(n, n, rows, cols, vals, device="cpu"),
                ref_build_sym(n, n, rows, cols, vals))
    return (CsxMatrix.from_coo(n, n, rows, cols, vals, device="cpu"),
            RefCsxMatrix.from_coo(n, n, rows, cols, vals))


def _close(got, want, tol=TOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _same_solve(port, ref, b):
    """(x, it, res) of the port and the reference: equal counts, x within
    TOL, and the residual norms within 1e-6 of theirs (plus 1e-12 of
    ||b||: a converged residual is rounding noise)."""
    assert port[1] == int(ref[1])
    _close(port[0], ref[0])
    got, want = port[2].numpy(), np.asarray(ref[2])
    assert got.shape == want.shape
    assert (np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
            + 1e-12 * np.linalg.norm(b))


def _tridiag(n):
    """tests/test_spmm.py:147-152: 4 on the diagonal, -1 beside it."""
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([np.full(n, 4.0), np.full(n - 1, -1.0),
                           np.full(n - 1, -1.0)])
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def _dense(n, rows, cols, vals):
    A = np.zeros((n, n))
    A[rows, cols] = vals
    return A


def test_cg_on_general_csx():
    """tests/test_solvers.py:31."""
    n = 80
    rows, cols, vals = spd_coo(n)
    A, R = _both(n, rows, cols, vals, **{"spx.preproc.sampling": "none"})
    b = np.random.default_rng(1).standard_normal(n)
    port = solvers.cg(A.mult, b, tol=1e-10, maxiter=500, device="cpu")
    _same_solve(port, ref_cg(R.mult, b, tol=1e-10, maxiter=500), b)
    want = np.linalg.solve(_dense(n, rows, cols, vals), b)
    np.testing.assert_allclose(port[0].numpy(), want, rtol=1e-6, atol=1e-8)
    assert port[1] < 500 and port[0].dtype == torch.float64


@pytest.mark.parametrize("mode", ["off", "on"])
def test_cg_on_symmetric_csx(mode):
    """tests/test_solvers.py:47, in two shards, per shard and as the full
    mirror."""
    n = 64
    rows, cols, vals = spd_coo(n, seed=2)
    A, R = _both(n, rows, cols, vals, symmetric=True,
                 **{"spx.preproc.sampling": "none", "spx.rt.nr_threads": 2,
                    "spx.tpu.sym_full": mode})
    b = np.random.default_rng(3).standard_normal(n)
    port = solvers.cg(lambda v: A.matvec(v), b, tol=1e-10, maxiter=500,
                      device="cpu")
    assert len(A.shards) == 2
    _same_solve(port, ref_cg(lambda v: R.matvec(v), b, tol=1e-10,
                             maxiter=500), b)
    want = np.linalg.solve(_dense(n, rows, cols, vals), b)
    np.testing.assert_allclose(port[0].numpy(), want, rtol=1e-6, atol=1e-8)


def test_cg_on_sharded():
    """tests/test_solvers.py:63: four shards, here on one device (the
    port's ``ShardsExecutor``) against the reference's 4-device mesh."""
    n = 128
    rows, cols, vals = spd_coo(n, seed=4)
    A, R = _both(n, rows, cols, vals, **{"spx.preproc.sampling": "none",
                                         "spx.rt.nr_threads": 4})
    assert type(A._executor()).__name__ == "ShardsExecutor"
    sh = ShardedCsx(R, mesh=Mesh(np.array(jax.devices()[:4]), ("shards",)))
    b = np.random.default_rng(5).standard_normal(n)
    port = solvers.cg(lambda v: A.matvec(v), b, tol=1e-10, maxiter=500,
                      device="cpu")
    _same_solve(port, ref_cg(lambda v: sh.matvec(v), b, tol=1e-10,
                             maxiter=500), b)
    want = np.linalg.solve(_dense(n, rows, cols, vals), b)
    np.testing.assert_allclose(port[0].numpy(), want, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("tol,maxiter", [(1e-10, 1000), (1e-4, 1000),
                                         (0.0, 21), (1e-10, 16)])
def test_cg_stops_where_the_unblocked_loop_stops(tol, maxiter):
    """Converged mid-block (neither count a multiple of ``BLOCK``), and
    stopped at ``maxiter`` (21: mid-block; 16: on a block's end): the
    count, x and residual of the reference's unblocked loop, and no NaN
    from the masked iterations after it."""
    n = 400
    rows, cols, vals = _tridiag(n)
    A, R = _both(n, rows, cols, vals)
    b = np.random.default_rng(7).standard_normal(n)
    st = {}
    port = solvers.cg(A.matvec, b, tol=tol, maxiter=maxiter, device="cpu",
                      stats=st)
    _same_solve(port, ref_cg(R.matvec, b, tol=tol, maxiter=maxiter), b)
    assert st["blocks"] == -(-port[1] // solvers.BLOCK) or (
        port[1] % solvers.BLOCK == 0 and st["blocks"] == port[1]
        // solvers.BLOCK)
    assert st["graph"] is None and st["capture_s"] == 0.0
    assert torch.isfinite(port[0]).all()
    if maxiter < 100:
        assert port[1] == maxiter
    else:
        assert port[1] % solvers.BLOCK != 0 and port[1] < maxiter


def test_cg_from_x0():
    """An initial guess: the reference's count and x from the same x0; a
    numpy x0 is copied, not written."""
    n = 400
    rows, cols, vals = _tridiag(n)
    A, R = _both(n, rows, cols, vals)
    rng = np.random.default_rng(8)
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    keep = x0.copy()
    port = solvers.cg(A.matvec, b, x0, tol=1e-10, device="cpu")
    _same_solve(port, ref_cg(R.matvec, b, x0, tol=1e-10), b)
    assert np.array_equal(x0, keep)
    x0t = torch.from_numpy(x0)
    again = solvers.cg(A.matvec, torch.from_numpy(b), x0t, tol=1e-10)
    assert torch.equal(again[0], port[0]) and again[1] == port[1]
    assert torch.equal(x0t, torch.from_numpy(keep))


def test_cg_keeps_b_dtype_and_device():
    """A float32 matrix and a float64 b: the vectors stay float64 (the
    products widened, as JAX promotes them); a float32 b stays float32; a
    tensor b asked for another device is refused."""
    n = 400
    rows, cols, vals = _tridiag(n)
    A, _R = _both(n, rows, cols, vals, **{"spx.tpu.value_dtype": "float32"})
    b = np.random.default_rng(9).standard_normal(n)
    x64, it64, _ = solvers.cg(A.matvec, b, tol=1e-6, device="cpu")
    x32, it32, r32 = solvers.cg(A.matvec, b.astype(np.float32), tol=1e-5,
                                device="cpu")
    assert x64.dtype == torch.float64 and x32.dtype == torch.float32
    assert r32.dtype == torch.float32
    dense = _dense(n, rows, cols, vals)
    assert np.abs(dense @ x64.numpy() - b).max() < 1e-5 * np.abs(b).max()
    with pytest.raises((ValueError, spt.SparsexError)):
        solvers.cg(A.matvec, torch.from_numpy(b), device="cuda:0")


def test_block_cg():
    """tests/test_spmm.py:142: against the reference's block_cg, the dense
    residual, and per-column cg."""
    n = 400
    rows, cols, vals = _tridiag(n)
    A, R = _both(n, rows, cols, vals)
    B = np.random.default_rng(7).standard_normal((n, 4))
    port = solvers.block_cg(lambda P: A.matmat(P), B, tol=1e-10,
                            device="cpu")
    _same_solve(port, ref_block_cg(lambda P: R.matmat(P), B, tol=1e-10), B)
    X = port[0].numpy()
    assert np.abs(_dense(n, rows, cols, vals) @ X - B).max() < 1e-6
    for j in range(4):
        xj, itj, _ = solvers.cg(lambda v: A.matvec(v), B[:, j], tol=1e-10,
                                device="cpu")
        _close(port[0][:, j], xj.numpy(), 1e-8)
        assert itj <= port[1]


def test_block_cg_columns_converge_apart():
    """Columns made of 1, 3, 5 and 7 of the matrix's eigenvectors (spread
    over its spectrum) converge after 1, 3, 5 and 7 iterations in exact
    arithmetic: each stops on its own iteration, then stays put (alpha = 0) while the others go on.
    Each column equals its own cg's solve and the reference's block_cg."""
    n = 200
    rows, cols, vals = _tridiag(n)
    A, R = _both(n, rows, cols, vals)
    i = np.arange(1, n + 1)
    modes = np.stack([np.sin(m * np.pi * i / (n + 1))
                      for m in (1, 100, 199, 50, 150, 25, 175)], axis=1)
    B = np.stack([modes[:, :c].sum(1) for c in (1, 3, 5, 7)], axis=1)
    port = solvers.block_cg(A.matmat, B, tol=1e-10, device="cpu")
    _same_solve(port, ref_block_cg(R.matmat, B, tol=1e-10), B)
    counts = []
    for j in range(B.shape[1]):
        xj, itj, _ = solvers.cg(A.matvec, B[:, j], tol=1e-10, device="cpu")
        _close(port[0][:, j], xj.numpy(), 1e-8)
        counts.append(itj)
    assert len(set(counts)) == len(counts) and port[1] == max(counts)


def test_block_cg_stops_at_maxiter_mid_block():
    n = 400
    rows, cols, vals = _tridiag(n)
    A, R = _both(n, rows, cols, vals)
    B = np.random.default_rng(10).standard_normal((n, 3))
    port = solvers.block_cg(A.matmat, B, tol=0.0, maxiter=19, device="cpu")
    _same_solve(port, ref_block_cg(R.matmat, B, tol=0.0, maxiter=19), B)
    assert port[1] == 19
