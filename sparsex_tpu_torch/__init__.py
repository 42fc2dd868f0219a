"""sparsex_tpu_torch — the CSX SpMV of sparsex_tpu on PyTorch and CUDA.

A port of :mod:`sparsex_tpu` (JAX, TPU) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (H100, ``sm_90a``).  The host side — matrix I/O,
substructure mining, encoding and every layout and route planner — is the
port's own copy of the reference's NumPy/C++ code, so both packages plan
the same arrays; ``Config`` and ``SparsexError`` are the port's own.  This
package imports ``torch``, never ``jax`` and nothing of ``sparsex_tpu``.

Ported so far, for one shard in float32 and float64: the fused SpMV main
path (K1 lane-placed product + G1, T1, K2, K3 with the DIA tables,
residual adds), the blocky path (fused horizontal runs and 2-D blocks
through K1's lane-placed run styles, the merged route plan with its
per-instance G1 lane gather, plain run and delta tables) and the non-fused
variants that matrices past 2^21 rows and stencil or banded matrices take
(the plain tables with the standalone DIA kernel; the legacy paged
variant: the page-bucketed delta product, the unit-page gathers of paged
run and block tables), and the SpMM of every one of them
(``matmat_mult`` / ``matmat_kernel``: the k-batched K1, T1, K2, K3 and lane
gather on a fused plan, the SpMV once per column otherwise).  Other
execution classes raise ``NotImplementedError`` naming their ROADMAP.md
queue item.

    import sparsex_tpu_torch as spx
    A = spx.mat_tune(spx.input_load_mmf("matrix.mtx"))       # on cuda:0
    y = spx.matvec_kernel(alpha=1.0, mat=A, x=x, beta=0.0, y=None)
    Y = spx.matmat_kernel(1.0, A, X, 0.0, None)               # X (ncols, k)
"""

from sparsex_tpu_torch.config import Config, option_get, option_set
from sparsex_tpu_torch.errors import ErrorCode, SparsexError
from sparsex_tpu_torch.api import (INDEX_ONE_BASED, INDEX_ZERO_BASED,
                                   OP_REORDER, Input, Matrix,
                                   input_load_csr, input_load_mmf,
                                   mat_tune, matmat_kernel, matmat_mult,
                                   matvec_kernel, matvec_mult)
from sparsex_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = [
    "Config", "option_set", "option_get", "SparsexError", "ErrorCode",
    "OP_REORDER", "INDEX_ZERO_BASED", "INDEX_ONE_BASED",
    "Input", "Matrix", "input_load_csr", "input_load_mmf",
    "mat_tune", "matvec_mult", "matvec_kernel", "matmat_mult",
    "matmat_kernel", "resolve_device",
]
