"""sparsex_tpu_torch — the CSX SpMV of sparsex_tpu on PyTorch and CUDA.

A port of :mod:`sparsex_tpu` (JAX, TPU) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (H100, ``sm_90a``).  The host side — matrix I/O,
substructure mining, encoding and every layout and route planner — is the
port's own copy of the reference's NumPy/C++ code, so both packages plan
the same arrays; ``Config`` and ``SparsexError`` are the port's own.  This
package imports ``torch``, never ``jax`` and nothing of ``sparsex_tpu``.

Ported: the SpMV and SpMM of every plan the reference's planners make on
one device, in float32, float64 and bf16 (computed in f32): the fused
main path (K1 in every style, T1, K2, K3 with the DIA tables, the merged
route plan with its lane gathers), the legacy paged and plain-table
variants, the routed scatters, symmetric matrices (the full mirror and the
per-shard plan), several shards on one device (``spx.rt.nr_threads``, one
CUDA graph a call for all of them), entries (``mat_get_entry`` /
``mat_set_entry``), archives in the reference's format (``mat_save`` /
``mat_restore``), partitions, the CSR kernel cache and the ``spx_vec_*``
ops (``vec``), SpGEMM (``spgemm``, ``ops/spgemm.py``), the solvers
(``solvers.cg`` / ``block_cg``, a block of iterations a CUDA graph on the
card) and the host oracle (``ops/oracle.py``), and several devices
(``parallel.shard.ShardedCsx``: a torch.distributed process group of a
rank per shard, x replicated or passed round a halo ring, a symmetric
matrix's partials reduce-scattered, y gathered on every rank;
``parallel.comm.run_ranks`` starts the ranks).  The port records its own
spans and counters (``timing``: ``trace_snapshot()``, ``trace_reset()``;
README.md, "Tracing").

    import sparsex_tpu_torch as spx
    A = spx.mat_tune(spx.input_load_mmf("matrix.mtx"))       # on cuda:0
    y = spx.matvec_kernel(alpha=1.0, mat=A, x=x, beta=0.0, y=None)
    Y = spx.matmat_kernel(1.0, A, X, 0.0, None)               # X (ncols, k)
    x, iters, res = spx.solvers.cg(A.csx.matvec, b)           # s.p.d. A
    # each rank of a group of N ranks, A tuned in N shards on the host:
    from sparsex_tpu_torch.parallel.shard import ShardedCsx
    y = ShardedCsx(A.csx).matvec(x)         # the whole y on every rank
"""

from sparsex_tpu_torch.config import (Config, option_get, option_set,
                                      options_set_from_env)
from sparsex_tpu_torch.errors import ErrorCode, SparsexError, set_error_handler
from sparsex_tpu_torch import timing
from sparsex_tpu_torch.timing import trace_reset, trace_snapshot
from sparsex_tpu_torch.api import (INDEX_ONE_BASED, INDEX_ZERO_BASED,
                                   OP_REORDER, Input, Matrix, Partition,
                                   finalize, init, input_destroy,
                                   input_load_csr, input_load_mmf,
                                   mat_destroy, mat_get_entry,
                                   mat_get_partition, mat_restore, mat_save,
                                   mat_set_entry, mat_tune, matmat_kernel,
                                   matmat_mult, matvec_kernel,
                                   matvec_kernel_csr,
                                   matvec_kernel_csr_invalidate, matvec_mult,
                                   partition_csr, spgemm)
from sparsex_tpu_torch.ops import vector as vec
from sparsex_tpu_torch import api, config, solvers
from sparsex_tpu_torch.device import resolve_device

__version__ = "0.1.0"

# the reference's __all__ (sparsex_tpu/__init__.py:52-66) and the port's
# device helper
__all__ = [
    "Config", "option_set", "option_get", "options_set_from_env",
    "SparsexError", "ErrorCode", "set_error_handler",
    "timing", "trace_snapshot", "trace_reset", "vec",
    "OP_REORDER", "INDEX_ZERO_BASED", "INDEX_ONE_BASED",
    "init", "finalize",
    "input_load_csr", "input_load_mmf", "input_destroy",
    "mat_tune", "mat_get_entry", "mat_set_entry", "mat_save", "mat_restore",
    "mat_get_partition", "mat_destroy",
    "matvec_mult", "matvec_kernel", "matvec_kernel_csr",
    "matvec_kernel_csr_invalidate", "matmat_mult", "matmat_kernel",
    "spgemm",
    "partition_csr",
    "Matrix", "Input", "Partition",
    "resolve_device",
]
