"""nnz-balanced contiguous row partitioning.

The port's own copy of ``sparsex_tpu/parallel/partition.py``,
with its imports pointed at ``sparsex_tpu_torch``: it behaves as the
reference does, so both packages plan alike.

Parity with the reference split (``include/sparsex/internals/
SparseInternal.hpp:117-152``: per part ``limit = (nnz - cnt) / (nr - i)``)
and the public ``spx_partition_csr`` (``src/api/matvec.c:689-737``).  The
reference assigns partitions to threads/NUMA nodes; here a partition is a
device shard on the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class RowPartition:
    """Row ranges per shard: shard i owns rows [row_start[i], row_end[i])."""

    nparts: int
    row_start: List[int]
    row_end: List[int]
    nnz_per_part: List[int] = field(default_factory=list)

    def bounds(self, i: int) -> Tuple[int, int]:
        return self.row_start[i], self.row_end[i]


def split_rows_by_nnz(row_counts: np.ndarray, nparts: int) -> RowPartition:
    """Split rows into ``nparts`` contiguous ranges with balanced nnz.

    Mirrors the reference algorithm: part i gets rows until it holds at
    least ``(nnz_remaining) / (parts_remaining)`` nonzeros.
    """
    row_counts = np.asarray(row_counts, dtype=np.int64)
    nrows = row_counts.size
    nnz = int(row_counts.sum())
    cum = np.concatenate([[0], np.cumsum(row_counts)])

    starts, ends, part_nnz = [], [], []
    row = 0
    cnt = 0
    for i in range(nparts):
        remaining_parts = nparts - i
        limit = (nnz - cnt + remaining_parts - 1) // remaining_parts
        target = cnt + limit
        if i == nparts - 1:
            end = nrows
        else:
            end = int(np.searchsorted(cum, target, side="left"))
            end = max(end, row)
            end = min(end, nrows)
        starts.append(row)
        ends.append(end)
        part_nnz.append(int(cum[end] - cum[row]))
        cnt = int(cum[end])
        row = end
    return RowPartition(nparts=nparts, row_start=starts, row_end=ends,
                        nnz_per_part=part_nnz)


def row_counts_from_coo(rows: np.ndarray, nrows: int) -> np.ndarray:
    counts = np.zeros(nrows, dtype=np.int64)
    np.add.at(counts, np.asarray(rows, dtype=np.int64), 1)
    return counts
