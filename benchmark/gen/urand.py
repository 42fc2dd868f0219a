"""GAP's ``urand`` graph as a PageRank transition matrix, in CSR.

The GAP Benchmark Suite (Beamer, Asanovic, Patterson, arXiv:1508.03619)
builds ``urand`` with ``-u <scale> -k <degree>``: 2^scale vertices and
2^scale * degree edges whose two ends are drawn uniformly at random.  Its
builder symmetrises the graph for an undirected run and squishes it: self
loops and duplicate edges are dropped.  GAP draws with ``std::mt19937``;
here the edges come from a ``torch.Generator`` on the run's device, seeded
by the run's seed: the same distribution from another stream, made on the
card in a few large calls.

The values are the transition matrix that GAP's ``pr`` kernel applies:
P[u, v] = 1 / deg(v) for each edge v -> u, so that P @ scores is the sum of
``outgoing_contrib`` over u's in-neighbours.  Every column of P sums to 1.
"""

from __future__ import annotations

import torch

# whether the matrix depends on the run's seed
SEEDED = True


def generate(params: dict, seed: int, value_type: str, device="cpu"):
    """``(nrows, ncols, rowptr, colind, values)`` of the graph's P as NumPy
    arrays, rows sorted and columns sorted within each row; values in
    ``value_type``.  The same seed on the same kind of device gives the
    same graph."""
    n = 1 << int(params["scale"])
    m = n * int(params["degree"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    ends = torch.randint(0, n, (2, m), generator=gen, device=device)
    src, dst = ends[0], ends[1]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if params.get("symmetrize", True):
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    # row u holds the in-edges v -> u: key = u * n + v, unique and sorted
    key = torch.unique(dst * n + src, sorted=True)
    del ends, src, dst, keep
    rows, cols = key // n, key % n
    deg = torch.bincount(cols, minlength=n)
    values = (1.0 / deg[cols].double()).to(getattr(torch, value_type))
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(rows, minlength=n), 0, out=rowptr[1:])
    return (n, n, rowptr.cpu().numpy(), cols.cpu().numpy(),
            values.cpu().numpy())
