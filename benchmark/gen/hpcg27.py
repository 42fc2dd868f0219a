"""HPCG's problem matrix in CSR: the 27-point stencil of
``GenerateProblem_ref.cpp`` (HPCG 3.1 reference).

Rows in lexicographic order of an nx * ny * nz grid (x fastest); each row
holds its grid point and every neighbour in the 3x3x3 cube that lies inside
the grid, 26.0 on the diagonal and -1.0 elsewhere, columns increasing.  The
matrix is symmetric and strictly diagonally dominant on the boundary, so
s.p.d.  It is the same for every seed: HPCG's matrix has no randomness.
"""

from __future__ import annotations

import torch

# whether the matrix depends on the run's seed
SEEDED = False


def generate(params: dict, seed: int, value_type: str, device="cpu"):
    """``(nrows, ncols, rowptr, colind, values)`` of the stencil matrix as
    NumPy arrays, made on ``device``; ``seed`` is not used."""
    nx, ny, nz = (int(params[k]) for k in ("nx", "ny", "nz"))
    n = nx * ny * nz
    r = torch.arange(n, dtype=torch.int64, device=device)
    i, j, k = r % nx, (r // nx) % ny, r // (nx * ny)
    cols, ok = [], []
    for dk in (-1, 0, 1):          # (dz, dy, dx) order: columns increase
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                ok.append((i + di >= 0) & (i + di < nx) & (j + dj >= 0)
                          & (j + dj < ny) & (k + dk >= 0) & (k + dk < nz))
                cols.append(r + di + nx * (dj + ny * dk))
    ok, cols = torch.stack(ok, 1), torch.stack(cols, 1)
    counts = ok.sum(1)
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=rowptr[1:])
    colind = cols[ok]
    diag = colind == torch.repeat_interleave(r, counts)
    values = torch.where(diag, float(params.get("diagonal", 26.0)),
                         float(params.get("offdiagonal", -1.0)))
    values = values.to(getattr(torch, value_type))
    return (n, n, rowptr.cpu().numpy(), colind.cpu().numpy(),
            values.cpu().numpy())
