"""Each generator against its published definition, at a small size."""

import numpy as np
import pytest

from benchmark import harness


def dense(n, rowptr, colind, values):
    a = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(rowptr))
    a[rows, colind] = values
    return a


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_urand_is_gap_urand_under_pr(seed):
    cfg = {"scale": 9, "degree": 16, "symmetrize": True}
    gen = harness.load_module("gen", "urand")
    n, ncols, rowptr, colind, values = gen.generate(cfg, seed, "float32")
    assert n == ncols == 512 and values.dtype == np.float32
    rows = np.repeat(np.arange(n), np.diff(rowptr))
    pattern = dense(n, rowptr, colind, np.ones(colind.size))
    assert (pattern == pattern.T).all()          # undirected
    assert not (rows == colind).any()            # no self loops
    assert pattern.max() == 1                    # no duplicate edges
    mean_degree = colind.size / n                # 2 * 16 less collisions
    assert 2 * 16 * 0.95 < mean_degree <= 2 * 16
    for r in range(n):                           # columns sorted in a row
        assert (np.diff(colind[rowptr[r]:rowptr[r + 1]]) > 0).all()
    p = dense(n, rowptr, colind, values.astype(np.float64))
    np.testing.assert_allclose(p.sum(axis=0), 1.0, rtol=1e-6)
    deg = pattern.sum(axis=0)
    np.testing.assert_allclose(p[rows, colind], 1.0 / deg[colind],
                               rtol=1e-6)


def test_urand_repeats_its_seed_and_not_another():
    gen = harness.load_module("gen", "urand")
    cfg = {"scale": 8, "degree": 16}
    a = gen.generate(cfg, 3, "float32")
    b = gen.generate(cfg, 3, "float32")
    c = gen.generate(cfg, 4, "float32")
    assert all(np.array_equal(x, y) for x, y in zip(a[2:], b[2:]))
    assert not np.array_equal(a[3], c[3])


@pytest.mark.parametrize("nx,ny,nz", [(4, 4, 4), (5, 3, 6), (8, 8, 8)])
def test_hpcg27_is_hpcg_generate_problem(nx, ny, nz):
    gen = harness.load_module("gen", "hpcg27")
    cfg = {"nx": nx, "ny": ny, "nz": nz, "diagonal": 26.0,
           "offdiagonal": -1.0}
    n, ncols, rowptr, colind, values = gen.generate(cfg, 0, "float64")
    assert n == ncols == nx * ny * nz
    assert colind.size == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    a = dense(n, rowptr, colind, values)
    assert (a == a.T).all()
    assert (np.diag(a) == 26.0).all()
    # a row sums 26 less one for each neighbour inside the grid
    r = np.arange(n)
    i, j, k = r % nx, (r // nx) % ny, r // (nx * ny)

    def inside(v, m):
        return 1 + (v > 0) + (v < m - 1)
    neighbours = inside(i, nx) * inside(j, ny) * inside(k, nz) - 1
    np.testing.assert_array_equal(a.sum(axis=1), 26.0 - neighbours)
    assert set(np.unique(values)) == {-1.0, 26.0}
    for row in range(n):
        assert (np.diff(colind[rowptr[row]:rowptr[row + 1]]) > 0).all()
    assert np.linalg.eigvalsh(a).min() > 0       # s.p.d.
