"""CUDA kernels of sparsex_tpu_torch against their plain PyTorch versions.

These tests need an NVIDIA GPU with nvcc (they build ``csrc/*.cu``) and
skip without one.  This file imports no JAX, so it also runs where JAX is
not installed; there, skip the JAX-based ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

K1 (styles lp and rlp{W}), T1, K2 and the lane gather must equal their
plain versions bit for bit; K3 must agree to 1e-6 of the largest value
(both sum in the same order, without FMA).
"""

import numpy as np
import pytest
import torch

from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import route as troute

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
L = 128
TILE3 = L * L


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _pack(low, g1):
    return ((low.astype(np.int32) & 0x3FFF)
            | ((g1.astype(np.int32) + 1) << 16))


@pytest.mark.parametrize("q8", [1, 4, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k1_cuda_matches_plain(dev, q8, dtype):
    rng = np.random.default_rng(q8)
    T, npages = 40, 128
    # low reaches past the window on purpose: those pages read as 0
    mg = _pack(rng.integers(0, q8 * 8 + 8, (T, 8, L)),
               rng.integers(-1, L, (T, 8, L)))
    plo = rng.integers(0, npages // q8, T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(dtype)
    x2 = rng.standard_normal((npages, 8, L)).astype(dtype)
    args = _on(dev, plo, mg, vals, x2)
    before = tf.launches["k1"]
    got = tf.k1(*args, q8)
    torch.cuda.synchronize()
    assert tf.launches["k1"] == before + 1
    assert torch.equal(got, tf.k1_plain(*args, q8))


@pytest.mark.parametrize("W", [2, 4, 8])
@pytest.mark.parametrize("q8", [1, 4, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k1_rlp_cuda_matches_plain(dev, W, q8, dtype):
    rng = np.random.default_rng(W * 100 + q8)
    T, npages = 40, 128
    mg = _pack(rng.integers(0, q8 * 8 + 8, (T, 8, L)),
               rng.integers(-1, L, (T, 8, L)))
    plo = rng.integers(0, npages // q8, T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(dtype)
    x2 = rng.standard_normal((npages, 8, L)).astype(dtype)
    args = _on(dev, plo, mg, vals, x2)
    before = tf.launches["k1_rlp"]
    got = tf.k1(*args, q8, f"rlp{W}")
    torch.cuda.synchronize()
    assert tf.launches["k1_rlp"] == before + 1
    assert torch.equal(got, tf.k1_plain(*args, q8, f"rlp{W}"))


@pytest.mark.parametrize("K,R", [(1, 4736), (3, 200)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lane_gather_cuda_matches_plain(dev, K, R, dtype):
    rng = np.random.default_rng(K)
    x = rng.standard_normal((R, L)).astype(dtype)
    idx = rng.integers(-1, L, (K, R, L)).astype(np.int8)
    xt, it = _on(dev, x, idx)
    before = tf.launches["lane_gather"]
    got = troute.lane_gather(xt, it)
    torch.cuda.synchronize()
    assert tf.launches["lane_gather"] == before + 1
    assert torch.equal(got, troute.lane_gather_plain(xt, it))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_t1_cuda_matches_plain(dev, dtype):
    a1 = np.random.default_rng(3).standard_normal((46 * L, L)).astype(dtype)
    (t,) = _on(dev, a1)
    got = tf.t1(t, 46)
    torch.cuda.synchronize()
    assert torch.equal(got, tf.t1_plain(t, 46))


@pytest.mark.parametrize("A2R,W2,D2R,masked", [
    (46, 128, 64, False),      # the headline instance
    (13, 16, 5, True),
    (128, 64, 128, False),     # C1 over 48 KB of shared memory
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k2_cuda_matches_plain(dev, A2R, W2, D2R, masked, dtype):
    rng = np.random.default_rng(A2R)
    lo = -1 if masked else 0
    a1t = rng.standard_normal((A2R, L, L)).astype(dtype)
    g2a = rng.integers(lo, L, (L, A2R, L)).astype(np.int8)
    g2b = rng.integers(lo, L, (L, W2, L)).astype(np.int8)
    g2c = rng.integers(lo, L, (L, D2R, L)).astype(np.int8)
    args = _on(dev, a1t, g2a, g2b, g2c)
    got = tf.k2(*args, W2, D2R)
    torch.cuda.synchronize()
    assert torch.equal(got, tf.k2_plain(*args, W2, D2R))


@pytest.mark.parametrize("n_inst,um3,dia,anti", [
    (1, True, (-13, -1, 0, 1, 8), ()),
    (2, False, (-20000, 300, 16390), (5, 40000)),
    (8, True, (), (0,)),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k3_cuda_matches_plain(dev, n_inst, um3, dia, anti, dtype):
    rng = np.random.default_rng(n_inst)
    D2R, ncols, K = 3, 40000, 2
    e1s = [rng.standard_normal((L, D2R, L)).astype(dtype)
           for _ in range(n_inst)]
    g3s = [rng.integers(0 if um3 else -1, L, (D2R, K, L, L)).astype(np.int8)
           for _ in range(n_inst)]
    dv = rng.standard_normal((D2R, len(dia), L, L)).astype(dtype)
    adv = rng.standard_normal((D2R, len(anti), L, L)).astype(dtype)
    x = rng.standard_normal(ncols).astype(dtype)
    xt = _on(dev, x)[0]
    xb = tf._to_blocks(xt)[0]
    xrb = tf._to_blocks(torch.flip(xt, (0,)))[0]
    args = (_on(dev, *e1s), _on(dev, *g3s), _on(dev, dv)[0], dia,
            _on(dev, adv)[0], anti, xb, xrb, ncols, D2R)
    got = tf.k3(*args)
    torch.cuda.synchronize()
    want = tf.k3_plain(*args)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def _api_cuda_vs_cpu(build, n, dtype, kernels):
    """Tune ``build(n)`` on the card and on the CPU, run one SpMV on each and
    check that every kernel in ``kernels`` launched on the card."""
    import sparsex_tpu_torch as spt
    from sparsex_tpu.config import Config

    rows, cols, vals = build(n)
    cfg = Config.reset()
    cfg.set("spx.tpu.value_dtype", dtype)
    cfg.set("spx.preproc.xform", "all")
    cfg.set("spx.preproc.sampling", "portion")
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    inp = spt.input_load_csr(rowptr, cols, vals, n, n)
    A = spt.mat_tune(inp)
    B = spt.mat_tune(inp, device="cpu")
    x = np.random.default_rng(0).standard_normal(n).astype(dtype)
    before = tf.launch_counts()
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    torch.cuda.synchronize()
    after = tf.launch_counts()
    assert all(after[k] > before[k] for k in kernels), (before, after)
    want = spt.matvec_kernel(1.0, B, x, 0.0, None)
    assert ((y.cpu() - want).abs().max()
            <= 1e-6 * want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_matches_cpu(dev, dtype):
    """The headline slice on the card against the same slice on the CPU."""
    import bench
    _api_cuda_vs_cpu(bench.build_matrix, 1 << 17, dtype,
                     ("k1", "t1", "k2", "k3"))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_api_cuda_blocky_matches_cpu(dev, dtype):
    """The blocky slice (fused runs, merged plan) on the card against the
    same slice on the CPU."""
    import bench
    _api_cuda_vs_cpu(bench.build_blocky_matrix, 1 << 18, dtype, tf.KERNELS)
