"""The dense-tile K1 styles of sparsex_tpu_torch on the CPU.

K1's styles ``sl`` and ``run{W}`` (``fused.py:_build_k1``, :1008-1041) are
the planners' fallbacks where lane placement does not apply: the delta
singles when the hybrid lane placement fails its fill gate (``sl``),
horizontal runs wider than 8 lanes or strided (``run{W}``).  Through the
port's plain version:

- ``k1_plain`` in ``sl`` and ``run{2,16,128}`` at q in {1, 3, 16} against
  the Pallas kernel in interpret mode, bit for bit;
- the ``sl`` delta path (``chip_smoke.lane_skew_matrix``), the ``run16``
  fused-run table in a merged plan and the ``run128`` one on its own route
  instances (``chip_smoke.wide_run_matrix``) end to end through
  ``mat_tune(..., device="cpu")``, against the reference executor
  (interpret mode, float32) within 1e-5 of the largest value and a
  float64 COO oracle within ``chip_smoke.CHECK_TOL`` (float32) and 1e-6
  (float64) mixed relative error;
- ``chip_smoke.py``'s fused kernel phase calls each kernel with the inputs
  the port's SpMV gives it on those plans, and the launch counts it derives
  from the plan are the SpMV's calls;
- the upload's dense-window check and ``check_slice`` admitting the styles.
"""

import hashlib
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import sparsex_tpu.ops.fused as fused
import sparsex_tpu.ops.pallas_kernels as pk
from sparsex_tpu.config import Config as RefConfig
from sparsex_tpu.csx import CsxMatrix as RefCsxMatrix
from sparsex_tpu.ops import route as route_mod
import sparsex_tpu_torch as spt
from sparsex_tpu_torch.ops import convert
from sparsex_tpu_torch.ops import fused as tf
from sparsex_tpu_torch.ops import route as troute
from sparsex_tpu_torch.ops.kernels import check_slice

torch.set_num_threads(1)
L = 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def fresh_port_config():
    """The port's Config is its own singleton: reset it around every test,
    as tests/conftest.py resets the reference's."""
    spt.Config.reset()
    yield
    spt.Config.reset()


def _route_elems(monkeypatch, value):
    """The route planner's minimum, set alike on both packages so that they
    plan the same arrays (a run table's route carries one element per
    unit, so small matrices need it lowered)."""
    for mod in (route_mod, troute):
        monkeypatch.setattr(mod, "MIN_ELEMS", value)


# ---------------------------------------------------------------------------
# the kernel against the Pallas kernel
# ---------------------------------------------------------------------------

def _dense_inputs(rng, T, q, npages, dtype):
    """A dense-tile K1 stream: windows of q pages inside an npages grid,
    offsets reaching past the window (sublane 8q and up reads 0) unless the
    window is 16 pages, the most 14 bits reach."""
    low = rng.integers(0, min(1 << 14, q * 1024 + 512), (T, 8, L))
    mg = fused.pack_k1_meta(low, rng.integers(-1, L, (T, 8, L)))
    plo = rng.integers(0, npages - q + 1, T).astype(np.int32)
    vals = rng.standard_normal((T, 8, L)).astype(dtype)
    x2 = rng.standard_normal((npages, 8, L)).astype(dtype)
    return plo, mg, vals, x2


@pytest.mark.parametrize("style,q,dtype", [
    (style, q, np.float32) for style in ("sl", "run2", "run16", "run128")
    for q in (1, 3, 16)] + [("sl", 3, np.float64), ("run16", 3, np.float64)])
def test_k1_dense_matches_pallas(style, q, dtype):
    rng = np.random.default_rng(q * 7 + len(style))
    T, npages = 8, 40
    plo, mg, vals, x2 = _dense_inputs(rng, T, q, npages, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused._build_k1(T, q, style, np.dtype(dtype).name)(
            jnp.asarray(plo), jnp.asarray(mg), jnp.asarray(vals),
            jnp.asarray(x2)))
    got = tf.k1(_t(plo), _t(mg), _t(vals), _t(x2), q, style)
    assert got.shape == (T, 8, L) and got.dtype == _t(vals).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.4
    if style != "sl":   # the sliding sum really adds lanes
        sl = tf.k1(_t(plo), _t(mg), _t(vals), _t(x2), q, "sl").numpy()
        assert not np.array_equal(sl, want)


def test_k1_dense_rejects_bad_windows():
    rng = np.random.default_rng(0)
    plo, mg, vals, x2 = _dense_inputs(rng, 8, 3, 16, np.float32)
    args = (_t(plo), _t(mg), _t(vals))
    with pytest.raises(ValueError, match="dense window"):
        tf.k1(*args, _t(x2[:2]), 3, "sl")       # fewer pages than q
    with pytest.raises(ValueError, match="dense window"):
        tf.k1(*args, _t(x2), 17, "run16")       # beyond 14-bit offsets
    assert tf.k1_style("run128") == (True, 128)
    assert tf.k1_key("sl") == "k1_sl" and tf.k1_key("run64") == "k1_run"


# ---------------------------------------------------------------------------
# the paths end to end
# ---------------------------------------------------------------------------

def _tune(n, rows, cols, vals, dtype):
    """The port's matrix on the CPU (``mat_tune``) and the reference
    executor of the same matrix, tuned under the same options."""
    for cfg in (spt.Config.instance(), RefConfig.instance()):
        cfg.set("spx.tpu.value_dtype", dtype)
        cfg.set("spx.preproc.xform", "all")
        cfg.set("spx.preproc.sampling", "portion")
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols,
                                          vals.astype(dtype), n),
                     device="cpu")
    ref = RefCsxMatrix.from_coo(n, n, rows, cols, vals.astype(dtype))
    ref = ref.executors[0]
    ref._maybe_build_pages()
    assert A.csx.executors[0].meta == ref._pages_meta
    return A, ref


def _check_path(A, ref, n, rows, cols, vals, dtype, monkeypatch):
    """matvec_kernel at alpha=1/beta=0 and alpha=2/beta=0.5 against the
    float64 COO oracle; in float32 also against the reference executor in
    interpret mode (it runs its Pallas path in float32 only); no kernel
    launch on the CPU."""
    monkeypatch.setattr(pk, "dia_pallas_ok", lambda: True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n).astype(dtype)
    y0 = rng.standard_normal(n).astype(dtype)
    want = np.bincount(rows, weights=vals.astype(dtype).astype(np.float64)
                       * x.astype(np.float64)[cols], minlength=n)
    before = tf.launch_counts()
    y = spt.matvec_kernel(1.0, A, x, 0.0, None)
    y2 = spt.matvec_kernel(2.0, A, x, 0.5, y0)
    assert tf.launch_counts() == before
    assert y.shape == (n,) and y.dtype == getattr(torch, dtype)
    bar = chip_smoke.CHECK_TOL if dtype == "float32" else 1e-6
    assert chip_smoke._mixed_rel_err(y.numpy(), want) < bar
    assert chip_smoke._mixed_rel_err(y2.numpy(), 2.0 * want + 0.5 * y0) < bar
    if dtype == "float32":
        with pltpu.force_tpu_interpret_mode():
            assert ref._pages_active()
            yr = np.asarray(ref(jnp.asarray(x)), dtype=np.float64)
        scale = np.abs(want).max()
        assert np.abs(y.numpy() - yr).max() / scale < 1e-5


def _extras(meta):
    return {e[0]: e[1:] for e in meta[5:] if e}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sl_delta_path_matches_reference(monkeypatch, dtype):
    """Singles on a coarse column grid fail lane placement: the delta
    pipeline in K1 style sl, on its own route instances."""
    n = 1 << 15
    rows, cols, vals = chip_smoke.lane_skew_matrix(n)
    A, ref = _tune(n, rows, cols, vals, dtype)
    meta = A.csx.executors[0].meta
    assert set(_extras(meta)) == {"dfused"}
    fmeta = _extras(meta)["dfused"][0]
    assert fmeta[6] == "sl" and len(fmeta) == 7 and len(fmeta[3]) >= 2
    _check_path(A, ref, n, rows, cols, vals, dtype, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_run16_merged_path_matches_reference(monkeypatch, dtype):
    """Width-16 runs take the dense-tile style run16 (lane placement takes
    W <= 8 only), merged with the lp delta pipeline into one route plan."""
    _route_elems(monkeypatch, 1024)
    n = 1 << 15
    rows, cols, vals = chip_smoke.wide_run_matrix(n, 16)
    A, ref = _tune(n, rows, cols, vals, dtype)
    meta = A.csx.executors[0].meta
    assert set(_extras(meta)) == {"dfused", "fall"}
    assert [m[5] for _, m in chip_smoke.fused_runs(meta)] == ["run16"]
    assert _extras(meta)["fall"][0] == (("delta",), ("run", 0))
    _check_path(A, ref, n, rows, cols, vals, dtype, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_run128_segment_path_matches_reference(monkeypatch, dtype):
    """Width-128 runs take run128 (seven roll passes) on their own route
    instances, with over-capacity residual units, and nothing else fuses."""
    _route_elems(monkeypatch, 1024)
    n = 1 << 14
    rows, cols, vals = chip_smoke.wide_run_matrix(n, 128)
    A, ref = _tune(n, rows, cols, vals, dtype)
    meta = A.csx.executors[0].meta
    assert _extras(meta) == {}
    (fr,) = [m for _, m in chip_smoke.fused_runs(meta)]
    assert fr[5] == "run128" and fr[4] > 0
    _check_path(A, ref, n, rows, cols, vals, dtype, monkeypatch)


def _sig(v):
    """A call argument as something comparable: tensors by shape, dtype
    and bytes."""
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype),
                hashlib.sha1(v.contiguous().numpy().tobytes()).hexdigest())
    if isinstance(v, (list, tuple)):
        return tuple(_sig(a) for a in v)
    return v


@pytest.mark.parametrize("kind", ["sl", "run16"])
def test_chip_smoke_fused_phase_feeds_the_dense_paths(monkeypatch, kind):
    """chip_smoke's plan check passes on the dense plans, its fused kernel
    phase calls every kernel wrapper with exactly the inputs the port's
    SpMV gives it, and the launch counts it derives from the plan are the
    SpMV's calls, K1 under the key of its style."""
    _route_elems(monkeypatch, 1024)
    n = 1 << 15
    if kind == "sl":
        rows, cols, vals = chip_smoke.lane_skew_matrix(n)
    else:
        rows, cols, vals = chip_smoke.wide_run_matrix(n, 16)
    for key, value in (("spx.tpu.value_dtype", "float64"),
                       ("spx.preproc.xform", "all")):
        spt.Config.instance().set(key, value)
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    calls = []
    for mod, name in ((tf, "k1"), (tf, "t1"), (tf, "k2"), (tf, "k3"),
                      (troute, "lane_gather")):
        def rec(*a, _f=getattr(mod, name), _n=name):
            key = tf.k1_key(a[5]) if _n == "k1" else _n
            calls.append((key, _sig(a)))
            return _f(*a)
        monkeypatch.setattr(mod, name, rec)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    A.csx.executors[0](x)
    path = list(calls)
    calls.clear()
    ex = chip_smoke.check_dense_plan(kind)(SimpleNamespace(csx=A.csx), "cpu")
    res = chip_smoke.kernel_phase(ex, x, "cpu", timed=False)
    assert set(calls) == set(path)
    counted = Counter(name for name, _ in path)
    want = chip_smoke.expected_counts(ex.meta)
    assert {k: v for k, v in want.items() if v} == dict(counted)
    assert set(res) == set(counted)
    assert ("k1_sl" if kind == "sl" else "k1_run") in counted


# ---------------------------------------------------------------------------
# the upload and the admission
# ---------------------------------------------------------------------------

def test_plan_to_torch_checks_the_dense_windows():
    """The CUDA K1 reads x2 unchecked: a dense window (plo counts pages)
    must end inside the max(npages, q)-page grid, and q may not pass 16."""
    n = 1 << 15
    rows, cols, vals = chip_smoke.lane_skew_matrix(n)
    spt.Config.instance().set("spx.tpu.value_dtype", "float32")
    A = spt.mat_tune(chip_smoke.csr_input(spt, rows, cols, vals, n),
                     device="cpu")
    from sparsex_tpu_torch.ops.exec import HostPlan
    plan = HostPlan(A.csx.shards[0])
    plan._maybe_build_pages()
    meta, host = plan._pages_meta, plan._pages_arrays
    fmeta = _extras(meta)["dfused"][0]
    T, q, npages = fmeta[:3]
    assert fmeta[6] == "sl" and int(host["fused"]["plo"].max()) + q <= npages
    convert.plan_to_torch(meta, host, "cpu", torch.float32)
    plo = host["fused"]["plo"]
    host["fused"]["plo"] = plo.copy()
    host["fused"]["plo"][0] = max(npages, q) - q + 1   # one page past
    with pytest.raises(ValueError, match="K1 windows outside"):
        convert.plan_to_torch(meta, host, "cpu", torch.float32)
    host["fused"]["plo"] = plo
    wide = meta[:5] + tuple(
        ("dfused", (T, 17, npages) + fmeta[3:]) if e and e[0] == "dfused"
        else e for e in meta[5:])
    with pytest.raises(ValueError, match="dense K1 window of 17 pages"):
        convert.plan_to_torch(wide, host, "cpu", torch.float32)


def test_check_slice_admits_the_dense_styles():
    df = ("dfused", (8, 3, 32, (), 0, 0, "sl"))
    runs = tuple((1, 1, W, None, None, ("frun", (8, 2, 32, (), 0, f"run{W}"),
                                        0)) for W in (16, 128))
    fall = ("fall", (("delta",), ("run", 0), ("run", 1)), (), (),
            (("dres",), ("rres", 1)))
    check_slice((1 << 14, 1 << 14, runs, (), (), df, fall))
    check_slice((1 << 14, 1 << 14, runs, (), (), df))
