#!/usr/bin/env python3
"""Time sparsex_tpu_torch's CUDA kernels against those of other source trees,
on chip_smoke.py's paths, on one CUDA GPU.

    python3 tools/kernel_ab_torch.py --base DIR [--variant DIR ...]
        [--diagnostic DIR ...] [--kernels k3,k3_kb] [--paths headline,blocky]
        [--dtypes float32] [--alone]

``--kernels`` names kernels as ``csrc/*.cu`` does, without ``_kernel``
(``k1_lp_kb``, ``lane_gather``, ``k3``; a launch-count key such as
``k1_kb`` is taken too).

``--base`` (A) and each ``--variant`` (V; default: this tree) name a
checkout of the repository, for example the parent commit unpacked with
``git archive`` into a directory that .gitignore lists.  Each tree's
``sparsex_tpu_torch/csrc/*.cu`` is built into its own library (one nvcc per
source, every tree's started together); the Python side, planners and
wrappers included, is this tree's, so the trees must share the kernels' C
interface.  A kernel that a tree's library lacks runs there as the
composition it replaced (``EMULATED``: the delta-pages scatter epilogue
``delta_pages_acc``, and its row-blocked form ``delta_rowblock_acc``, as the
tree's delta-pages product and the torch scatter-add after it), both alone
and inside the SpMV; such a tree's
reading of that kernel's name is the composition's.  A ``--diagnostic`` tree is timed like a variant but its
results are not held to the plain versions: a deliberately incomplete
kernel (one that skips its x gather or its stores, say) bounds what that
part costs.  Per path (chip_smoke's matrix, plan check and kernel phase)
and value type, for each V against A in turns A, V, V, A (the mean of each
pair):

- each named kernel's calls of one SpMV, and of one k = 8 SpMM chunk where
  the plan runs the k-batched kernels, fed what the path feeds them,
  replayed alone from one CUDA graph per library (inputs warm in L2),
  with each library's max abs error against the plain version and the
  bound of chip_smoke.py;
- the SpMV and the k = 8 SpMM end to end replayed from a CUDA graph;
- each kernel's device time inside the SpMV / SpMM (torch.profiler).

``--alone`` keeps the first reading only, for a quick pass over several
variants.

A library is swapped in by pointing the kernel loader at it while a graph
is captured; the SpMV and the SpMM launch the named kernels through the
same wrappers as always.  The last line is a JSON object of every reading.
Without a CUDA device it exits non-zero.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# label: (rows, builder, plan check, extra tune options), as
# chip_smoke.main's paths
PATHS = {
    "headline": (cs.N, lambda: cs.build_matrix(cs.N), cs.check_plan, ()),
    "blocky": (cs.N_BLOCKY, lambda: cs.build_blocky_matrix(cs.N_BLOCKY),
               cs.check_blocky_plan, ()),
    "blocky-2^19": (cs.N_BLOCKY_CHECK,
                    lambda: cs.build_blocky_matrix(cs.N_BLOCKY_CHECK),
                    cs.check_masked_blocky_plan, ()),
    "wide-run": (cs.N_DENSE, lambda: cs.wide_run_matrix(cs.N_DENSE, 16),
                 cs.check_dense_plan("run16"), ()),
    "lane-skew": (cs.N_DENSE, lambda: cs.lane_skew_matrix(cs.N_DENSE),
                  cs.check_dense_plan("sl"), ()),
    "fs-run": (cs.N_DENSE, lambda: cs.wide_run_matrix(cs.N_DENSE, 5),
               cs.check_fs_plan("runs"), ()),
    "fs-block": (cs.N_FS_BLOCK, lambda: cs.block3_matrix(cs.N_FS_BLOCK),
                 cs.check_fs_plan("blocks"), ()),
    "headline-nofuse": (cs.N, lambda: cs.build_matrix(cs.N),
                        cs.check_nofuse_plan("headline"), cs.NO_FUSE),
    "blocky-nofuse": (cs.N, lambda: cs.build_blocky_matrix(cs.N),
                      cs.check_nofuse_plan("blocky"), cs.NO_FUSE),
    "blocky-2^22": (cs.N_BIG, lambda: cs.build_blocky_matrix(cs.N_BIG),
                    lambda m, lb: cs.check_pages_plan(m, "blocky", lb), ()),
    "headline-2^22": (cs.N_BIG, lambda: cs.build_matrix(cs.N_BIG),
                      lambda m, lb: cs.check_pages_plan(m, "headline", lb),
                      ()),
    # a symmetric matrix's per-shard plan (both paged delta streams)
    "symmetric": (cs.N_SYM, lambda: cs.build_symmetric_matrix(cs.N_SYM),
                  cs.check_sym_plan("symmetric"),
                  cs.SYMMETRIC + (("spx.tpu.sym_full", "off"),)),
}


def _emulated_delta_pages_acc(plo, sl, vals, x2, q, acc, rows):
    """The delta-pages scatter epilogue as a library without it runs the
    work: the product kernel, then the torch scatter-add."""
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    return tpk.add_totals(acc, tpk.delta_pages(plo, sl, vals, x2, q)
                          .reshape(-1), rows)


def _emulated_delta_rowblock_acc(plo, sl, lrow, vals, x2, q, acc, blk_tile,
                                 rb):
    """The row-blocked epilogue as a library without it runs the work: the
    tree's delta-pages product over the row-blocked stream, then the torch
    scatter-add into each slot's row."""
    from sparsex_tpu_torch.ops import pallas_kernels as tpk
    return tpk.add_totals(acc, tpk.delta_pages(plo, sl, vals, x2, q)
                          .reshape(-1), tpk._rowblock_rows(lrow, blk_tile,
                                                           rb))


# kernel -> what a tree whose library lacks it runs in its place
EMULATED = {"delta_pages_acc": _emulated_delta_pages_acc,
            "delta_rowblock_acc": _emulated_delta_rowblock_acc}
MISSING = {}     # library -> the kernels it lacks


def launch_key(name):
    """The launch-count key of a kernel named by its CUDA name without
    ``_kernel``: the lane-placed K1's are ``k1`` / ``k1_kb``
    (``fused.KERNELS``); every other kernel's is its name."""
    return {"k1_lp": "k1", "k1_lp_kb": "k1_kb"}.get(name, name)


def build_libraries(trees, names):
    """{tree: loaded ctypes library} of each tree's csrc/*.cu, built with
    this tree's nvcc flags into ``<tree>/sparsex_tpu_torch/_build/``, every
    tree's sources compiled together; ptxas's lines of the kernels
    ``names`` go to stderr.  A variant that does not build is reported and
    left out; the base (the first tree) must build."""
    import glob
    from concurrent.futures import ThreadPoolExecutor
    from sparsex_tpu_torch.ops import _build
    nvcc = _build.nvcc_path()

    def build(n, tree):
        srcs = sorted(glob.glob(os.path.join(tree, "sparsex_tpu_torch",
                                             "csrc", "*.cu")))
        out_dir = os.path.join(tree, "sparsex_tpu_torch", "_build")
        os.makedirs(out_dir, exist_ok=True)
        objs = [os.path.join(out_dir, f"ab{n}_{os.path.basename(s)}.o")
                for s in srcs]
        lib = os.path.join(out_dir, f"libab{n}.so")
        log = _build._run([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, s]
                           for s, o in zip(srcs, objs)])
        _build._run([[nvcc, "-shared", "-o", lib, *objs]])
        return lib, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(trees)) as pool:
        futures = [pool.submit(build, n, t) for n, t in enumerate(trees)]
    libs = {}
    for n, (tree, fut) in enumerate(zip(trees, futures)):
        try:
            path, log = fut.result()
        except _build.KernelBuildError as e:
            if n == 0:
                cs.fail(f"the base {tree} does not build: {e}")
            cs.say(f"variant {tree} does not build, left out: "
                   f"{str(e)[-2000:]}")
            continue
        for line in cs.ptxas_report(log):
            if line.startswith(tuple(n + "_kernel" for n in names)):
                print(f"  ptxas [{os.path.basename(tree)}]: {line}",
                      file=sys.stderr)
        lib = ctypes.CDLL(path)
        MISSING[lib] = set(_build._bind(lib, missing_ok=True))
        if MISSING[lib] - set(EMULATED):
            cs.fail(f"{tree} lacks the kernels "
                    f"{sorted(MISSING[lib] - set(EMULATED))}")
        if MISSING[lib]:
            cs.say(f"{tree} lacks {sorted(MISSING[lib])}: emulated")
        libs[tree] = lib
    cs.say(f"built {len(libs)} of {len(trees)} libraries in "
           f"{time.perf_counter() - t0:.1f} s")
    return libs


def using(lib, fn):
    """``fn`` with the kernel loader pointed at ``lib`` while it runs, and
    each kernel that ``lib`` lacks replaced by its ``EMULATED`` composition
    (the wrappers are looked up in their module at each call)."""
    from sparsex_tpu_torch.ops import _build
    from sparsex_tpu_torch.ops import pallas_kernels as tpk

    def call():
        saved, _build._lib = _build._lib, lib
        kept = {n: getattr(tpk, n) for n in MISSING.get(lib, ())}
        for name in kept:
            setattr(tpk, name, EMULATED[name])
        try:
            return fn()
        finally:
            _build._lib = saved
            for name, wrapper in kept.items():
                setattr(tpk, name, wrapper)
    return call


def captured_args(ex, x, label, names):
    """{name: (wrapper, plain, argument tuples)} of the kernels in
    ``names`` as chip_smoke's kernel phase feeds them on this path
    (untimed; every kernel of the phase is still checked)."""
    seen = {}
    original = cs.check_kernel

    def capture(res, lab, timed, name, fn, plain, args, *rest, **kw):
        if name in names:
            seen[name] = (fn, plain, args)
        return original(res, lab, False, name, fn, plain, args, *rest, **kw)

    cs.check_kernel = capture
    try:
        cs.kernel_phase(ex, x, label, timed=False)
    finally:
        cs.check_kernel = original
    if "delta_pages" in names and "delta_pages" not in seen and \
            "delta_pages_acc" in seen:
        # the product form on the epilogue's streams, off the path
        from sparsex_tpu_torch.ops import pallas_kernels as tpk
        seen["delta_pages"] = (tpk.delta_pages, tpk.delta_pages_plain,
                               [a[:5] for a in seen["delta_pages_acc"][2]])
    return seen


def turns(libs, base, variant, make, loops, outer):
    """(A ms, V ms) of ``make()``'s calls replayed from a CUDA graph, in
    turns A, V, V, A."""
    a1, v1, v2, a2 = (cs.graph_time_ms(using(libs[t], make), loops, outer)
                      for t in (base, variant, variant, base))
    return (a1 + a2) / 2, (v1 + v2) / 2


def kernel_readings(libs, base, variant, seen, label, checked=True):
    """Each captured kernel alone for A and V (chip_smoke's replay counts:
    fewer for the k-batched kernels), with its errors and bound; V's
    errors fail the run only if ``checked``."""
    import torch
    out = {}
    for name, (fn, plain, args) in seen.items():
        loops, outer = ((cs.MM_LOOPS, cs.MM_OUTER) if name.endswith("_kb")
                        else (cs.LOOPS, cs.OUTER))
        fresh = cs.FRESH.get(name, lambda a: a)

        def call(*a, _m=sys.modules[fn.__module__], _n=fn.__name__):
            return getattr(_m, _n)(*a)   # a missing kernel: its emulation
        errs = {}
        for tag, tree in (("A", base), ("V", variant)):
            got = using(libs[tree], lambda: [call(*fresh(a))
                                             for a in args])()
            torch.cuda.synchronize()
            wants = [plain(*fresh(a)) for a in args]
            if checked or tag == "A":
                errs[tag] = max(cs.cmp(name, label, g, w, False)
                                for g, w in zip(got, wants))
            else:
                errs[tag] = max((g.double() - w.double()).abs().max().item()
                                for g, w in zip(got, wants))
        nbytes = flops = 0
        for a, o in zip(args, got):
            b, f = cs.BOUNDS[name](a, o)
            nbytes, flops = nbytes + b, flops + f
        dt = str(got[0].dtype).replace("torch.", "")
        bound = max(nbytes / cs.HBM_BYTES_PER_S,
                    flops / cs.PEAK_FLOPS[dt]) * 1e3
        a_ms, v_ms = turns(libs, base, variant,
                           lambda: [call(*a) for a in args], loops, outer)
        out[name] = {"A_us": a_ms * 1e3, "V_us": v_ms * 1e3,
                     "bound_us": bound * 1e3, "A_err": errs["A"],
                     "V_err": errs["V"]}
        cs.say(f"{label} {name} alone: A {a_ms * 1e3:.2f} us, V "
               f"{v_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us; max abs "
               f"err A {errs['A']:.3e}, V {errs['V']:.3e}")
    return out


def end_to_end(libs, base, variant, call, label, loops, kb, names):
    """Graph times of ``call`` (the SpMV or SpMM) and the named kernels'
    device time inside it (torch.profiler), for A and V."""
    a_ms, v_ms = turns(libs, base, variant, call, loops, cs.OUTER)
    res = {"A_graph_us": a_ms * 1e3, "V_graph_us": v_ms * 1e3}
    for tag, tree in (("A", base), ("V", variant)):
        prof, _glue = cs.profile_phase(using(libs[tree], call),
                                       reps=20 if kb else 50, kb=kb)
        for name in names:
            res[f"{tag}_{name}_in_call_us"] = (None if prof is None
                                               else prof.get(name))
    cs.say(f"{label} graph: A {res['A_graph_us']:.2f} us, V "
           f"{res['V_graph_us']:.2f} us ({100 * (v_ms / a_ms - 1):+.1f} %); "
           "in the call " + ", ".join(
               f"{n} A {res[f'A_{n}_in_call_us'] or 0:.2f} / V "
               f"{res[f'V_{n}_in_call_us'] or 0:.2f} us" for n in names))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--variant", action="append")
    ap.add_argument("--diagnostic", action="append", default=[])
    ap.add_argument("--kernels", default="k3,k3_kb")
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--alone", action="store_true",
                    help="time the kernels alone only, no SpMV / SpMM")
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    import sparsex_tpu_torch as spx
    from sparsex_tpu_torch.ops import fused as tf
    from sparsex_tpu_torch.ops.kernels import fused_mm_ok

    base = os.path.abspath(opt.base)
    variants = [os.path.abspath(v) for v in (opt.variant or [ROOT])]
    diagnostic = [os.path.abspath(v) for v in opt.diagnostic]
    variants += diagnostic
    kernels = opt.kernels.split(",")
    names = [launch_key(n) for n in kernels]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cs.say(f"card: {card}; torch {torch.__version__}; base {base}; "
           f"variants {variants}")
    libs = build_libraries([base] + variants, kernels)
    variants = [v for v in variants if v in libs]
    if not [v for v in variants if v not in diagnostic]:
        cs.fail("no variant builds")
    from sparsex_tpu_torch.ops import _build
    _build._lib = libs[variants[0]]     # the untimed kernel checks' library
    cs.warm_up()
    tol = {"float32": cs.CHECK_TOL, "float64": 1e-6}
    report = {"card": card, "base": base, "paths": {}}
    for path in opt.paths.split(","):
        n, build, check, options = PATHS[path]
        rows, cols, vals = build()
        for dtype in opt.dtypes.split(","):
            label = f"{path} {dtype}"
            mat = cs.tune(spx, rows, cols, vals, n, dtype, label, options)
            ex = check(mat, label)
            x = cs.x_for(mat, n, dtype)
            X = torch.as_tensor(np.random.default_rng(3).standard_normal(
                (n, tf.MAX_KB)), dtype=ex.dtype, device=mat.device)
            seen = captured_args(ex, x, label, names)
            mm = fused_mm_ok(ex.meta)
            if mm:
                seen.update(captured_args(ex, X.T.contiguous(),
                                          label + " spmm", names))
            for v in variants:
                tag = f"{label} V={os.path.basename(v)}"
                entry = kernel_readings(libs, base, v, seen, tag,
                                        v not in diagnostic)
                if v in diagnostic or opt.alone:   # diagnostic: not right
                    report["paths"][tag] = entry
                    continue

                # the executor's eager body: a call through the API would
                # replay the executor's own graph, which holds the kernels
                # of whichever tree it was captured with
                def spmv():
                    with ex._on_device():
                        return ex._matvec(x)

                y = {t: using(libs[t], spmv)().double().cpu().numpy()
                     for t in (base, v)}
                want = np.bincount(rows, weights=vals.astype(np.float64)
                                   * x.double().cpu().numpy()[cols],
                                   minlength=n)
                errs = {t: cs._mixed_rel_err(y[t], want) for t in y}
                if max(errs.values()) >= tol[dtype]:
                    cs.fail(f"[{tag}] SpMV oracle errors {errs}")
                entry["spmv"] = end_to_end(
                    libs, base, v, spmv, tag + " spmv", cs.LOOPS, False,
                    [k for k in names if not k.endswith("_kb")])
                if mm:
                    def spmm():
                        return ex.matmat(X)
                    entry["spmm_k8"] = end_to_end(
                        libs, base, v, spmm, tag + " spmm k=8",
                        2 * cs.MM_LOOPS, True,
                        [k for k in names if k.endswith("_kb")])
                report["paths"][tag] = entry
            del mat, ex, x, X
            torch.cuda.empty_cache()
    cs.say(json.dumps(report))


if __name__ == "__main__":
    main()
