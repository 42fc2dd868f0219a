"""Rank bodies of the multi-device tests (``tests/test_torch_parallel.py``,
``tests/test_torch_cuda.py``), started by
``sparsex_tpu_torch.parallel.comm.run_ranks``.

A spawned rank imports this module afresh, so it imports neither ``jax``
nor ``sparsex_tpu``.  The parent hands each rank a pickle of cases (a
tuned matrix's host side or an archive, options, planner thresholds and
the operations to run); each rank writes what it got to
``<out_dir>/<case>.<rank>.pkl``.
"""

import os
import pickle

import torch


def _thresholds(values: dict) -> dict:
    """Set the planners' thresholds by name; returns the old values."""
    from sparsex_tpu_torch.ops import fused, pallas_kernels, route
    mods = {"MIN_FUSED_NNZ": fused, "MIN_PAGE_NNZ": pallas_kernels,
            "MIN_ELEMS": route}
    old = {}
    for name, value in values.items():
        old[name] = getattr(mods[name], name)
        setattr(mods[name], name, value)
    return old


def _matrix(case):
    from sparsex_tpu_torch.parallel.shard import host_matrix
    if "archive" in case:
        from sparsex_tpu_torch.persist import restore_csx
        return restore_csx(case["archive"], device="cpu")[0]
    return host_matrix(case["host"])


def _run(sh, op):
    """One operation of a case on a ShardedCsx: its result as numpy."""
    from sparsex_tpu_torch import solvers
    kind = op[0]
    if kind == "matvec":
        _, x, alpha, beta, y = op
        return sh.matvec(x, alpha, beta, y).numpy()
    if kind == "matmat":
        _, X, alpha = op
        return sh.matmat(X, alpha).numpy()
    _, b, tol, maxiter = op        # "cg"
    x, it, res = solvers.cg(lambda v: sh.matvec(v), torch.as_tensor(b),
                            tol=tol, maxiter=maxiter, device="cpu",
                            graph=False)
    return (x.numpy(), it, float(res))


def run_cases(rank, cases_path, out_dir):
    """Run every case of ``cases_path`` whose group size is this group's,
    on the CPU."""
    import torch.distributed as dist

    import sparsex_tpu_torch as spt
    from sparsex_tpu_torch.parallel.shard import ShardedCsx
    torch.set_num_threads(1)
    with open(cases_path, "rb") as fp:
        cases = pickle.load(fp)
    for case in cases:
        if case["nranks"] != dist.get_world_size():
            continue
        cfg = spt.Config.reset()
        for key, value in case["options"].items():
            cfg.set(key, str(value))
        old = _thresholds(case["thresholds"])
        out = {}
        try:
            mat = _matrix(case)
            if case.get("raises"):
                try:
                    ShardedCsx(mat, device="cpu")
                    out["raised"] = None
                except ValueError as e:
                    out["raised"] = str(e)
            else:
                sh = ShardedCsx(mat, device="cpu")
                out["layout"] = (sh.x_mode, sh.halo_k, sh.chunk)
                out["classes"] = [sorted(e[0] for e in ex.meta[5:] if e)
                                  for ex in sh.executors]
                out["variants"] = [ex.variant for ex in sh.executors]
                out["results"] = [_run(sh, op) for op in case["ops"]]
                out["bytes"] = dict(sh.comm.bytes)
                out["calls"] = dict(sh.comm.calls)
        finally:
            _thresholds(old)
        with open(os.path.join(out_dir, f"{case['name']}.{rank}.pkl"),
                  "wb") as fp:
            pickle.dump(out, fp)


def run_cuda_case(rank, case_path, out_dir):
    """One case on ``cuda:0`` shared by the group's ranks (gloo through
    the host): the rank's y, SpMM, launch counts of its first call against
    its executors' plans, where its executors' tensors live and their
    bytes."""
    import chip_smoke
    import sparsex_tpu_torch as spt
    from sparsex_tpu_torch.ops import fused as tf
    from sparsex_tpu_torch.parallel.shard import ShardedCsx, host_matrix
    torch.set_num_threads(1)
    with open(case_path, "rb") as fp:
        case = pickle.load(fp)
    cfg = spt.Config.reset()
    for key, value in case["options"].items():
        cfg.set(key, str(value))
    dev = torch.device("cuda:0")
    sh = ShardedCsx(host_matrix(case["host"]), device=dev)
    devices = set().union(*(chip_smoke._tensor_devices(ex.arrays)
                            for ex in sh.executors))
    nbytes = sum(chip_smoke._tensor_bytes(ex.arrays) for ex in sh.executors)
    x = torch.as_tensor(case["x"], device=dev)
    tf.launches.clear()
    y = sh.matvec(x)
    torch.cuda.synchronize()
    counts = tf.launch_counts()
    want = {}
    for ex in sh.executors:
        for key, v in chip_smoke.expected_counts(ex.meta).items():
            want[key] = want.get(key, 0) + 2 * v    # warm-up + capture
    y2 = sh.matvec(x)                               # a replay
    Y = sh.matmat(torch.as_tensor(case["X"], device=dev))
    torch.cuda.synchronize()
    out = {"y": y.cpu().numpy(), "y2": y2.cpu().numpy(),
           "Y": Y.cpu().numpy(), "counts": counts, "want": want,
           "devices": sorted(devices), "plan_bytes": nbytes,
           "x_mode": sh.x_mode, "host_bytes": dict(sh.comm.host_bytes)}
    with open(os.path.join(out_dir, f"cuda.{rank}.pkl"), "wb") as fp:
        pickle.dump(out, fp)

