"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload <name> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ... [--one-tune]

runs the cell, in one process, once for each of ``--seeds`` as the
benchmark runs it (the program's readings, the lower ones) and once for
each of ``--control-seeds`` with the port in the precision next below the
configuration's (the control, which has to come out not correct), and
prints one JSON line a run: its numbers compared and whether it was
correct under ``limits/<workload>.json``.  The benchmark's own runs never
run the control.

``--one-tune``, for a configuration whose matrix does not depend on the
seed (its generator's ``SEEDED`` is false): each precision is tuned once,
and each seed runs only the requests its check samples, back to back at
the cell's load, before the check; ``--seconds`` is then not used.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the precision next below a configuration's: the control's
LOWER = {"float64": "float32", "float32": "bfloat16"}


def lower_of(workload: str) -> str:
    from benchmark import harness
    return LOWER[harness.cell_spec(workload)["config"]["value_type"]]


def one_tune_readings(workload: str, seeds, value_type):
    """``(seed, checks, attempted, failed)`` for each seed, on one tune."""
    from benchmark import harness
    cs = harness.cell_spec(workload)
    if harness.load_module("gen", cs["config"]["generator"]).SEEDED:
        raise SystemExit(f"{workload}: the matrix depends on the seed, "
                         "so --one-tune does not apply")
    run = harness.Run(cs, seeds[0], 0.0, False, "cuda:0", value_type)
    harness.prepare(run, time.perf_counter(), {})
    loop_cls = harness.load_module("loops", run.mix["loop"]).Loop
    for seed in seeds:
        run.seed = int(seed) % (1 << 64)
        loop = loop_cls(run)
        recs = [loop.solve(i) for i in sorted(loop.sampled)]
        yield seed, loop.check(), len(recs), sum(not r["ok"] for r in recs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--one-tune", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sets = [(args.seeds, None),
            (args.control_seeds, lower_of(args.workload))]
    for seeds, value_type in sets:
        if not seeds:
            continue
        if args.one_tune:
            rows = one_tune_readings(args.workload, seeds, value_type)
        else:
            rows = ((s, r["checks"], r["attempted"], r["failed"])
                    for s in seeds
                    for r in [harness.run_cell(
                        args.workload, s, args.seconds, False,
                        device="cuda:0", port_value_type=value_type)])
        for seed, checks, attempted, failed in rows:
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "port": value_type or "as configured",
                "correct": bool(checks) and all(
                    c["value"] <= c["limit"] for c in checks.values()),
                "attempted": attempted, "failed": failed,
                "numbers": {k: v["value"] for k, v in checks.items()}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
