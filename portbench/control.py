"""Readings that the limits of ``correct`` are set from, for one cell at
its own size, in one process on one card:

    python3 portbench/control.py --workload xl-small --seconds 3 \
        --seeds 12 --control-seeds 3 --out out/control-xl-small.json

For each of ``--seeds`` seeds: set-up, a short window at the cell's own
load, and the compared numbers of the port against the float64 reference
(the lower readings).  For the first ``--control-seeds`` of them also the
control's numbers: the reference computed at float32 with TF32 on, put in
the port's place on the same inputs and state (the upper readings).  The
benchmark's own runs never run the control."""
import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)


def main():
    import torch
    from pbench import registry
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_100_000_003)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    spec = registry.load(ROOT, args.workload)
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        cell = registry.kind(spec["bench_dir"], spec["traffic"]["kind"])(
            spec, seed, "cuda:0", False)
        cell.setup()
        cell.window(args.seconds)
        row = {"seed": seed, "program": cell.check(), "failed": cell.failed}
        if i < args.control_seeds:
            row["control"] = cell.check(control=True)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    names = sorted(rows[0]["program"])
    summary = {n: {"lower": max(r["program"][n] for r in rows),
                   "upper": min((r["control"][n] for r in rows
                                 if "control" in r), default=None)}
               for n in names}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"rows": rows, "summary": summary}, fh, indent=1)


if __name__ == "__main__":
    main()
