"""Sizing sweep: for each cell and batch, the time per step or request,
the card's busy share over profiled steps, the peak memory, the time of
the correctness check and its numbers.  One process on one card:

    python3 portbench/sweep.py --out out/sweep.json \
        xl-small:81920,163840 xl-nonane:10240 sp-small:81920

The batch of each cell's traffic is replaced by each value in turn."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)


def point(workload: str, batch: int, seed: int, units: int) -> dict:
    import torch
    from pbench import cells, registry
    spec = registry.load(ROOT, workload)
    spec["traffic"]["batch"] = batch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = registry.kind(spec["bench_dir"], spec["traffic"]["kind"])(
        spec, seed, "cuda:0", True)
    cell.setup()
    t_setup = time.perf_counter() - t0
    xl = isinstance(cell, cells.XLCell)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(units + 1)]
    ev[0].record()
    t0 = time.perf_counter()
    for i in range(units):
        if xl:
            cell._steps(1)
        else:
            cell._requests(1)
        ev[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    sess = cell.traced()
    a, b = sess["a"], sess["b"]
    busy, _ = a.busy()
    peak_run = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    values = cell.check()
    t_check = time.perf_counter() - t0
    peak_all = torch.cuda.max_memory_allocated()
    from pbench import readers
    data = dict(sess)
    data.update(cell.trace_data())
    row = {"workload": workload, "batch": batch, "setup_s": t_setup,
           "unit_ms": ms, "wall_ms_per_unit": 1e3 * wall / units,
           "busy_share": busy / a.window_s, "trace_window_s": a.window_s,
           "launches_per_unit": a.launch_count() / a.units,
           "backward_ms": readers.backward_ms(data),
           "integrals_ms": readers.integrals_ms(data),
           "k3_roofline": readers.k3_roofline(data),
           "k1_roofline": readers.k1_roofline(data),
           "k2_roofline": readers.k2_roofline(data),
           "k2_per_request": data.get("k2_per_request"),
           "device_ops": a.device_ops(), "idle_gaps": a.idle_gaps(),
           "peak_run_bytes": peak_run, "peak_with_check_bytes": peak_all,
           "check_s": t_check, "checks": values,
           "n_device_events": len(a.device), "n_ops": len(a.ops),
           "n_frames": sum(len(f[0]) for f in b.frames.values())}
    del cell, sess, a, b, data
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=3_000_000_017)
    ap.add_argument("--units", type=int, default=6)
    ap.add_argument("cells", nargs="+")
    args = ap.parse_args()
    rows = []
    for item in args.cells:
        w, batches = item.split(":")
        for b in batches.split(","):
            try:
                row = point(w, int(b), args.seed, args.units)
            except Exception as exc:   # record the failure and go on
                import traceback
                traceback.print_exc()
                row = {"workload": w, "batch": int(b), "error": repr(exc)}
                import torch
                gc.collect()
                torch.cuda.empty_cache()
            rows.append(row)
            short = {k: v for k, v in row.items()
                     if k not in ("device_ops", "idle_gaps", "unit_ms")}
            print(json.dumps(short), flush=True)
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(rows, fh, indent=1)
    print(f"sweep done in {time.perf_counter() - T0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
