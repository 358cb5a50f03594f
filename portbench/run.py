"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the port
(``pyseqm_tpu_torch``).  The run makes its inputs from the seed, sets up the
port (its CUDA kernels build into ``pyseqm_tpu_torch/_build/`` inside the
checkout on the first run there), warms up the cell's own shapes, then
measures for ``--seconds`` (``--trace 0``: the end-to-end metrics) or
profiles a few steps or requests (``--trace 1``: the per-layer metrics),
checks what the timed path produced against the plain reference
(``reference/``), and prints one JSON object as the last line of standard
output.  The numbers compared and their limits are the last lines of
standard error and the last key of that object.

It exits with a non-zero code and prints no result when no CUDA device is
present, when the cell asks for more devices than there are, when the port
cannot be imported, or when JAX or the JAX package is loaded once the
window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)
# every cache stays at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "pyseqm_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``pyseqm_tpu_torch`` is not ``pyseqm_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class ForbiddenImport(RuntimeError):
    pass


def power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return res.stdout.strip().splitlines()[0] if res.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(spec: dict, seed: int, seconds: float, tracing: bool, device,
        t_start: float, cell_hook=None) -> dict:
    """One run of one cell; returns the result object (without printing).
    ``cell_hook`` (tests) receives the cell after set-up."""
    import torch
    from pbench import registry
    cell = registry.kind(spec["bench_dir"], spec["traffic"]["kind"])(
        spec, seed, device, tracing)
    cell.setup()
    if cell_hook is not None:
        cell_hook(cell)
    setup_s = time.perf_counter() - t_start
    cuda = cell.device.type == "cuda"
    sessions = cell.traced() if tracing else None
    e2e = None if tracing else cell.window(seconds)
    peak = int(torch.cuda.max_memory_allocated(cell.device)) if cuda else 0
    found = loaded_forbidden()
    if found:
        raise ForbiddenImport(f"loaded after the window: {found}")
    values = cell.check()
    limits = spec["limits"]
    correct = (cell.failed == 0 and set(values) == set(limits)
               and all(values[n] <= limits[n] for n in limits))
    device_info = {"platform": "gpu" if cuda else cell.device.type,
                   "kind": (torch.cuda.get_device_name(cell.device) if cuda
                            else "cpu"),
                   "count": spec["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(cell.attempted),
              "failed": int(cell.failed)}
    if tracing:
        a = sessions["a"]
        busy_s, _ = a.busy()
        device_info["busy_s"] = busy_s
        device_info["window_s"] = a.window_s
        data = dict(sessions)
        data.update(cell.trace_data())
        result["metrics"] = registry.read_per_layer(spec, data)
        result["breakdown"] = {"device_ops": a.device_ops(),
                               "idle_gaps": a.idle_gaps()}
    else:
        e2e["setup_s"] = setup_s
        result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                         "unit": m["unit"]}
                             for m in spec["end_to_end"] if m["name"] in e2e}
    result["device"] = device_info
    checks = {n: {"value": values.get(n), "limit": limits[n]}
              for n in limits}
    checks["failed"] = {"value": int(cell.failed), "limit": 0}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from pbench import registry
    spec = registry.load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"the cell asks for {spec['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    card = power_limit()
    print(f"[card] {card}", file=sys.stderr, flush=True)
    try:
        result = run(spec, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", T_START)
    except ForbiddenImport as exc:
        print(str(exc), file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["device"]["card"] = card
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
