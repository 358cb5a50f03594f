"""Shared helpers of the benchmark's tests: the harness's modules on the
path, one tiny cell run on the CPU, and a checkout whose benchmark holds
the toy cells of ``toy/`` (a learned model, a molecule set and a cell
kind, each a file of its own) beside the accepted ones."""
from __future__ import annotations

import json
import os
import shutil
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2 ** 31 + 77          # above 32 signed bits, as a check's seeds are


def tiny_spec(workload: str, batch: int = 12, root: str = ROOT,
              bench: str = BENCH) -> dict:
    from pbench import registry
    spec = registry.load(root, workload, bench_dir=bench)
    tr = spec["traffic"]
    tr.update(batch=batch, warmup_steps=2, trace_steps=1,
              warmup_requests=1, trace_requests=1)
    return spec


def run_cpu(workload: str, trace: bool = False, hook=None, batch: int = 12,
            seconds: float = 0.5, root: str = ROOT, bench: str = BENCH
            ) -> dict:
    import torch
    torch.set_num_threads(2)
    import run
    return run.run(tiny_spec(workload, batch, root, bench), SEED, seconds,
                   trace, "cpu", time.perf_counter(), cell_hook=hook)


def toy_checkout(where) -> tuple:
    """(root, bench): a copy of the benchmark at ``where`` with the files of
    ``toy/`` added under their own directories and the toy configuration
    and cells added to its ``BENCHMARK.json``; no file that is here is
    changed."""
    root = os.path.join(str(where), "checkout")
    bench = os.path.join(root, "portbench")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    toy = os.path.join(BENCH, "tests", "toy")
    for dirpath, _, files in os.walk(toy):
        rel = os.path.relpath(dirpath, toy)
        for f in files:
            if f == "BENCHMARK.add.json":
                continue
            dest = os.path.join(bench, rel, f)
            assert not os.path.exists(dest), dest
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            shutil.copy(os.path.join(dirpath, f), dest)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    with open(os.path.join(toy, "BENCHMARK.add.json")) as fh:
        add = json.load(fh)
    spec["configs"] += add["configs"]
    spec["workloads"] += add["workloads"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return root, bench
