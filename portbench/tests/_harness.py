"""Shared helpers of the benchmark's tests: the harness's modules on the
path, and one tiny cell run on the CPU."""
from __future__ import annotations

import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2 ** 31 + 77          # above 32 signed bits, as a check's seeds are


def tiny_spec(workload: str, batch: int = 12) -> dict:
    from pbench import registry
    spec = registry.load(ROOT, workload)
    tr = spec["traffic"]
    tr.update(batch=batch, warmup_steps=2, trace_steps=1,
              warmup_requests=1, trace_requests=1)
    return spec


def run_cpu(workload: str, trace: bool = False, hook=None, batch: int = 12,
            seconds: float = 0.5) -> dict:
    import torch
    torch.set_num_threads(2)
    import run
    return run.run(tiny_spec(workload, batch), SEED, seconds, trace, "cpu",
                   time.perf_counter(), cell_hook=hook)
