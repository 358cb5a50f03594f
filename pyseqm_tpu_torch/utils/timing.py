"""Phase wall-clock timing (cf. the reference Constants.do_timing dict,
seqm_functions/constants.py:133-140).

PyTorch counterpart of ``pyseqm_tpu/utils/timing.py``.  CUDA kernels run
asynchronously, so a phase ends with ``torch.cuda.synchronize()`` when it
ran on the card; for a kernel-level breakdown use
:func:`profiler_trace` (torch.profiler).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


class Timing:
    """Accumulates per-phase wall-clock samples.

    >>> t = Timing()
    >>> with t.phase("SCF"):
    ...     out = step(x)      # the card is synchronized at the phase end
    >>> t.summary()
    """

    def __init__(self):
        self.phases: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        """Time the block as phase ``name``.  On exit the CUDA ``device``
        is synchronized (every CUDA device the process has used when
        ``device`` is None; nothing when it is a CPU device)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dev = None if device is None else torch.device(device)
            if dev is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            elif dev is None and torch.cuda.is_initialized():
                for i in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(i)
            self.phases[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"count": len(xs), "total": sum(xs),
                       "mean": sum(xs) / len(xs), "min": min(xs)}
                for name, xs in self.phases.items()}

    def report(self):
        for name, s in self.summary().items():
            print(f"{name:>24}: n={s['count']:4d} total={s['total']:.3f}s "
                  f"mean={s['mean'] * 1e3:.1f}ms min={s['min'] * 1e3:.1f}ms")


def timed(timing: Optional[Timing], name: str, device):
    """``timing.phase(name, device)``, or a context that does nothing
    when ``timing`` is None (the drivers' ``timing=`` argument)."""
    if timing is None:
        return contextlib.nullcontext()
    return timing.phase(name, device)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Record a torch.profiler trace (CPU and, with a GPU, CUDA activity)
    and write it to ``logdir`` as a Chrome trace; yields the profiler,
    whose ``key_averages()`` give the kernel-level breakdown."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
