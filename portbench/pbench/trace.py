"""Reading a torch.profiler session of the card into what the per-layer
metrics and the breakdown need.

One ``Session`` holds the raw events of one profiled stretch of the run:
device activities (kernels, copies, memsets) with their start, end and
name, the host's launch calls, the frontend ops that launched them, the
outermost calls into the port's ``ops/`` modules when the session
recorded them, and the benchmark's own spans (``record_function`` names
starting with ``bench.``).  The
events come from the profiler's raw kineto results, which is much faster
than building ``FunctionEvent`` trees for the ~25,000 launches of one
step.
"""
from __future__ import annotations

import bisect
import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "bench."
ENGINE_PREFIX = "autograd::engine::evaluate_function"
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


@contextlib.contextmanager
def span(name: str, on: bool):
    """A benchmark span around one call into the port, recorded only in a
    traced run."""
    if not on:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


OPS_PACKAGE = "pyseqm_tpu_torch/ops/"
FRAME_PREFIX = SPAN_PREFIX + "frame:"


class _PortFrames:
    """A ``sys.setprofile`` hook that opens a span ``bench.frame:<file>``
    around each outermost call into the port's ``ops/`` modules on the
    calling thread: the Python frames under which each op was launched,
    read by the benchmark without a change to the program and without the
    profiler's own Python tracer, which not every torch build fills in."""

    def __init__(self):
        self.rf = None
        self.frame = None

    def __call__(self, frame, event, arg):
        if event == "call" and self.rf is None:
            fn = frame.f_code.co_filename.replace(os.sep, "/")
            if OPS_PACKAGE in fn:
                self.rf = torch.profiler.record_function(
                    FRAME_PREFIX + fn.split(OPS_PACKAGE, 1)[1])
                self.rf.__enter__()
                self.frame = frame
        elif event == "return" and frame is self.frame:
            self.rf.__exit__(None, None, None)
            self.rf = self.frame = None


def _outermost(frames):
    """(starts, ends, names) of the frames not nested in another one of
    ``frames`` (one thread's properly nested calls), sorted."""
    starts, ends, names = [], [], []
    for a, b, n in sorted(frames, key=lambda f: (f[0], -f[1])):
        if ends and a <= ends[-1]:
            continue
        starts.append(a)
        ends.append(b)
        names.append(n)
    return starts, ends, names


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Intervals:
    """Sorted, merged intervals per thread, for 'is t inside one' queries."""

    def __init__(self, by_thread: Dict[int, List[Tuple[int, int]]]):
        self._starts = {}
        self._ends = {}
        for tid, iv in by_thread.items():
            m = _merge(iv)
            self._starts[tid] = [a for a, _ in m]
            self._ends[tid] = [b for _, b in m]

    def contains(self, tid: int, t: int) -> bool:
        starts = self._starts.get(tid)
        if not starts:
            return False
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= self._ends[tid][i]


class Session:
    """The events of one profiled stretch of ``units`` steps or requests,
    whose host time was ``window_s``."""

    def __init__(self, prof, units: int, window_s: float, frames: bool):
        self.units = units
        self.window_s = window_s
        from torch.autograd import DeviceType
        raw = prof.profiler.kineto_results.events()
        self.device = []        # (start_ns, end_ns, name, corr, linked)
        self.launches = []      # (start_ns, thread, corr, linked)
        ops = {}                # correlation id -> (start_ns, thread, name)
        engine = defaultdict(list)
        frames = defaultdict(list)   # thread -> outermost calls into ops/
        spans = []              # (start_ns, end_ns, name)
        for e in raw:
            name = e.name()
            if e.device_type() != DeviceType.CPU:
                # the benchmark's spans are mirrored onto the device's
                # timeline as annotations: they are not device work
                if not name.startswith(SPAN_PREFIX):
                    self.device.append((e.start_ns(), e.end_ns(), name,
                                        e.correlation_id(),
                                        e.linked_correlation_id()))
                continue
            if name.startswith(FRAME_PREFIX):
                frames[e.start_thread_id()].append(
                    (e.start_ns(), e.end_ns(), name[len(FRAME_PREFIX):]))
                continue
            if name.startswith(LAUNCH_PREFIXES):
                self.launches.append((e.start_ns(), e.start_thread_id(),
                                      e.correlation_id(),
                                      e.linked_correlation_id()))
            elif name.startswith(ENGINE_PREFIX):
                engine[e.start_thread_id()].append((e.start_ns(), e.end_ns()))
            elif name.startswith(SPAN_PREFIX):
                spans.append((e.start_ns(), e.end_ns(),
                              name[len(SPAN_PREFIX):]))
            elif e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = (e.start_ns(), e.start_thread_id(),
                                           name)
        self.ops = ops
        self.engine = _Intervals(engine)
        self.frames = {tid: _outermost(fr) for tid, fr in frames.items()}
        self.spans = sorted(spans)
        self.device.sort()

    # -- launches and kernels ------------------------------------------
    def launch_count(self) -> int:
        return len(self.launches)

    def kernels(self, *needles: str):
        """(start, end, name) of the device activities whose name holds
        every needle."""
        return [(a, b, n) for a, b, n, _, _ in self.device
                if all(s in n for s in needles)]

    def _op_of(self, linked: int):
        return self.ops.get(linked)

    def in_backward(self, linked: int) -> bool:
        op = self._op_of(linked)
        return op is not None and self.engine.contains(op[1], op[0])

    def backward_seconds(self) -> float:
        return sum(b - a for a, b, _, _, linked in self.device
                   if self.in_backward(linked)) * 1e-9

    def _outer_frame(self, tid: int, t: int) -> Optional[str]:
        """The file (under the port's ops/) of the outermost Python frame
        of the port's ops/ open on thread tid at host time t."""
        fr = self.frames.get(tid)
        if not fr:
            return None
        starts, ends, names = fr
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > ends[i]:
            return None
        return names[i]

    def module_seconds(self, modules) -> Optional[float]:
        """Device seconds of the forward kernels whose launching op ran
        inside a call into the port's ops/ whose outermost frame is in one
        of ``modules`` (file names).  None without recorded frames."""
        if not self.frames:
            return None
        total = 0
        for a, b, _, _, linked in self.device:
            op = self._op_of(linked)
            if op is None or self.engine.contains(op[1], op[0]):
                continue
            if self._outer_frame(op[1], op[0]) in modules:
                total += b - a
        return total * 1e-9

    # -- busy, idle ----------------------------------------------------
    def busy(self) -> Tuple[float, List[Tuple[int, int]]]:
        merged = _merge([(a, b) for a, b, _, _, _ in self.device])
        return sum(b - a for a, b in merged) * 1e-9, merged

    def _label(self, t: int) -> str:
        """The innermost benchmark span open at host time t."""
        label = "outside"
        for a, b, name in self.spans:
            if a > t:
                break
            if t <= b:
                label = name
        return label

    def device_ops(self, top: int = 10) -> List[List]:
        by = defaultdict(int)
        for a, b, n, _, _ in self.device:
            by[n[:96]] += b - a
        rank = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, t * 1e-9] for n, t in rank]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle device time between consecutive busy stretches inside the
        window, summed by the benchmark span the host was in when the
        next activity was launched, with the launching op's name."""
        _, merged = self.busy()
        launch_at = {corr: (t, linked)
                     for t, _, corr, linked in self.launches}
        first_of = {}
        for a, b, n, corr, linked in self.device:
            first_of.setdefault(a, (corr, linked))
        by = defaultdict(int)
        for (_, b0), (a1, _) in zip(merged, merged[1:]):
            corr, linked = first_of.get(a1, (None, 0))
            t_host, _ = launch_at.get(corr, (a1, linked))
            op = self._op_of(linked)
            name = self._label(t_host) + "/" + (op[2] if op else "?")
            by[name[:96]] += a1 - b0
        rank = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, t * 1e-9] for n, t in rank]


def record(fn, units: int, frames: bool = False) -> Session:
    """Profile ``fn()`` (which runs ``units`` steps or requests and ends in
    a device synchronize) on the host and the card; ``frames`` also
    records the outermost calls into the port's ops/ modules."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if frames:
            sys.setprofile(_PortFrames())
        try:
            fn()
        finally:
            if frames:
                sys.setprofile(None)
        window_s = time.perf_counter() - t0
    return Session(prof, units, window_s, frames)
