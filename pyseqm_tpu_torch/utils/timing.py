"""Phase timing, and the port's record of layer spans and work counts
(cf. the reference Constants.do_timing dict,
seqm_functions/constants.py:133-140).

PyTorch counterpart of ``pyseqm_tpu/utils/timing.py``, plus the span
record.  CUDA kernels run asynchronously, so a :class:`Timing` phase ends
with ``torch.cuda.synchronize()`` when it ran on the card.

**Spans.**  The package opens a span at each layer boundary.  They are
recorded only while a torch.profiler session records (any
``torch.profiler.profile``, or :func:`profiler_trace`); otherwise a span
costs one check of ``torch.autograd._profiler_enabled()`` and records
nothing.  A span adds no kernel launch, no device synchronisation and no
profiler event.  Its times come from ``time.time_ns()``, the clock of the
profiler's own events, so a kernel can be charged to the span open on
the host when it was launched.  The names, one per layer:

- ``md.step``: one step of a dynamics driver (``MolecularDynamics.step``
  and its subclasses, ``XLBOMD.step``);
- ``model.force``: ``models.energy.force`` or ``models.xlbomd.force_xl``;
  counts ``molecules``;
- ``system``: the species checks, ``make_system`` and the per-atom
  parameters;
- ``learned``: inside ``system``, the forward of a learned-parameter
  callable (``learned=``; a mapping of values opens none); counts
  ``molecules`` and ``atoms`` (atom slots, padding included: the
  network's dense pair grid computes every slot); its backward is
  charged to ``backward``;
- ``integrals``: the core Hamiltonian and the two-electron integrals;
- ``scf``: ``scf_solve``; counts ``iterations``, ``polish`` and
  ``reads`` (host reads of the convergence flags);
- ``scf.read``: one such host read, which waits for the card;
- ``fock``: every Fock build;
- ``density``: every ``sp2`` or ``sym_eig`` solve; counts ``molecules``
  and the kernels' own per-molecule work, ``sp2_iterations`` (K1) or
  ``eigh_sweeps`` (K2), summed over molecules;
- ``energy``: the electronic, core-core and isolated-atom terms and
  their assembly;
- ``backward``: the ``torch.autograd.grad`` call of a force.

:class:`Timing` phases are spans too, under the phase's name.

:func:`spans` returns the closed spans of the record: name, thread,
start and end (ns), the parent (the span open when it started; on a
thread with no span open, such as the autograd engine's, the innermost
span of the thread that holds the outermost open span), the root (the
outermost span: one step or one request; its index is the step's or
request's id), the counts, and the self time (the duration less what its
children cover).  A count may be a host integer or a device tensor; a
tensor is kept by reference and summed only when :func:`spans` reads it.
The record holds at most ``SPAN_LOG_MAX`` spans; :func:`dropped` counts
those it did not keep, :func:`reset` empties it.  :func:`profiler_trace`
also writes the spans of its session into its Chrome trace, as a track
of their own.

>>> from torch.profiler import profile
>>> with profile() as prof:
...     state, obs = md.step(species, state)
>>> [(s.name, s.self_ns) for s in spans()]
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

SPAN_LOG_MAX = 1_000_000
# the span track's process id in an exported Chrome trace (above any
# Linux pid)
SPAN_TRACK_PID = 1 << 30

_profiling = torch.autograd._profiler_enabled

# one record per span: [name, thread, start_ns, end_ns (0 while open),
# parent, root, counts (None or {name: [values]})]
_log: List[list] = []
_open: Dict[int, List[int]] = {}     # thread -> indices of its open spans
_lock = threading.Lock()
_dropped = 0


class SpanRecord(NamedTuple):
    index: int
    name: str
    thread: int             # threading.get_native_id() of its thread
    start_ns: int
    end_ns: int
    parent: int             # -1 for a root
    root: int               # the step's or request's id
    counts: Dict[str, int]
    self_ns: int


def _outer_holder():
    """(parent, root) for a span opened on a thread with no span open:
    the innermost open span of the thread that holds the outermost open
    span, or (-1, -1) when no span is open."""
    best = None
    for stack in list(_open.values()):
        if stack and (best is None or stack[0] < best[0]):
            best = stack
    if best is None:
        return -1, -1
    parent = best[-1]
    return parent, _log[parent][5]


class _Span:
    __slots__ = ("name", "index", "log", "stack")

    def __init__(self, name: str):
        self.name = name
        self.index = -1

    def __enter__(self):
        global _dropped
        tid = threading.get_native_id()
        with _lock:
            if len(_log) >= SPAN_LOG_MAX:
                _dropped += 1
                return self
            stack = _open.setdefault(tid, [])
            if stack:
                parent = stack[-1]
                root = _log[parent][5]
            else:
                parent, root = _outer_holder()
            index = len(_log)
            _log.append([self.name, tid, time.time_ns(), 0, parent,
                         index if root < 0 else root, None])
            stack.append(index)
            self.index, self.log, self.stack = index, _log, stack
        return self

    def __exit__(self, *exc):
        if self.index >= 0:
            self.log[self.index][3] = time.time_ns()
            with _lock:
                if self.index in self.stack:
                    self.stack.remove(self.index)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that records span ``name`` while a torch.profiler
    session records, and does nothing otherwise."""
    if not _profiling():
        return _OFF
    return _Span(name)


def tracing() -> bool:
    """True while spans are recorded (a torch.profiler session records)."""
    return _profiling()


def _innermost_open() -> Optional[list]:
    stack = _open.get(threading.get_native_id())
    if stack:
        return _log[stack[-1]]
    parent, _ = _outer_holder()
    return None if parent < 0 else _log[parent]


def count(name: str, value) -> None:
    """Add ``value`` (a host integer, or a device tensor summed when read)
    to count ``name`` of the innermost open span; nothing when spans are
    not recorded."""
    if not _profiling():
        return
    with _lock:
        rec = _innermost_open()
        if rec is None:
            return
        if rec[6] is None:
            rec[6] = {}
        rec[6].setdefault(name, []).append(value)


def _total(values) -> int:
    """The sum of a count's values (tensors summed here, once)."""
    total = 0
    for v in values:
        total += int(v.sum(dtype=torch.int64) if torch.is_tensor(v) else v)
    return total


def spans() -> List[SpanRecord]:
    """The closed spans of the record, in the order they opened, each with
    its counts summed and its self time."""
    with _lock:
        log = list(_log)
    children = defaultdict(list)
    for i, rec in enumerate(log):
        if rec[3] and rec[4] >= 0:
            children[rec[4]].append((rec[2], rec[3]))
    out = []
    for i, (name, tid, a, b, parent, root, counts) in enumerate(log):
        if not b:
            continue
        if counts:
            counts = {k: [_total(v)] for k, v in counts.items()}
            log[i][6] = counts          # read once: keep the sums
        covered, edge = 0, a
        for c0, c1 in sorted(children.get(i, ())):
            c0, c1 = max(c0, edge), min(c1, b)
            if c1 > c0:
                covered += c1 - c0
                edge = c1
        out.append(SpanRecord(i, name, tid, a, b, parent, root,
                              {k: v[0] for k, v in (counts or {}).items()},
                              b - a - covered))
    return out


def dropped() -> int:
    """Spans not recorded because the record was full."""
    return _dropped


def reset() -> None:
    """Empty the span record (spans still open are dropped)."""
    global _dropped
    with _lock:
        _log.clear()
        _open.clear()
        _dropped = 0


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
        """Time the block as phase ``name`` (also a span of that name).
        On exit the CUDA ``device`` is synchronized (every CUDA device the
        process has used when ``device`` is None; nothing when it is a CPU
        device)."""
        t0 = time.perf_counter()
        with span(name):
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


def _add_span_track(path: str, recs: List[SpanRecord]) -> None:
    """Append ``recs`` to the Chrome trace at ``path`` as complete events
    of process SPAN_TRACK_PID ("pyseqm_tpu_torch spans"), one thread per
    span thread, on the trace's own time base."""
    with open(path) as fh:
        trace = json.load(fh)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_TRACK_PID,
                   "tid": 0, "args": {"name": "pyseqm_tpu_torch spans"}})
    for tid in sorted({s.thread for s in recs}):
        events.append({"ph": "M", "name": "thread_name",
                       "pid": SPAN_TRACK_PID, "tid": tid,
                       "args": {"name": f"thread {tid}"}})
    for s in recs:
        events.append({"ph": "X", "cat": "span", "name": s.name,
                       "pid": SPAN_TRACK_PID, "tid": s.thread,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"index": s.index, "parent": s.parent,
                                "root": s.root, "self_us": s.self_ns / 1e3,
                                **s.counts}})
    with open(path, "w") as fh:
        json.dump(trace, fh)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Record a torch.profiler trace (CPU and, with a GPU, CUDA activity)
    and write it to ``logdir`` as a Chrome trace, with the package's spans
    of the session as a track of their own; yields the profiler, whose
    ``key_averages()`` give the kernel-level breakdown."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_span_track(path, [s for s in spans() if s.start_ns >= t0])
