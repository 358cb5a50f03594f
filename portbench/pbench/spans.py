"""The program's own span record read against a traced session: each
device activity is charged to the program span that was open on the host
when it was launched.

``pyseqm_tpu_torch.utils.timing`` records a span at each of the port's
layer boundaries while a torch.profiler session records (``md.step``,
``model.force``, ``system``, ``integrals``, ``scf``, ``scf.read``,
``fock``, ``density``, ``energy``, ``backward``), with start and end on
the profiler's clock, its parent, its root (one step or one request) and
its counts.  Only the roots that hold launches of session ``a`` are read:
the record also holds session ``b``'s step.

Attribution: a kernel is matched to its launch by correlation id (a copy
or a memset, which no launch call issued, to the op that issued it) and
charged to the innermost span open at the launch's host time on the
launch's own thread.  The launches of the thread that runs the steps are
looked up among the spans of the roots' thread; a launch of another
thread (the autograd engine's) among the spans opened on other threads,
and where none of them is open, among the roots' thread's: a force
backward's kernels are charged to ``backward``.  By self time (innermost
span), so the spans' device times sum to the session's attributed device
time.

Every function returns None when the program keeps no span record (a
checkout before it) or the record holds nothing of the session.
"""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, List, Optional


def program_spans() -> Optional[list]:
    """The program's span records, or None where the program has none."""
    try:
        from pyseqm_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "spans", None)
    if read is None:
        return None
    return read() or None


class _Nest:
    """The innermost of a set of spans open at a time (properly nested per
    thread; several threads' spans are looked up one thread at a time)."""

    def __init__(self, recs):
        self.recs = {r.index: r for r in recs}
        by_thread = defaultdict(list)
        for r in recs:
            by_thread[r.thread].append(r)
        self.threads = {}
        for tid, rs in by_thread.items():
            events = sorted([(r.start_ns, 1, r.index) for r in rs]
                            + [(r.end_ns, 0, r.index) for r in rs])
            times, labels, stack = [], [], []
            for t, opening, idx in events:
                if opening:
                    stack.append(idx)
                elif idx in stack:
                    stack.remove(idx)
                times.append(t)
                labels.append(stack[-1] if stack else None)
            self.threads[tid] = (times, labels)

    def at(self, t: int) -> Optional[int]:
        """The index of the innermost span open at t (the latest opened
        where several threads have one open)."""
        best = None
        for times, labels in self.threads.values():
            i = bisect.bisect_right(times, t) - 1
            idx = labels[i] if i >= 0 else None
            if idx is not None and (best is None or self.recs[idx].start_ns
                                    > self.recs[best].start_ns):
                best = idx
        return best


class Attribution:
    """Session ``a``'s device activity charged to the program's spans."""

    def __init__(self, sess, records):
        self.units = sess.units
        launch_times = sorted(t for t, _, _, _ in sess.launches)
        lo, hi = (launch_times[0], launch_times[-1]) if launch_times else \
            (None, None)
        roots = {r.index for r in records if r.parent < 0 and lo is not None
                 and r.start_ns <= hi and r.end_ns >= lo}
        self.spans = {r.index: r for r in records if r.root in roots}
        self.roots = sorted(roots)
        root_thread = Counter(self.spans[i].thread for i in roots)
        main = root_thread.most_common(1)[0][0] if root_thread else None
        own = [r for r in self.spans.values() if r.thread == main]
        other = [r for r in self.spans.values() if r.thread != main]
        self._main, self._other = _Nest(own), _Nest(other)
        # the launching thread of the steps: most forward launches
        fwd = Counter(k for t, k, _, linked in sess.launches
                      if not sess.in_backward(linked))
        self._main_tid = fwd.most_common(1)[0][0] if fwd else None
        launch = {corr: (t, k) for t, k, corr, _ in sess.launches}
        self.self_ns: Dict[str, int] = defaultdict(int)
        self.total_ns = 0
        self.attributed_ns = 0
        starts: List[int] = []
        owner: List[Optional[int]] = []
        for a, b, _, corr, linked in sess.device:
            self.total_ns += b - a
            host = launch.get(corr)
            if host is None and linked in sess.ops:
                host = sess.ops[linked][:2]
            idx = None if host is None else self.span_at(*host)
            starts.append(a)
            owner.append(idx)
            if idx is not None:
                self.self_ns[self.spans[idx].name] += b - a
                self.attributed_ns += b - a
        self._starts, self._owner = starts, owner
        _, self._merged = sess.busy()
        self._merged_starts = [a for a, _ in self._merged]

    def span_at(self, t: int, thread) -> Optional[int]:
        """The innermost span open at host time t for a launch of
        ``thread``."""
        if thread != self._main_tid:
            idx = self._other.at(t)
            if idx is not None:
                return idx
        return self._main.at(t)

    def named(self, name: str) -> List:
        return [r for r in self.spans.values() if r.name == name]

    def device_ms(self, *names: str) -> Optional[float]:
        """Device ms per unit charged to spans of these names (self)."""
        if not any(self.named(n) for n in names):
            return None
        return 1e-6 * sum(self.self_ns[n] for n in names) / self.units

    def idle_ns(self) -> Dict[str, int]:
        """Idle device ns between busy stretches, by the span that launched
        the activity ending each gap ("outside" where none did)."""
        by = defaultdict(int)
        for (_, b0), (a1, _) in zip(self._merged, self._merged[1:]):
            i = bisect.bisect_left(self._starts, a1)
            idx = self._owner[i] if i < len(self._starts) else None
            name = "outside" if idx is None else self.spans[idx].name
            by[name] += a1 - b0
        return by

    def idle_after(self, t: int) -> int:
        """Idle device ns from host time t to the first activity that
        starts after it."""
        i = bisect.bisect_left(self._starts, t)
        if i >= len(self._starts):
            return 0
        nxt = self._starts[i]
        j = bisect.bisect_right(self._merged_starts, t) - 1
        busy_to = self._merged[j][1] if j >= 0 else t
        return max(0, nxt - max(t, busy_to))

    def counts(self, name: str, key: str) -> List:
        """(value of count ``key``, its span) over spans ``name`` that
        counted it."""
        return [(r.counts[key], r) for r in self.named(name)
                if key in r.counts]

    def per_molecule(self, key: str) -> Optional[float]:
        """Mean per molecule of a ``density`` count over the solves that
        counted it."""
        got = self.counts("density", key)
        mols = sum(r.counts.get("molecules", 0) for _, r in got)
        return sum(v for v, _ in got) / mols if mols else None

    def table(self) -> Dict[str, Dict[str, float]]:
        """Device and idle ms per unit of each span name, with the
        session's totals and the attributed share."""
        idle = self.idle_ns()
        names = sorted(set(self.self_ns) | set(idle))
        out = {n: {"device_ms": 1e-6 * self.self_ns.get(n, 0) / self.units,
                   "idle_ms": 1e-6 * idle.get(n, 0) / self.units}
               for n in names}
        out["total"] = {"device_ms": 1e-6 * self.total_ns / self.units,
                        "idle_ms": 1e-6 * sum(idle.values()) / self.units,
                        "attributed_share": (self.attributed_ns
                                             / self.total_ns
                                             if self.total_ns else None)}
        return out


def attribution(data: dict) -> Optional[Attribution]:
    """The attribution of the traced run's session ``a`` (made once per
    run and kept in ``data``), or None with nothing to read."""
    if "program_spans" not in data:
        records = program_spans()
        sess = data.get("a")
        att = None
        if records and sess is not None and sess.device:
            att = Attribution(sess, records)
            if not att.roots:
                att = None
        data["program_spans"] = att
    return data["program_spans"]


def device_ms(data: dict, *names: str) -> Optional[float]:
    att = attribution(data)
    return None if att is None else att.device_ms(*names)
