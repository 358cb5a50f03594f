"""The benchmark's readers of the port's span record
(``portbench/pbench/spans.py`` and its per-layer metrics) on a synthetic
traced session: kernels charged by correlation id and launch time to the
innermost span, an autograd-engine launch to ``backward`` (or to a span
opened on the engine's thread), idle gaps and the SCF's reads, the
steps of a second session left out, the overlap kernel's share of the
integrals spans' cells, and every reader None where the program keeps no
span record."""
import os
import sys

import pytest

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from pbench import registry, spans, trace  # noqa: E402
from pyseqm_tpu_torch.utils.timing import SpanRecord  # noqa: E402

MAIN, ENGINE = 101, 102          # native thread ids of the spans
T_MAIN, T_ENGINE = 1, 2          # the profiler's thread ids of launches
MD = ("driver_span_ms.md", "models_span_ms.md", "integrals_span_ms.md",
      "fock_span_ms.md", "density_span_ms.md", "energy_span_ms.md",
      "sp2_iterations.md", "integrals_idle_ms.md",
      "overlap_kernel_share.md", "learned_span_ms.md",
      "learned_roofline.md")
SP = ("integrals_span_ms.sp", "fock_span_ms.sp", "density_span_ms.sp",
      "eigh_sweeps.sp", "scf_reads.sp", "scf_read_idle_ms.sp",
      "overlap_kernel_share.sp")


def rec(index, name, start, end, parent=-1, root=None, thread=MAIN,
        counts=None):
    return SpanRecord(index, name, thread, start, end, parent,
                      index if root is None else root, counts or {}, 0)


def session(kernels, engine=(), units=1):
    """A trace.Session of kernels (host launch time, launching thread,
    device start, device end); ``engine``: the engine thread's
    evaluate_function intervals."""
    s = trace.Session.__new__(trace.Session)
    s.units, s.window_s = units, 1.0
    s.device, s.launches, s.ops = [], [], {}
    for corr, (t, tid, a, b) in enumerate(kernels, start=1):
        op = 1000 + corr
        s.launches.append((t, tid, corr, op))
        s.ops[op] = (t - 1, tid, "aten::op")
        s.device.append((a, b, f"kernel{corr}", corr, op))
    s.device.sort()
    s.engine = trace._Intervals({T_ENGINE: list(engine)})
    s.frames, s.spans = {}, []
    return s


def read_all(names, data, records, monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: records)
    return {n: registry.reader(BENCH, n)(data) for n in names}


# one XL step, 0..1000 on the host: system, integrals, fock, density,
# energy, backward inside model.force inside md.step; then a second
# session's step at 5000
XL_SPANS = [
    rec(0, "md.step", 0, 1000),
    rec(1, "model.force", 10, 900, 0, 0, counts={"molecules": 4}),
    rec(2, "system", 20, 50, 1, 0),
    rec(3, "integrals", 50, 300, 1, 0),
    rec(4, "fock", 300, 400, 1, 0),
    rec(5, "density", 400, 500, 1, 0,
        counts={"molecules": 4, "sp2_iterations": 70}),
    rec(6, "energy", 500, 600, 1, 0),
    rec(7, "backward", 600, 880, 1, 0),
    rec(8, "md.step", 5000, 6000),
]


def test_xl_readers_attribute_by_launch(monkeypatch):
    kernels = [
        (5, T_MAIN, 1000, 1010),       # md.step self
        (30, T_MAIN, 1010, 1030),      # system
        (100, T_MAIN, 1030, 1130),     # integrals
        (200, T_MAIN, 1200, 1300),     # integrals, after a 70 ns gap
        (350, T_MAIN, 1300, 1340),     # fock
        (450, T_MAIN, 1340, 1400),     # density
        (550, T_MAIN, 1400, 1420),     # energy
        (700, T_ENGINE, 1420, 1520),   # the engine's: backward
        (890, T_MAIN, 1520, 1530),     # model.force self
        (950, T_MAIN, 1530, 1535),     # md.step self
    ]
    sess = session(kernels, engine=[(650, 750)])
    data = {"a": sess}
    got = read_all(MD, data, XL_SPANS, monkeypatch)
    assert got["driver_span_ms.md"] == pytest.approx(15e-6)
    assert got["models_span_ms.md"] == pytest.approx(30e-6)
    assert got["integrals_span_ms.md"] == pytest.approx(200e-6)
    assert got["fock_span_ms.md"] == pytest.approx(40e-6)
    assert got["density_span_ms.md"] == pytest.approx(60e-6)
    assert got["energy_span_ms.md"] == pytest.approx(20e-6)
    assert got["sp2_iterations.md"] == pytest.approx(17.5)
    assert got["integrals_idle_ms.md"] == pytest.approx(70e-6)
    # no learned model, no learned span: its readers find nothing
    assert got["learned_span_ms.md"] is None
    assert got["learned_roofline.md"] is None
    att = spans.attribution(data)
    assert att.roots == [0]
    assert att.self_ns["backward"] == 100
    assert att.attributed_ns == att.total_ns == 465
    table = att.table()
    assert table["total"]["attributed_share"] == 1.0
    assert table["integrals"]["idle_ms"] == pytest.approx(70e-6)


def test_engine_thread_span_takes_its_launches(monkeypatch):
    """A launch of the engine's thread goes to a span open on another
    thread than the steps' (a Fock build inside a backward), else to
    the steps' thread's innermost span; a main-thread launch inside the
    backward's time stays on the main thread's span."""
    recs = [rec(0, "model.force", 0, 1000),
            rec(1, "backward", 100, 900, 0, 0),
            rec(2, "fock", 200, 300, 1, 0, thread=ENGINE)]
    kernels = [(50, T_MAIN, 10, 20), (250, T_ENGINE, 20, 40),
               (400, T_ENGINE, 40, 70), (260, T_MAIN, 70, 71)]
    att = spans.Attribution(session(kernels, engine=[(240, 500)]), recs)
    assert dict(att.self_ns) == {"model.force": 10, "fock": 20,
                                 "backward": 31}


def test_sp_readers_reads_and_sync_cost(monkeypatch):
    recs = [
        rec(0, "model.force", 0, 1000, counts={"molecules": 8}),
        rec(1, "integrals", 10, 100, 0, 0),
        rec(2, "scf", 100, 800, 0, 0,
            counts={"iterations": 4, "polish": 2, "reads": 2}),
        rec(3, "scf.read", 110, 150, 2, 0),
        rec(4, "density", 150, 300, 2, 0,
            counts={"molecules": 8, "eigh_sweeps": 40}),
        rec(5, "scf.read", 300, 320, 2, 0),
        rec(6, "density", 320, 400, 2, 0,
            counts={"molecules": 8, "eigh_sweeps": 48}),
        rec(7, "fock", 800, 850, 0, 0),
    ]
    kernels = [
        (20, T_MAIN, 20, 100),       # integrals
        (115, T_MAIN, 100, 110),     # the read's reduction
        (200, T_MAIN, 175, 250),     # density: 25 ns after the read
        (310, T_MAIN, 250, 260),     # the second read
        (330, T_MAIN, 330, 400),     # density: 10 ns after the read
        (820, T_MAIN, 820, 900),     # fock
    ]
    data = {"a": session(kernels, units=2)}
    got = read_all(SP, data, recs, monkeypatch)
    assert got["integrals_span_ms.sp"] == pytest.approx(40e-6)
    assert got["density_span_ms.sp"] == pytest.approx(72.5e-6)
    assert got["fock_span_ms.sp"] == pytest.approx(40e-6)
    assert got["eigh_sweeps.sp"] == pytest.approx(5.5)
    assert got["scf_reads.sp"] == pytest.approx(1.0)
    assert got["scf_read_idle_ms.sp"] == pytest.approx(17.5e-6)


def test_readers_none_without_a_span_record(monkeypatch):
    sess = session([(5, T_MAIN, 10, 20)])
    for records in (None, [], [rec(0, "md.step", 5000, 6000)]):
        got = read_all(MD + SP, {"a": sess}, records, monkeypatch)
        assert got == {n: None for n in MD + SP}, records
    # the program's own record, empty outside a profiler session
    monkeypatch.undo()
    from pyseqm_tpu_torch.utils import timing
    timing.reset()
    assert spans.program_spans() is None
    assert registry.reader(BENCH, "fock_span_ms.md")({"a": sess}) is None


@pytest.mark.parametrize("metric", ["overlap_kernel_share.md",
                                    "overlap_kernel_share.sp"])
@pytest.mark.parametrize("counts,share", [
    ([{"overlap.kernel_cells": 52}, {"overlap.kernel_cells": 48}], 100.0),
    ([{"overlap.plain_cells": 52}, {"overlap.plain_cells": 48}], 0.0),
    ([{"overlap.kernel_cells": 30}, {"overlap.plain_cells": 10}], 75.0),
    ([{}, {}], None),
])
def test_overlap_kernel_share(metric, counts, share, monkeypatch):
    """The share of overlap cells the kernel computed, over the integrals
    spans of the traced units; absent where no span counted a cell (the
    program before the kernel)."""
    recs = [rec(0, "model.force", 0, 1000, counts={"molecules": 8}),
            rec(1, "integrals", 10, 100, 0, 0, counts=counts[0]),
            rec(2, "integrals", 200, 300, 0, 0, counts=counts[1]),
            rec(3, "fock", 300, 400, 0, 0,
                counts={"overlap.plain_cells": 7})]
    kernels = [(20, T_MAIN, 20, 100), (250, T_MAIN, 250, 260),
               (350, T_MAIN, 350, 360)]
    got = read_all([metric], {"a": session(kernels)}, recs, monkeypatch)
    assert got[metric] == (None if share is None else pytest.approx(share))


def test_learned_readers(monkeypatch):
    """The learned network's self device time per step, and its forward's
    operations (from the published widths and the span's counts) at the
    FP32 peak over that time; the network's time leaves ``system``'s."""
    from pbench import hipnn_ops, roofline
    recs = [rec(0, "md.step", 0, 1000),
            rec(1, "model.force", 10, 900, 0, 0, counts={"molecules": 4}),
            rec(2, "system", 20, 80, 1, 0),
            rec(3, "learned", 30, 70, 2, 0,
                counts={"molecules": 4, "atoms": 32}),
            rec(4, "integrals", 80, 300, 1, 0),
            rec(5, "md.step", 2000, 3000),
            rec(6, "learned", 2100, 2200, 5, 5,
                counts={"molecules": 4, "atoms": 32})]
    kernels = [(25, T_MAIN, 0, 10_000),            # system
               (40, T_MAIN, 10_000, 410_000),      # learned
               (60, T_MAIN, 410_000, 610_000),     # learned
               (100, T_MAIN, 610_000, 620_000),    # integrals
               (2150, T_MAIN, 700_000, 1_300_000)]  # learned, 2nd step
    data = {"a": session(kernels, units=2)}
    got = read_all(["learned_span_ms.md", "learned_roofline.md",
                    "models_span_ms.md"], data, recs, monkeypatch)
    assert got["learned_span_ms.md"] == pytest.approx(0.6)
    assert got["models_span_ms.md"] == pytest.approx(5e-3)
    flops = 2 * hipnn_ops.forward_flops(4, 32)
    assert flops == 2 * 4 * 3_935_296
    assert got["learned_roofline.md"] == pytest.approx(
        100.0 * flops / roofline.PEAK_FP32 / 1.2e-3)
    assert got["learned_roofline.md"] == pytest.approx(0.03916, abs=1e-5)
