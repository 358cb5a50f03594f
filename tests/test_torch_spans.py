"""The port's span record (``pyseqm_tpu_torch/utils/timing.py``) on the
CPU: nothing recorded without a profiler; under torch.profiler one XL
step and one single-point force on four golden small organics record the
layer spans with their parents, request ids and counts, on the
profiler's own clock; the SCF's counts; K1's iteration count against the
plain purifier; the span track of ``profiler_trace``'s Chrome trace."""
import bisect
import json
import math
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pyseqm_tpu_torch as pt
from pyseqm_tpu_torch.drivers.md import MDConfig
from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
from pyseqm_tpu_torch.ops.density import sp2, sp2_input
from pyseqm_tpu_torch.ops.eigh_kernel import (eigh_batched_checked,
                                              eigh_jacobi_reference)
from pyseqm_tpu_torch.ops.sp2_kernel import sp2_purify_reference
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.system import make_system
from pyseqm_tpu_torch.utils import timing

NMOL = 4
SP2_EPS = 1.0e-4
POLISH = 2
XL_NAMES = {"md.step", "model.force", "system", "integrals", "fock",
            "density", "energy", "backward"}
FORCE_NAMES = {"model.force", "system", "integrals", "scf", "scf.read",
               "fock", "density", "energy", "backward"}


def _batch():
    g = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "am1_batch96.npz"))
    sp, co = g["species"][:NMOL], g["coordinates"][:NMOL]
    return (torch.tensor(sp), torch.tensor(co, dtype=torch.float32),
            pt.packed_heavy_count(sp))


def _profiled(fn):
    """(fn(), the spans it recorded, the profiler) under torch.profiler."""
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    recs = timing.spans()
    timing.reset()
    return out, recs, prof


@pytest.fixture(scope="module")
def xl():
    torch.set_num_threads(1)
    sp, co, K = _batch()
    const, tables, cfg = pt.build(
        "AM1", dtype=torch.float32, device="cpu",
        scf=SCFConfig(eps=1.0e-5, converger=(2,), use_sp2=True,
                      sp2_eps=SP2_EPS, pack_heavy=K))
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
    state = md.initialize(sp, co, velocities=torch.zeros_like(co),
                          initial_force=False)
    _, recs, prof = _profiled(lambda: md.step(sp, state))
    return dict(md=md, sp=sp, state=state, recs=recs, prof=prof)


@pytest.fixture(scope="module")
def single_point():
    torch.set_num_threads(1)
    sp, co, K = _batch()
    # float64: the eigensolves are torch.linalg.eigh's (quick on the CPU)
    const, tables, cfg = pt.build(
        "AM1", dtype=torch.float64, device="cpu",
        scf=SCFConfig(eps=1.0e-8, converger=(2,), pack_heavy=K,
                      polish_iters=POLISH))
    co = co.double()
    (f, out), recs, prof = _profiled(
        lambda: pt.force(const, tables, cfg, sp, co))
    return dict(const=const, tables=tables, cfg=cfg, sp=sp, co=co, K=K,
                out=out, recs=recs, prof=prof)


def _by_name(recs):
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    return by


def test_spans_off_record_nothing(xl):
    timing.reset()
    st = xl["md"].step(xl["sp"], xl["state"])
    timing.count("molecules", 1)
    with timing.Timing().phase("phase", "cpu"):
        pass
    assert st[1].Epot.shape == (NMOL,)
    assert not timing.tracing()
    assert timing.spans() == [] and timing.dropped() == 0


def test_xl_step_spans(xl):
    recs = xl["recs"]
    by = _by_name(recs)
    assert set(by) == XL_NAMES
    (step,) = by["md.step"]
    (force,) = by["model.force"]
    assert step.parent == -1 and step.root == step.index
    assert force.parent == step.index
    assert all(r.root == step.index for r in recs)
    for name in XL_NAMES - {"md.step", "model.force"}:
        assert all(r.parent == force.index for r in by[name]), name
    assert force.counts == {"molecules": NMOL}
    (dens,) = by["density"]
    assert dens.counts["molecules"] == NMOL
    assert dens.counts["sp2_iterations"] >= NMOL
    for r in recs:
        assert 0 <= r.self_ns <= r.end_ns - r.start_ns
    covered = sum(r.end_ns - r.start_ns for r in recs
                  if r.parent == force.index)
    assert force.self_ns == force.end_ns - force.start_ns - covered


def test_force_spans_and_scf_counts(single_point):
    recs = single_point["recs"]
    by = _by_name(recs)
    assert set(by) == FORCE_NAMES
    (force,) = by["model.force"]
    (scf,) = by["scf"]
    assert force.parent == -1
    assert all(r.root == force.index for r in recs)
    assert scf.parent == force.index
    in_scf = [r for r in recs if r.parent == scf.index]
    solves = [r for r in in_scf if r.name == "density"]
    reads = [r for r in in_scf if r.name == "scf.read"]
    builds = [r for r in in_scf if r.name == "fock"]
    assert {r.name for r in in_scf} == {"fock", "density", "scf.read"}
    c = scf.counts
    # one eigensolve per iteration, polish included; the loop reads the
    # flags before its first chunk of 4 and after each chunk
    assert c["polish"] == POLISH
    assert c["iterations"] + c["polish"] == len(solves)
    assert c["reads"] == len(reads) == math.ceil(c["iterations"] / 4) + 1
    assert len(builds) == 1 + len(solves)
    # the final Fock build after the SCF, and the energy terms
    assert [r.parent for r in by["fock"] if r.parent != scf.index] == \
        [force.index]
    assert all(r.counts == {"molecules": NMOL} for r in solves)


def test_eigh_sweeps_count_k2_work():
    """K2's count is the plain Jacobi solver's per-molecule sweeps, added
    to the innermost open span."""
    A = torch.randn(NMOL, 16, 16, generator=torch.Generator().manual_seed(3))
    A = A + A.transpose(1, 2)

    def solve():
        with timing.span("density"):
            return eigh_batched_checked(A)
    _, recs, _ = _profiled(solve)
    (dens,) = recs
    sweeps = eigh_jacobi_reference(A, return_sweeps=True)[-1]
    assert dens.counts == {"eigh_sweeps": int(sweeps.sum())}
    assert int(sweeps.min()) >= 1


@pytest.mark.parametrize("which", ["xl", "single_point"])
def test_spans_enclose_their_cpu_ops(which, request):
    """The spans and the profiler's events share a clock: every op that
    starts inside a span on its thread ends inside it."""
    run = request.getfixturevalue(which)
    ops = sorted((e.start_ns(), e.end_ns(), e.device_resource_id(),
                  e.name())
                 for e in run["prof"].profiler.kineto_results.events()
                 if e.name().startswith("aten::"))
    starts = [o[0] for o in ops]
    inside = {}
    for r in run["recs"]:
        for a, b, tid, name in ops[bisect.bisect_left(starts, r.start_ns):
                                   bisect.bisect_right(starts, r.end_ns)]:
            if tid == r.thread:
                assert b <= r.end_ns, (r.name, name)
                inside[r.name] = inside.get(r.name, 0) + 1
    for name in ("integrals", "fock", "density", "energy", "backward"):
        assert inside.get(name, 0) > 0, name


def test_sp2_iterations_count_k1_work(single_point):
    """The density span's sp2_iterations count is the plain purifier's
    per-molecule iteration count on the same input."""
    s = single_point
    const = pt.make_constants(dtype=torch.float32, device="cpu")
    sys_ = make_system(const, s["sp"], s["co"].float(), None,
                       heavy_count=s["K"])
    F = s["out"].F.float()
    _, recs, _ = _profiled(lambda: sp2(sys_, F, SP2_EPS,
                                       pack_heavy=s["K"]))
    (dens,) = recs
    a0, nocc, _ = sp2_input(sys_, F, s["K"])
    _, iters = sp2_purify_reference(a0, nocc, max(SP2_EPS, 1.0e-5),
                                    return_iters=True)
    assert dens.counts == {"molecules": NMOL,
                           "sp2_iterations": int(iters.sum())}


def test_profiler_trace_writes_span_track(single_point, tmp_path):
    s = single_point
    timing.reset()
    with timing.profiler_trace(str(tmp_path)):
        pt.force(s["const"], s["tables"], s["cfg"], s["sp"], s["co"])
    with open(os.path.join(tmp_path, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    track = [e for e in events if e.get("pid") == timing.SPAN_TRACK_PID
             and e.get("ph") == "X"]
    assert {e["name"] for e in track} == FORCE_NAMES
    (force,) = [e for e in track if e["name"] == "model.force"]
    assert force["args"]["molecules"] == NMOL
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("ph") == "X"]
    inside = [e for e in ops if force["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= force["ts"] + force["dur"]]
    assert len(inside) > 0.9 * len(ops)
    timing.reset()


@pytest.mark.parametrize("learned", ["callable", "mapping", None])
def test_learned_span(single_point, learned):
    """A learned callable's forward is the span ``learned`` inside
    ``system``, counting molecules and atom slots; a mapping of values,
    or no model, opens none."""
    s = single_point
    zeta_s = s["tables"]["zeta_s"]
    arg = {"callable": lambda species, x: {
        "zeta_s": zeta_s[species] * (1.0 + 0.01 * torch.sin(x).sum(-1))},
        "mapping": {"zeta_s": zeta_s[s["sp"]]}, None: None}[learned]
    _, recs, _ = _profiled(lambda: pt.force(s["const"], s["tables"],
                                            s["cfg"], s["sp"], s["co"],
                                            learned=arg))
    by = _by_name(recs)
    if learned != "callable":
        assert set(by) == FORCE_NAMES
        return
    assert set(by) == FORCE_NAMES | {"learned"}
    (lr,) = by["learned"]
    (system,) = by["system"]
    assert lr.parent == system.index and lr.root == system.root
    assert system.start_ns <= lr.start_ns <= lr.end_ns <= system.end_ns
    assert lr.counts == {"molecules": NMOL, "atoms": s["sp"].numel()}
