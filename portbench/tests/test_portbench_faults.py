"""A run with the timed path broken underneath comes out not correct: the
harness is driven past its look for a card, on the CPU at a small size,
with each fault the cells can have planted in the port's calls after
set-up.  The unbroken run of the same size comes out correct."""
import dataclasses

import pytest
import torch

from _harness import run_cpu
from pbench import cells, program


def test_unbroken_runs_are_correct():
    assert run_cpu("xl-small")["correct"] is True
    assert run_cpu("sp-small")["correct"] is True


def test_xl_step_that_returns_its_state_unchanged():
    def hook(cell):
        cell.md.step = lambda species, state, charges=None: (state, cell.obs)
    res = run_cpu("xl-small", hook=hook)
    assert res["correct"] is False
    assert res["checks"]["state_err"]["value"] > \
        res["checks"]["state_err"]["limit"]


def test_xl_force_altered_where_produced():
    def hook(cell):
        step = cell.md.step

        def bad(species, state, charges=None):
            st, obs = step(species, state, charges)
            acc = st.acc.clone()
            acc[0, 0, 0] += 0.05                  # ~5 eV/A on a hydrogen
            return dataclasses.replace(st, acc=acc), obs
        cell.md.step = bad
    res = run_cpu("xl-small", hook=hook)
    assert res["correct"] is False
    assert res["checks"]["force_err"]["value"] > \
        res["checks"]["force_err"]["limit"]


def test_xl_density_altered_where_produced():
    def hook(cell):
        step = cell.md.step

        def bad(species, state, charges=None):
            st, obs = step(species, state, charges)
            return dataclasses.replace(st, D=st.D * 1.01), obs
        cell.md.step = bad
    assert run_cpu("xl-small", hook=hook)["correct"] is False


def test_single_point_answer_altered_where_produced(monkeypatch):
    force = program.force

    def bad(*args):
        f, out = force(*args)
        return f + 0.05, out._replace(Hf=out.Hf + 0.01)
    monkeypatch.setattr(program, "force", bad)
    res = run_cpu("sp-small")
    assert res["correct"] is False
    assert res["checks"]["force_err"]["value"] > \
        res["checks"]["force_err"]["limit"]


def test_single_point_that_returns_a_stale_answer(monkeypatch):
    force, first = program.force, []

    def stale(*args):
        if not first:
            first.append(force(*args))
        return first[0]
    monkeypatch.setattr(program, "force", stale)
    assert run_cpu("sp-small")["correct"] is False


def test_unconverged_molecules_fail_the_run(monkeypatch):
    force = program.force

    def flagged(*args):
        f, out = force(*args)
        nc = torch.zeros_like(out.notconverged)
        nc[0] = True
        return f, out._replace(notconverged=nc)
    monkeypatch.setattr(program, "force", flagged)
    res = run_cpu("sp-small")
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("field", ["force", "energy"])
def test_non_finite_molecule_outside_the_sample_fails_the_run(
        monkeypatch, field):
    """A NaN in a molecule that the sampled comparison never reads, with
    its SCF flagged converged, still makes the run not correct."""
    monkeypatch.setattr(cells, "REQUEST_SAMPLE", 4)
    monkeypatch.setattr(cells.SPCell, "pick",
                        lambda self, r: torch.arange(4, device=self.device))
    force = program.force

    def planted(*args):
        f, out = force(*args)
        if field == "force":
            f = f.clone()
            f[-1, 0, 0] = float("nan")
            return f, out
        Hf = out.Hf.clone()
        Hf[-1] = float("nan")
        return f, out._replace(Hf=Hf)
    monkeypatch.setattr(program, "force", planted)
    res = run_cpu("sp-small")
    assert res["correct"] is False and res["failed"] > 0
    for name in ("force_err", "energy_err", "density_err"):
        assert res["checks"][name]["value"] <= res["checks"][name]["limit"]
