"""One run of one cell: set-up, the timed (or traced) window and the
correctness check, for the two kinds of traffic the benchmark has here.

A cell is put together from parts found by name (``registry``): its
configuration (method, dtype, layout, molecules: ``MOLECULES`` by name,
``alkane_carbons``, or a ``molecules/<g>.json`` file; a learned-parameter
model ``learned/<m>.py`` with its reference ``reference/learned/<m>.py``),
its traffic (``traffic/<t>.json``, whose ``kind`` picks the class: ``KINDS``
below, else ``kinds/<kind>.py``'s ``Cell``, a subclass of ``Cell``), its
limits and its metric readers.  Set-up refuses molecules with an element
that the mass table, the method's tables or the parameter model lacks.
A learned model is handed to the port's ``XLBOMD`` and ``force`` and, its
plain side, to the reference's XL force and single points, the control's
at float32; without one, both are called as they always were.

``xlbomd``: a closed loop of ``XLBOMD.step`` calls on one batch after the
bootstrap SCF and the warm-up steps.  ``single_point``: a closed loop of
one client, each request a ``force`` call (SCF energy and forces) on a
fresh geometry batch drawn from the seed.

What decides ``correct`` (the reference is the frozen plain copy under
``reference/``, float64):

- xlbomd, from the program's own state (the reference can only follow a
  trajectory step by step): the window's last step (force, energy, SP2
  density at its coordinates and density field), one more step of the
  program after the window (the propagation of the density field and the
  velocity Verlet update beside force, energy and density), and the start
  by itself (the bootstrap SCF's force, energy and density on a sample of
  molecules drawn from the seed);
- single_point: a sample of each request's molecules drawn from the seed
  (force, energy, density), the geometries generated again; every
  molecule of every request counts as failed where its SCF did not
  converge or its force or energy is not finite (counted on the card,
  read once after the window).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import inputs, program, trace
from reference.check import Reference, Worst, max_abs, method_elements
from reference.seqm.ops.density import packed_solver_size

# sizes of the check: bootstrap molecules, sampled molecules per request,
# and pairs per reference block (a block of the float64 reference holds
# about 13 GB of the card at 2M pairs)
BOOT_SAMPLE = 2048
REQUEST_SAMPLE = 512
BLOCK_PAIRS = 2_000_000
KE_SCALE = 1.0364270099032438e2


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _blocks(n: int, size: int):
    for a in range(0, n, size):
        yield slice(a, min(n, a + size))


class Cell:
    """State shared by both kinds: inputs, the program, the reference."""

    def __init__(self, spec: dict, seed: int, device, tracing: bool):
        self.spec = spec
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.tracing = tracing
        self.batch = int(self.traffic["batch"])
        self.dtype = getattr(torch, self.config["dtype"])
        sp, base = inputs.base_batch(self.config, self.batch,
                                     spec["bench_dir"])
        method = self.config["method"]
        covered = {"the mass table": inputs.MASS,
                   f"the {method} tables": method_elements(method)}
        self.learned_model = spec.get("learned")
        if self.learned_model is not None:
            covered["the parameter model " + self.learned_model["name"]] = \
                self.learned_model["elements"]
        inputs.check_elements(sp, covered)
        self.learned = (None if self.learned_model is None else
                        self.learned_model["program"](self.device,
                                                      self.dtype))
        # Na..Cl: the port and the reference take row 3 only when told
        self.row3 = bool((sp > 10).any())
        self.species_np = sp
        self.species = torch.as_tensor(sp, device=self.device)
        self.base = torch.as_tensor(base, dtype=self.dtype,
                                    device=self.device)
        self.A = sp.shape[1]
        self.const, self.tables, self.cfg, self.K = program.build(
            self.config, self.traffic["scf"], sp, self.device, self.row3)
        self.n_solver = packed_solver_size(self.K, self.A)
        self.block = max(1, BLOCK_PAIRS // max(1, self.A * (self.A - 1) // 2))
        self.attempted = 0
        self.failed = 0

    def jitter(self):
        return float(self.config["assumed"]["jitter_angstrom"])

    def reference(self, control: bool, scf: str = "scf"):
        """The float64 reference (or the control: float32 with TF32 on)
        with the traffic's SCF settings (``scf``) or the reference's own
        SCF (``reference_scf``: exact eigensolves, a tight criterion), with
        the plain side of the learned model at the same precision."""
        dtype = torch.float32 if control else torch.float64
        lm = self.learned_model
        learned = None if lm is None else lm["reference"](self.device, dtype)
        if control:
            return Reference(self.config["method"], torch.float32,
                             self.device, self.K, self.traffic["scf"],
                             control=True, learned=learned, row3=self.row3)
        return Reference(self.config["method"], torch.float64, self.device,
                         self.K, self.traffic[scf], learned=learned,
                         row3=self.row3)

    def span(self, name):
        return trace.span(name, self.tracing)


class XLCell(Cell):
    def setup(self):
        tr = self.traffic
        gen = inputs.generator(self.seed, 0, self.device)
        self.x0 = inputs.jittered(self.species, self.base, self.jitter(), gen)
        self.v0 = inputs.velocities(
            self.species, float(self.config["assumed"]["temperature_k"]),
            self.dtype, gen)
        self.md = program.xlbomd(self.const, self.tables, self.cfg, tr,
                                 self.learned)
        with self.span("bootstrap"):
            state = self.md.initialize(self.species, self.x0,
                                       velocities=self.v0)
        pick = torch.randperm(self.batch, device=self.device,
                              generator=inputs.generator(self.seed, 1,
                                                         self.device))
        self.boot_idx = pick[:min(BOOT_SAMPLE, self.batch)]
        self.boot = {"f": self._force(state.acc, self.boot_idx),
                     "E0": state.E0[self.boot_idx].clone(),
                     "D": state.D[self.boot_idx].clone()}
        for _ in range(int(tr["warmup_steps"])):
            with self.span("step"):
                state, obs = self.md.step(self.species, state)
        self.state, self.obs = state, obs
        sync(self.device)

    def _force(self, acc, idx=None):
        """The program's force (eV/A) from its acc (A/fs^2), in float64."""
        mass = self.const.mass[self.species].double()
        mass = torch.where(self.species > 0, mass, torch.ones_like(mass))
        f = acc.double() * mass[..., None] / 0.009648532800137615
        return f if idx is None else f[idx]

    def _steps(self, n: Optional[int] = None, seconds: float = 0.0,
               events: Optional[list] = None) -> int:
        done = 0
        t0 = time.perf_counter()
        while (done < n) if n is not None else (
                time.perf_counter() - t0 < seconds):
            with self.span("step"):
                self.state, self.obs = self.md.step(self.species, self.state)
            if events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            done += 1
        return done

    def window(self, seconds: float) -> Dict[str, float]:
        cuda = self.device.type == "cuda"
        events = []
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        steps = self._steps(seconds=seconds, events=events if cuda else None)
        sync(self.device)
        wall = time.perf_counter() - t0
        self.attempted += steps * self.batch
        out = {"md_mol_steps_per_s": steps * self.batch / wall}
        if cuda:
            ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            out["md_step_ms_p90"] = float(np.percentile(ms, 90))
        return out

    def traced(self) -> dict:
        n = int(self.traffic["trace_steps"])
        a = trace.record(lambda: (self._steps(n), sync(self.device)), n)
        b = trace.record(lambda: (self._steps(1), sync(self.device)), 1,
                         frames=True)
        self.attempted += (n + 1) * self.batch
        return {"a": a, "b": b}

    def check(self, control: bool = False) -> Dict[str, float]:
        """The compared numbers against the float64 reference: the
        program's (control False) or the control's in its place."""
        st = self.state
        last = {"x": st.coordinates, "P": st.P, "D": st.D,
                "f": self._force(st.acc), "Hf": self.obs.Epot}
        prev = {"x": st.coordinates.clone(), "v": st.velocities.clone(),
                "acc": st.acc.clone(), "D": st.D.clone(), "P": st.P.clone(),
                "Pt": st.Pt.clone()}
        step = st.step
        if not control:
            # one more step of the program, past the window
            nxt, obs = self.md.step(self.species, st)
            after = {"x": nxt.coordinates, "v": nxt.velocities, "P": nxt.P,
                     "D": nxt.D, "f": self._force(nxt.acc), "Hf": obs.Epot}
            bad = ~(torch.isfinite(nxt.coordinates).all(dim=(1, 2))
                    & torch.isfinite(nxt.velocities).all(dim=(1, 2)))
            self.failed += int(bad.sum())
            del nxt, obs
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = self.reference(False)
        ctl = self.reference(True) if control else None
        k, dt = int(self.traffic["k"]), float(self.traffic["dt_fs"])
        worst, self.k1_iters = Worst(), []
        real = (self.species > 0)[..., None]
        for s in _blocks(self.batch, self.block):
            sp = self.species[s]
            # the window's last step, at its coordinates and field
            f, Hf, D, it = ref.xl_force(sp, last["x"][s], last["P"][s])
            self.k1_iters.append(it.cpu())
            if control:
                cf, cH, cD, _ = ctl.xl_force(sp, last["x"][s], last["P"][s])
            else:
                cf, cH, cD = last["f"][s], last["Hf"][s], last["D"][s]
            worst.add("force_err", max_abs(cf, f, real[s]))
            worst.add("energy_err", max_abs(cH, Hf))
            worst.add("density_err", max_abs(cD, D))
            # one step from the program's state
            blk = {n: (t[:, s] if n == "Pt" else t[s])
                   for n, t in prev.items()}
            r = ref.xl_step(sp, blk, step, k, dt)
            c = ctl.xl_step(sp, blk, step, k, dt) if control else \
                {n: t[s] for n, t in after.items()}
            worst.add("force_err", max_abs(c["f"], r["f"], real[s]))
            worst.add("energy_err", max_abs(c["Hf"], r["Hf"]))
            worst.add("density_err", max_abs(c["D"], r["D"]))
            for name in ("x", "v", "P"):
                scale = float(r[name].abs().max()) or 1.0
                worst.add("state_err", max_abs(c[name], r[name]) / scale)
            del f, Hf, D, r, c
        del ref
        self._check_boot(worst, ctl)
        return worst.values

    def _check_boot(self, worst, ctl):
        ref = self.reference(False, "reference_scf")
        idx = self.boot_idx
        sp, x, v = self.species[idx], self.x0[idx], self.v0[idx]
        for s in _blocks(len(idx), self.block):
            r = ref.single_point(sp[s], x[s])
            if ctl is not None:
                c = ctl.single_point(sp[s], x[s])
                cf, cH, cP = c["f"], c["Hf"], c["Pp"]
            else:
                mass = self.const.mass[sp[s]].double()
                Ek = (0.5 * mass[..., None] * v[s].double() ** 2
                      ).sum(dim=(1, 2)) * KE_SCALE
                cf = self.boot["f"][s]
                cH = self.boot["E0"][s].double() - Ek
                cP = self.boot["D"][s]
            worst.add("boot_force_err",
                      max_abs(cf, r["f"], (sp[s] > 0)[..., None]))
            worst.add("boot_energy_err", max_abs(cH, r["Hf"]))
            worst.add("boot_density_err", max_abs(cP, r["Pp"]))

    def trace_data(self) -> dict:
        return {"batch": self.batch,
                "cells_k3": self.batch * self.K * self.K,
                "n_solver": self.n_solver,
                "k1_iterations": torch.cat(self.k1_iters).tolist()
                if getattr(self, "k1_iters", None) else None}


class SPCell(Cell):
    def setup(self):
        self.sample = min(REQUEST_SAMPLE, self.batch)
        self.kept: List[dict] = []
        self.nc = torch.zeros((), dtype=torch.long, device=self.device)
        for r in range(int(self.traffic["warmup_requests"])):
            self._request(-1 - r, keep=False)
        sync(self.device)

    def coords(self, r: int) -> torch.Tensor:
        return inputs.jittered(self.species, self.base, self.jitter(),
                               inputs.generator(self.seed, 1000 + r,
                                                self.device))

    def pick(self, r: int) -> torch.Tensor:
        return torch.randperm(self.batch, device=self.device,
                              generator=inputs.generator(self.seed, 500 + r,
                                                         self.device)
                              )[:self.sample]

    def _request(self, r: int, keep: bool = True):
        x = self.coords(r)
        with self.span("force"):
            f, out = program.force(self.const, self.tables, self.cfg,
                                   self.species, x, self.learned)
        if keep:
            idx = self.pick(r)
            self.kept.append({"r": r, "idx": idx, "f": f[idx],
                              "Hf": out.Hf[idx], "P": out.P[idx]})
            bad = (out.notconverged | ~torch.isfinite(out.Hf)
                   | ~torch.isfinite(f).all(dim=(1, 2)))
            self.nc += bad.sum()
            self.attempted += self.batch

    def _requests(self, n: Optional[int] = None, seconds: float = 0.0) -> int:
        done = 0
        t0 = time.perf_counter()
        while (done < n) if n is not None else (
                time.perf_counter() - t0 < seconds):
            self._request(len(self.kept))
            done += 1
        return done

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        n = self._requests(seconds=seconds)
        sync(self.device)
        wall = time.perf_counter() - t0
        return {"sp_mols_per_s": n * self.batch / wall}

    def traced(self) -> dict:
        n = int(self.traffic["trace_requests"])
        k2 = program.eigh_launches()
        a = trace.record(lambda: (self._requests(n), sync(self.device)), n)
        self.k2_per_request = (program.eigh_launches() - k2) / n
        b = trace.record(lambda: (self._requests(1), sync(self.device)), 1,
                         frames=True)
        return {"a": a, "b": b}

    def check(self, control: bool = False) -> Dict[str, float]:
        self.failed += int(self.nc)
        sp_all = torch.cat([self.species[k["idx"]] for k in self.kept])
        x_all = torch.cat([self.coords(k["r"])[k["idx"]] for k in self.kept])
        prog = {n: torch.cat([k[n] for k in self.kept])
                for n in ("f", "Hf", "P")}
        gc.collect()
        ref = self.reference(False, "reference_scf")
        ctl = self.reference(True) if control else None
        worst, self.k2_sweeps = Worst(), []
        from reference.jacobi import solver_input, sweeps
        for s in _blocks(len(sp_all), self.block):
            sp = sp_all[s]
            r = ref.single_point(sp, x_all[s])
            if s.start == 0:
                self.k2_sweeps = sweeps(solver_input(
                    r["Fp"], ref.packed_mask(sp))).tolist()
            if control:
                c = ctl.single_point(sp, x_all[s])
                cf, cH, cP = c["f"], c["Hf"], c["P"]
            else:
                cf, cH, cP = prog["f"][s], prog["Hf"][s], prog["P"][s]
            worst.add("force_err", max_abs(cf, r["f"], (sp > 0)[..., None]))
            worst.add("energy_err", max_abs(cH, r["Hf"]))
            worst.add("density_err", max_abs(cP, r["P"]))
        return worst.values

    def trace_data(self) -> dict:
        return {"batch": self.batch,
                "cells_k3": self.batch * self.K * self.K,
                "n_solver": self.n_solver,
                "k2_sweeps": getattr(self, "k2_sweeps", None),
                "k2_per_request": getattr(self, "k2_per_request", None)}


KINDS: Dict[str, Callable] = {"xlbomd": XLCell, "single_point": SPCell}
