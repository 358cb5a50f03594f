"""Extended-Lagrangian BOMD integrator (Niklasson dissipative propagation).

PyTorch counterpart of ``pyseqm_tpu/drivers/xlbomd.py`` (cf. XL_BOMD,
seqm/XLBOMD.py:224-368).  The electronic degrees of freedom propagate
without any SCF: the dynamic density field follows

  P(n+1) = cc*kappa*D(n) + sum_k c'_k P(n-k)

with the k=3..9 coefficient tables of Niklasson et al., JCP 130, 214109
(2009), folded so the history update is one weighted sum over a ring
buffer Pt.  Bootstrapped by one full SCF; each step is one Hcore + one
Fock + one density solve (eigh or SP2).  The electronic state lives in the
static packed layout on the class-segmented dense path (pack_heavy), and
at the full (nmol, 4A, 4A) otherwise, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..constants import Constants
from ..models.energy import SEQMConfig, _packed_layout, energy
from ..models.xlbomd import force_xl
from ..ops.density import static_pack_mat
from ..utils.timing import span
from .md import (ACC_SCALE, MDConfig, MDState, MolecularDynamics,
                 Observables, atom_masses, atomic_charges,
                 atomic_charges_packed, dipole, kinetic_energy)

# kappa, alpha, c0..ck per history order k (Niklasson JCP 130, 214109)
XL_COEFFS = {
    3: (1.69, 150e-3, (-2.0, 3.0, 0.0, -1.0)),
    4: (1.75, 57e-3, (-3.0, 6.0, -2.0, -2.0, 1.0)),
    5: (1.82, 18e-3, (-6.0, 14.0, -8.0, -3.0, 4.0, -1.0)),
    6: (1.84, 5.5e-3, (-14.0, 36.0, -27.0, -2.0, 12.0, -6.0, 1.0)),
    7: (1.86, 1.6e-3, (-36.0, 99.0, -88.0, 11.0, 32.0, -25.0, 8.0, -1.0)),
    8: (1.88, 0.44e-3, (-99.0, 286.0, -286.0, 78.0, 78.0, -90.0, 42.0,
                        -10.0, 1.0)),
    9: (1.89, 0.12e-3, (-286.0, 858.0, -936.0, 364.0, 168.0, -300.0, 184.0,
                        -63.0, 12.0, -1.0)),
}


@dataclasses.dataclass
class XLBOMDState:
    """MD state + electronic history (D, P, Pt), all (nmol, n, n) with n the
    static packed size on the packed path and 4A otherwise (Pt:
    (k+1, nmol, n, n)).  ``step`` updates Pt in place."""
    coordinates: torch.Tensor
    velocities: torch.Tensor
    acc: torch.Tensor
    D: torch.Tensor          # purified density from the last Fock
    P: torch.Tensor          # dynamic density field
    Pt: torch.Tensor         # ring buffer of past fields
    E0: torch.Tensor
    step: int


class XLBOMD(MolecularDynamics):
    """XL-BOMD driver; k = history order (3..9)."""

    def __init__(self, const: Constants, tables, seqm_cfg: SEQMConfig,
                 md_cfg: MDConfig = MDConfig(), k: int = 5, cc: float = 1.0,
                 learned=None, charges=None, timing=None):
        super().__init__(const, tables, seqm_cfg, md_cfg, learned, charges,
                         timing)
        kappa, alpha, cs = XL_COEFFS[k]
        self.k = k
        self.m = k + 1
        # fold the (2 - cc*kappa) P(n) and -P(n-1) Verlet terms into the
        # dissipation coefficients: one weighted history sum per step
        coeff = [c * alpha for c in cs]
        coeff[0] += 2.0 - cc * kappa
        coeff[1] -= 1.0
        self.coeff_D = cc * kappa
        self.coeff = torch.as_tensor(coeff * 2, dtype=const.dtype,
                                     device=self.device)  # doubled ring

    def initialize(self, species, coordinates, velocities=None,
                   generator: Optional[torch.Generator] = None, Temp=300.0,
                   initial_force: bool = True) -> XLBOMDState:
        """Bootstrap with one full SCF (cf. XL_BOMD.initialize,
        XLBOMD.py:264-269).  ``initial_force=False`` skips the SCF gradient
        (acc starts at zero; the first half-step is off by O(dt^2))."""
        if initial_force:
            st = super().initialize(species, coordinates, velocities,
                                    generator, Temp)
        else:
            species = self._species(species)
            coordinates = torch.as_tensor(coordinates, dtype=self.const.dtype,
                                          device=self.device)
            velocities = self._initial_velocities(species, coordinates,
                                                  velocities, generator, Temp)
            out = energy(self.const, self.tables, self.seqm_cfg, species,
                         coordinates, learned=self.learned,
                         charges=self.charges)
            Ek, _ = kinetic_energy(self.const, species, velocities)
            st = MDState(coordinates=coordinates, velocities=velocities,
                         acc=torch.zeros_like(coordinates), P=out.P,
                         E0=out.Hf + Ek, step=0)
        packed = _packed_layout(self.seqm_cfg, st.coordinates.shape[1])
        D = st.P if packed is None else static_pack_mat(st.P, *packed)
        Pt = D[None].expand((self.m,) + D.shape).clone()
        return XLBOMDState(coordinates=st.coordinates,
                           velocities=st.velocities, acc=st.acc, D=D, P=D,
                           Pt=Pt, E0=st.E0, step=0)

    def step(self, species, state: XLBOMDState, charges=None):
        with span("md.step"):
            species = self._species(species)
            dt = self.md_cfg.timestep
            mass = atom_masses(self.const, species)

            v = state.velocities + 0.5 * state.acc * dt
            x = state.coordinates + v * dt

            # P <- cc*kappa*D + sum coeff[cindx:cindx+m] * Pt
            cindx = state.step % self.m
            cs = self.coeff[cindx:cindx + self.m]
            P = self.coeff_D * state.D + torch.einsum('k,knij->nij', cs,
                                                      state.Pt)
            state.Pt[self.m - 1 - cindx] = P

            packed = _packed_layout(self.seqm_cfg, species.shape[1])
            f, Epot, D = force_xl(self.const, self.tables, self.seqm_cfg,
                                  species, x, P, self.learned,
                                  charges=self._charges_arg(charges),
                                  packed_io=packed is not None)
            acc = f / mass * ACC_SCALE
            v = v + 0.5 * acc * dt
            state = dataclasses.replace(state, coordinates=x, velocities=v,
                                        acc=acc, D=D, P=P,
                                        step=state.step + 1)
            state = self._thermostat(species, state, Epot)

            Ek, T = kinetic_energy(self.const, species, state.velocities)
            q = (atomic_charges(self.const, species, state.P)
                 if packed is None else
                 atomic_charges_packed(self.const, species, state.P,
                                       packed[0]))
            return state, Observables(Ek, T, Epot,
                                      dipole(q, state.coordinates), q)
