"""Born-Oppenheimer molecular dynamics: NVE and the NVT thermostats.

PyTorch counterpart of ``pyseqm_tpu/drivers/md.py`` (cf. the reference
seqm/MolecularDynamics.py:158-432): velocity Verlet around an SCF force
call, the velocity-rescale and energy-shift thermostats, the Langevin and
Nose-Hoover chain NVT drivers, observables, and a ``run`` loop with thermo
lines between chunks of steps and extended-xyz frames every ``dump``
steps (``utils/io.py``); a ``utils.timing.Timing`` given to a driver
times each chunk.

Units: Angstrom, fs, eV, g/mol, Kelvin (same as the reference).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..constants import Constants
from ..models.energy import SEQMConfig, _species_tensor, check_species, force
from ..utils import io as xyz_io
from ..utils.timing import span, timed

# Unit conversions (MolecularDynamics.py:438-490):
# 1 (eV/Angstrom)/(g/mol) = 0.009648... Angstrom/fs^2
ACC_SCALE = 0.009648532800137615
# sqrt(Kelvin / (g/mol)) = 0.000911836... Angstrom/fs
VEL_SCALE = 0.9118367323190634e-3
# (g/mol) (Angstrom/fs)^2 = 103.64... eV
KE_SCALE = 1.0364270099032438e2
# sqrt(Kelvin * (g/mol)) / fs = 0.0945... eV/Angstrom (Langevin random force)
FR_SCALE = 0.09450522179973914
# 1 eV = 11604.5 Kelvin
EV_PER_KELVIN = 1.160451812e4


def atom_masses(const: Constants, species):
    """(..., 1) masses for F/m; padding gets mass 1 to keep acc finite."""
    m = const.mass[species]
    return torch.where(species > 0, m, torch.ones_like(m))[..., None]


def atom_masses_zero_pad(const: Constants, species):
    """(..., 1) masses with 0 for padding (kinetic energy, COM sums)."""
    return const.mass[species][..., None]


def kinetic_energy(const: Constants, species, velocities):
    """(Ek [eV], T [K]) per molecule (cf. MolecularDynamics.py:229-233)."""
    mass = atom_masses_zero_pad(const, species)
    Ek = (0.5 * mass * velocities ** 2).sum(dim=(1, 2)) * KE_SCALE
    # an empty molecule (a padding row) has T = 0, not 0/0
    ndof = 1.5 * torch.clamp((species > 0).sum(dim=1), min=1).to(Ek.dtype)
    return Ek, Ek * EV_PER_KELVIN / ndof


def initialize_velocity(const: Constants, species, coordinates,
                        generator: Optional[torch.Generator] = None,
                        Temp=300.0, vel_com=True):
    """Maxwell-Boltzmann velocities at Temp (cf. MolecularDynamics.py:181),
    drawn from ``generator``."""
    mass = atom_masses(const, species)
    scale = torch.sqrt(Temp / mass) * VEL_SCALE
    v = torch.randn(coordinates.shape, generator=generator,
                    dtype=coordinates.dtype,
                    device=coordinates.device) * scale
    v = torch.where((species > 0)[..., None], v, torch.zeros_like(v))
    if vel_com:
        _, v = zero_com(const, species, coordinates, v)
    return v


def zero_com(const: Constants, species, coordinates, velocities):
    """Remove COM position/velocity and rigid-body angular momentum, then
    rescale to conserve temperature (cf. MolecularDynamics.py:195-227)."""
    mass = atom_masses_zero_pad(const, species)
    Mtot = mass.sum(dim=1, keepdim=True)
    _, T0 = kinetic_energy(const, species, velocities)

    r_com = (mass * coordinates).sum(dim=1, keepdim=True) / Mtot
    x = coordinates - r_com
    v_com = (mass * velocities).sum(dim=1, keepdim=True) / Mtot
    v = velocities - v_com

    L = (mass * torch.linalg.cross(x, v, dim=-1)).sum(dim=1)
    r2 = (x * x).sum(dim=-1, keepdim=True)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    inertia = ((mass[..., None] * r2[..., None] * eye).sum(dim=1)
               - (mass[..., None] * x[..., :, None] * x[..., None, :])
               .sum(dim=1))
    omega = torch.linalg.solve(inertia, L[..., None])[..., 0]
    v = v + torch.linalg.cross(x, omega[:, None, :].expand_as(x), dim=-1)
    _, T1 = kinetic_energy(const, species, v)
    alpha = torch.sqrt(T0 / torch.where(T1 > 0, T1, torch.ones_like(T1)))
    v = v * alpha[:, None, None]
    v = torch.where((species > 0)[..., None], v, torch.zeros_like(v))
    return x, v


@dataclasses.dataclass(frozen=True)
class MDConfig:
    timestep: float = 1.0               # fs
    # velocity rescale every freq steps to T0: (freq, T0)
    scale_vel: Optional[Tuple[int, float]] = None
    control_energy_shift: bool = False
    remove_com: Optional[int] = None    # every N steps
    # Langevin
    damp: float = 1.0                   # fs
    temperature: float = 300.0          # K


@dataclasses.dataclass
class MDState:
    """MD state: (coords, vel, acc, P, E0, step)."""
    coordinates: torch.Tensor
    velocities: torch.Tensor
    acc: torch.Tensor
    P: torch.Tensor                     # converged density (next SCF guess)
    E0: torch.Tensor                    # initial total energy
    step: int


class Observables(NamedTuple):
    Ek: torch.Tensor
    T: torch.Tensor
    Epot: torch.Tensor
    dipole: torch.Tensor
    charges: torch.Tensor


def atomic_charges(const: Constants, species, P):
    """Mulliken charges from the density diagonal (MolecularDynamics.py:275)."""
    nmol, A = species.shape
    q_el = torch.diagonal(P, dim1=1, dim2=2).reshape(nmol, A, 4).sum(dim=2)
    return const.tore[species] - q_el


def atomic_charges_packed(const: Constants, species, Pp, K: int):
    """Mulliken charges from a static-packed density (atoms [0, K) keep
    their 4-orbital block, later atom slots only their s orbital)."""
    nmol, A = species.shape
    d = torch.diagonal(Pp, dim1=1, dim2=2)
    heavy = d[:, :4 * K].reshape(nmol, K, 4).sum(dim=2)
    q_el = torch.cat([heavy, d[:, 4 * K:4 * K + (A - K)]], dim=1)
    return const.tore[species] - q_el


def dipole(q, coordinates):
    return (q[..., None] * coordinates).sum(dim=1)


class MolecularDynamics:
    """NVE velocity-Verlet driver (cf. Molecular_Dynamics_Basic).

    Runs on the device of ``const``; ``charges`` (nmol,) are the net
    molecular charges threaded into every energy and force evaluation;
    ``timing`` (a utils.timing.Timing) records each ``run`` chunk as phase
    "MD" (cf. Constants.do_timing, reference constants.py:133-140).
    """

    def __init__(self, const: Constants, tables, seqm_cfg: SEQMConfig,
                 md_cfg: MDConfig = MDConfig(), learned=None, charges=None,
                 timing=None):
        self.const = const
        self.tables = tables
        self.seqm_cfg = seqm_cfg
        self.md_cfg = md_cfg
        self.learned = learned
        self.device = const.device
        self.charges = (None if charges is None else
                        torch.as_tensor(charges, dtype=torch.long,
                                        device=self.device))
        self.timing = timing

    def _charges_arg(self, charges):
        return self.charges if charges is None else charges

    def _species(self, species):
        return _species_tensor(species, self.device)

    def compute_force(self, species, state: MDState, charges=None):
        """(force, P, Epot per molecule).  Override for bias forces."""
        f, out = force(self.const, self.tables, self.seqm_cfg, species,
                       state.coordinates, learned=self.learned, P0=state.P,
                       charges=self._charges_arg(charges))
        return f, out.P, out.Hf

    def step(self, species, state: MDState,
             charges=None) -> Tuple[MDState, Observables]:
        with span("md.step"):
            species = self._species(species)
            dt = self.md_cfg.timestep
            mass = atom_masses(self.const, species)

            v = state.velocities + 0.5 * state.acc * dt
            x = state.coordinates + v * dt
            st1 = dataclasses.replace(state, coordinates=x, velocities=v)
            f, P, Epot = self.compute_force(species, st1, charges)
            acc = f / mass * ACC_SCALE
            v = v + 0.5 * acc * dt
            state = dataclasses.replace(state, coordinates=x, velocities=v,
                                        acc=acc, P=P, step=state.step + 1)
            state = self._thermostat(species, state, Epot)
            Ek, T = kinetic_energy(self.const, species, state.velocities)
            q = atomic_charges(self.const, species, state.P)
            return state, Observables(Ek, T, Epot,
                                      dipole(q, state.coordinates), q)

    def _thermostat(self, species, state, Epot):
        cfg = self.md_cfg
        if cfg.scale_vel is not None and cfg.control_energy_shift:
            raise ValueError("cannot fix temperature and energy shift together")
        if cfg.scale_vel is not None:
            freq, T0 = cfg.scale_vel
            if state.step % freq == 0:
                _, T = kinetic_energy(self.const, species, state.velocities)
                alpha = torch.sqrt(T0 / torch.where(T > 0, T,
                                                    torch.ones_like(T)))
                state = dataclasses.replace(
                    state, velocities=state.velocities * alpha[:, None, None])
        if cfg.control_energy_shift:
            Ek, _ = kinetic_energy(self.const, species, state.velocities)
            shift = Ek + Epot - state.E0
            ratio = (Ek - shift) / torch.where(Ek > 0, Ek, torch.ones_like(Ek))
            alpha = torch.sqrt(torch.clamp(ratio, min=0.0))
            alpha = torch.where(torch.isfinite(alpha), alpha,
                                torch.zeros_like(alpha))
            state = dataclasses.replace(
                state, velocities=state.velocities * alpha[:, None, None])
        return state

    def _initial_velocities(self, species, coordinates, velocities,
                            generator, Temp):
        if velocities is not None:
            return torch.as_tensor(velocities, dtype=coordinates.dtype,
                                   device=self.device)
        return initialize_velocity(self.const, species, coordinates,
                                   generator, Temp)

    def initialize(self, species, coordinates, velocities=None,
                   generator: Optional[torch.Generator] = None,
                   Temp=300.0) -> MDState:
        """Initial MDState: velocities (drawn from ``generator`` unless
        given) and the bootstrap SCF force, which fills acc and P."""
        check_species(self.seqm_cfg, self.tables, species, self.charges)
        species = self._species(species)
        coordinates = torch.as_tensor(coordinates, dtype=self.const.dtype,
                                      device=self.device)
        velocities = self._initial_velocities(species, coordinates,
                                              velocities, generator, Temp)
        st = MDState(coordinates=coordinates, velocities=velocities,
                     acc=torch.zeros_like(coordinates), P=None,
                     E0=torch.zeros(species.shape[0], dtype=coordinates.dtype,
                                    device=self.device), step=0)
        f, P, Epot = self.compute_force(species, st)
        Ek, _ = kinetic_energy(self.const, species, velocities)
        mass = atom_masses(self.const, species)
        return dataclasses.replace(st, acc=f / mass * ACC_SCALE, P=P,
                                   E0=Epot + Ek)

    def run(self, species, state, steps: int, thermo: int = 1,
            dump: Optional[int] = None, dump_prefix: str = "md",
            molids=(0,), log: bool = True):
        """Drive ``steps`` steps in chunks of ``thermo``, printing a thermo
        line for ``molids`` after each chunk, appending an extended-xyz
        frame of each of ``molids`` to ``{dump_prefix}.{mol}.xyz`` at every
        step that is a multiple of ``dump`` (with the forces of that step;
        written after the chunk), and removing COM motion at the end of a
        chunk that crossed a ``remove_com`` boundary
        (cf. MolecularDynamics.py:291-320)."""
        species = self._species(species)
        if log:
            print("Step, Temp, E(kinetic), E(potential), E(total), "
                  "dipole(x,y,z)")
        rc = self.md_cfg.remove_com
        mass = atom_masses(self.const, species)
        done = 0
        while done < steps:
            n = min(thermo, steps - done)
            frames = []
            with timed(self.timing, "MD", self.device):
                for k in range(done + 1, done + n + 1):
                    state, obs = self.step(species, state)
                    if dump and k % dump == 0:
                        frames.append((state, obs))
            for st, ob in frames:
                xyz_io.dump_frame(dump_prefix, species, st, ob, molids,
                                  forces=st.acc * mass / ACC_SCALE)
            prev, done = done, done + n
            if log:
                cols = " ".join(
                    f"{float(obs.T[m]):8.2f} {float(obs.Ek[m]):.6e} "
                    f"{float(obs.Epot[m]):.6e} "
                    f"{float(obs.Ek[m] + obs.Epot[m]):.6e} "
                    f"{float(obs.dipole[m, 0]):.6e} "
                    f"{float(obs.dipole[m, 1]):.6e} "
                    f"{float(obs.dipole[m, 2]):.6e}" for m in molids)
                print(f"{done:6d} {cols}", flush=True)
            if rc and done // rc > prev // rc:
                x, v = zero_com(self.const, species, state.coordinates,
                                state.velocities)
                if isinstance(state, NHState):
                    state = dataclasses.replace(
                        state, base=dataclasses.replace(
                            state.base, coordinates=x, velocities=v))
                else:
                    state = dataclasses.replace(state, coordinates=x,
                                                velocities=v)
        return state


@dataclasses.dataclass
class NHState:
    """MD state plus the per-molecule Nose-Hoover chain positions ``xi``
    and momenta ``vxi``, (nmol, 2)."""
    base: MDState
    vxi: torch.Tensor
    xi: torch.Tensor

    # passthroughs so run() works on the wrapped state
    @property
    def coordinates(self):
        return self.base.coordinates

    @property
    def velocities(self):
        return self.base.velocities

    @property
    def acc(self):
        return self.base.acc

    @property
    def P(self):
        return self.base.P

    @property
    def step(self):
        return self.base.step


class NoseHooverDynamics(MolecularDynamics):
    """NVT via a Nose-Hoover chain (length 2, Martyna-Klein-Tuckerman),
    half a chain update on each side of the velocity-Verlet step.  The
    reference declares this class as a stub (MolecularDynamics.py:435-436).
    """

    CHAIN = 2

    def __init__(self, const, tables, seqm_cfg, md_cfg=MDConfig(),
                 tau: float = 20.0, learned=None, charges=None, timing=None):
        super().__init__(const, tables, seqm_cfg, md_cfg, learned, charges,
                         timing)
        self.tau = tau  # thermostat time constant (fs)

    def initialize(self, species, coordinates, velocities=None,
                   generator: Optional[torch.Generator] = None,
                   Temp=300.0) -> NHState:
        st = super().initialize(species, coordinates, velocities, generator,
                                Temp)
        z = torch.zeros((st.coordinates.shape[0], self.CHAIN),
                        dtype=st.coordinates.dtype, device=self.device)
        return NHState(base=st, vxi=z, xi=z.clone())

    def _nhc_half(self, species, st: NHState, dt) -> NHState:
        """Half-step chain update of the thermostat momenta and the
        velocity scale (factorized MTK scheme)."""
        kT = self.md_cfg.temperature / EV_PER_KELVIN  # eV
        v = st.base.velocities
        ndf = 3.0 * (species > 0).sum(dim=1).to(v.dtype)
        Q1 = ndf * kT * self.tau ** 2 / KE_SCALE
        Q2 = kT * self.tau ** 2 / KE_SCALE

        def chain(v0, v1, Ek):
            G1 = (2.0 * Ek - ndf * kT) / (Q1 * KE_SCALE)
            damp = torch.exp(-0.125 * dt * v1)
            return (v0 * damp + 0.25 * dt * G1) * damp

        Ek, _ = kinetic_energy(self.const, species, v)
        v0, v1 = st.vxi[:, 0], st.vxi[:, 1]
        v1 = v1 + 0.25 * dt * (Q1 * v0 ** 2 * KE_SCALE - kT) / (Q2 * KE_SCALE)
        v0 = chain(v0, v1, Ek)
        scale = torch.exp(-0.5 * dt * v0)
        xi = st.xi + 0.5 * dt * torch.stack([v0, v1], dim=1)
        v0 = chain(v0, v1, Ek * scale ** 2)
        v1 = v1 + 0.25 * dt * (Q1 * v0 ** 2 * KE_SCALE - kT) / (Q2 * KE_SCALE)
        base = dataclasses.replace(st.base,
                                   velocities=v * scale[:, None, None])
        return NHState(base=base, vxi=torch.stack([v0, v1], dim=1), xi=xi)

    def step(self, species, st: NHState, charges=None):
        with span("md.step"):
            species = self._species(species)
            dt = self.md_cfg.timestep
            st = self._nhc_half(species, st, dt)
            base, obs = super().step(species, st.base, charges)
            st = self._nhc_half(species, NHState(base, st.vxi, st.xi), dt)
            # Ek/T of the returned (post-thermostat) velocities
            Ek, T = kinetic_energy(self.const, species, st.base.velocities)
            return st, obs._replace(Ek=Ek, T=T)


class LangevinDynamics(MolecularDynamics):
    """NVT Langevin thermostat (LAMMPS formula, MolecularDynamics.py:395-432):
    F = Fc - (m/damp) v + sqrt(2 kB T m / (dt damp)) N(0,1).

    The noise comes from ``generator`` (a torch.Generator on the device of
    ``const``), given to the constructor or to ``initialize``; every draw
    goes through :meth:`random_normal`."""

    def __init__(self, const, tables, seqm_cfg, md_cfg=MDConfig(),
                 learned=None, charges=None,
                 generator: Optional[torch.Generator] = None, timing=None):
        super().__init__(const, tables, seqm_cfg, md_cfg, learned, charges,
                         timing)
        self.generator = generator

    def initialize(self, species, coordinates, velocities=None,
                   generator: Optional[torch.Generator] = None,
                   Temp=300.0) -> MDState:
        if generator is not None:
            self.generator = generator
        if self.generator is None:
            raise ValueError("LangevinDynamics needs a torch.Generator for "
                             "its random force (pass generator=)")
        if self.generator.device.type != self.device.type:
            raise ValueError(f"the generator is on {self.generator.device}, "
                             f"the dynamics on {self.device}")
        return super().initialize(species, coordinates, velocities,
                                  self.generator, Temp)

    def random_normal(self, state: MDState, shape) -> torch.Tensor:
        """N(0,1) draws of the random force at ``state`` (its step)."""
        return torch.randn(shape, generator=self.generator,
                           dtype=state.coordinates.dtype, device=self.device)

    def compute_force(self, species, state: MDState, charges=None):
        Fc, P, Epot = super().compute_force(species, state, charges)
        cfg = self.md_cfg
        mass = atom_masses(self.const, species)
        Ff = -mass * state.velocities / cfg.damp / ACC_SCALE
        Fr = FR_SCALE * torch.sqrt(
            2.0 * cfg.temperature * mass / cfg.timestep / cfg.damp
        ) * self.random_normal(state, Fc.shape)
        F = Fc + Ff + Fr
        return torch.where((species > 0)[..., None], F, torch.zeros_like(F)), \
            P, Epot
