"""Single-point energy / force models (the flagship API).

PyTorch counterpart of ``pyseqm_tpu/models/energy.py`` on the main path:
the class-segmented dense integrals with the static packed SCF, and the
orbital energies and per-MO atomic charges of ``eig=True`` (cf. the
reference Energy / Force / Hamiltonian modules, seqm/basics.py:216-390).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np
import torch

from ..constants import Constants, disable_tf32, make_constants
from ..ops.density import (orbital_permutation, packed_solver_size,
                           static_unpack_mat, sym_eig)
from ..ops.energy import (assemble_energies, elec_energy_isolated_atom,
                          elec_energy_tf, pair_nuclear_energy_dense)
from ..ops.fock import fock_packed_split
from ..ops.hcore import hcore_dense_split
from ..parameters import gather_atom_parameters, load_element_tables
from ..scf import SCFConfig, scf_solve
from ..system import System, make_system, validate


@dataclasses.dataclass(frozen=True)
class SEQMConfig:
    """Typed replacement for the reference's ``seqm_parameters`` dict."""

    method: str = "AM1"
    scf: SCFConfig = dataclasses.field(default_factory=SCFConfig)
    hf_flag: bool = True            # Hf vs Etot - Eiso (basics.py:265-268)
    pair_outer_cutoff: float = 1.0e10
    # double-float STO overlap integrals on f32 (ops/overlap.py)
    precise_overlap: bool = True
    # orbital energies e and per-MO atomic charges (cf. basics.py:291-299)
    eig: bool = False


class EnergyOutput(NamedTuple):
    Hf: torch.Tensor
    Etot: torch.Tensor
    Eelec: torch.Tensor
    Enuc: torch.Tensor
    Eiso_sum: torch.Tensor
    EnucAB: torch.Tensor
    P: torch.Tensor               # converged density (nmol, 4A, 4A)
    notconverged: torch.Tensor
    F: Optional[torch.Tensor] = None       # Fock matrix, (nmol, 4A, 4A)
    Hcore: Optional[torch.Tensor] = None   # core Hamiltonian, same layout
    e: Optional[torch.Tensor] = None       # orbital energies (eig=True)
    charge: Optional[torch.Tensor] = None  # (nmol, 4A, A) (eig=True)
    w: Optional[Any] = None                # two-electron integrals


class HamiltonianOutput(NamedTuple):
    """The reference Hamiltonian module's return contract
    (basics.py:216-249)."""
    F: torch.Tensor
    e: Optional[torch.Tensor]
    P: torch.Tensor
    Hcore: torch.Tensor
    w: Any
    charge: Optional[torch.Tensor]
    notconverged: torch.Tensor


LearnedParams = Union[Mapping[str, torch.Tensor],
                      Callable[[torch.Tensor, torch.Tensor],
                               Mapping[str, torch.Tensor]]]


def _atom_parameters(tables, method, sys: System,
                     learned: Optional[LearnedParams],
                     coordinates) -> Dict[str, torch.Tensor]:
    if callable(learned):
        learned = learned(sys.species, coordinates)
    p = gather_atom_parameters(tables, method, sys.species, learned)
    for hook in ("Kbeta", "g_ss_nuc"):
        if hook in p:
            raise NotImplementedError(f"the learned {hook} hook is not "
                                      "ported yet")
    return p


def _orbital_charges(sys: System, v: torch.Tensor) -> torch.Tensor:
    """Per-MO atomic charge decomposition (cf. scf_loop.py:795-800).

    v: eigenvectors in the permuted valid-first layout of sym_eig; returns
    (nmol, 4A, A) where charge[n, mo, atom] is the sum of the squared MO
    coefficients on that atom (zero for mo >= norb)."""
    perm, _ = orbital_permutation(sys)
    A = sys.species.shape[1]
    onehot = torch.nn.functional.one_hot(perm // 4, A).to(v.dtype)
    charge = torch.einsum('nrl,nra->nla', v ** 2, onehot)
    idx = torch.arange(v.shape[-1], device=v.device)
    keep = (idx[None, :] < sys.norb[:, None])[..., None]
    return torch.where(keep, charge, torch.zeros_like(charge))


def _packed_layout(cfg: SEQMConfig, A: int) -> Tuple[int, int]:
    """(K, n_st): the class-segmented dense layout with the static packed
    electronic state, the one layout this package runs."""
    K = cfg.scf.pack_heavy
    if K is None:
        raise NotImplementedError(
            "only the packed path is ported: set SCFConfig(pack_heavy="
            "packed_heavy_count(species))")
    n_st = packed_solver_size(K, A)
    if n_st is None:
        raise NotImplementedError(f"packing cannot shrink 4A={4 * A} at "
                                  f"K={K}; the full-layout path is not "
                                  "ported yet")
    return K, n_st


def _integral_stack(const, sys, p, cfg, K: int, n_st: int):
    """(packed core matrix, class-segmented integrals)."""
    return hcore_dense_split(const, sys, p, K, n_st, cfg.pair_outer_cutoff,
                             cfg.precise_overlap)


def _nuclear_term(const, sys, w, cfg, p):
    """(EnucAB, its pair mask) on the dense grid."""
    return pair_nuclear_energy_dense(const, sys, w.gam_grid(), cfg.method, p,
                                     cfg.pair_outer_cutoff)


def _species_tensor(species, device) -> torch.Tensor:
    return torch.as_tensor(species, dtype=torch.long, device=device)


def check_species(cfg: SEQMConfig, tables, species, charges=None) -> None:
    """Host-side species/config checks, run on every call: element range,
    descending-Z sort, closed shell, and no element whose parameter row is
    all zero for the method (which would silently zero its integrals)."""
    sp = np.asarray(species.cpu() if torch.is_tensor(species) else species)
    ch = None
    if charges is not None:
        ch = np.asarray(charges.cpu() if torch.is_tensor(charges)
                        else charges)
    validate(sp, ch)
    present = np.unique(sp[sp > 0])
    if present.size == 0:
        return
    zrow = tables["zeta_s"].cpu().numpy()[present]
    if (zrow == 0).any():
        bad = sorted(int(z) for z in present[zrow == 0])
        raise ValueError(
            f"elements Z={bad} have no {cfg.method} parameters "
            "(all-zero rows in the published table) — energies would "
            "be silently wrong")


def energy(const: Constants, tables: Mapping[str, torch.Tensor],
           cfg: SEQMConfig, species, coordinates: torch.Tensor,
           learned: Optional[LearnedParams] = None,
           P0: Optional[torch.Tensor] = None,
           charges=None) -> EnergyOutput:
    """Single-point SCF energy for a batch of molecules (cf. Energy.forward,
    basics.py:271-346).  Differentiable with respect to ``coordinates``
    (Hellmann-Feynman: the converged density is held constant)."""
    check_species(cfg, tables, species, charges)
    species = _species_tensor(species, coordinates.device)
    A = species.shape[1]
    K, n_st = _packed_layout(cfg, A)
    sys = make_system(const, species, coordinates, charges,
                      cfg.pair_outer_cutoff, heavy_count=K)
    p = _atom_parameters(tables, cfg.method, sys, learned, coordinates)

    M, w = _integral_stack(const, sys, p, cfg, K, n_st)
    Pp, notconverged = scf_solve(const, sys, M, w, p, cfg.scf, P0,
                                 packed=(K, n_st))
    Fp = fock_packed_split(sys, Pp, M, w, p, K, n_st)
    eel_tf = elec_energy_tf(Pp, Fp, M)
    EnucAB, enuc_mask = _nuclear_term(const, sys, w, cfg, p)
    Eiso = elec_energy_isolated_atom(const, sys.species, p)
    Hf, Etot, Eel, Enuc, Eiso_sum = assemble_energies(
        const, sys, eel_tf, EnucAB, Eiso, cfg.hf_flag, pair_mask=enuc_mask)
    F = static_unpack_mat(Fp, K, A)
    e = charge = None
    if cfg.eig:
        # with_flag surfaces a molecule whose Jacobi sweeps failed (re-solved
        # exactly inside sym_eig) in notconverged, as the SCF flag does
        # (cf. scf_loop.py:753-762)
        e, v, eig_failed = sym_eig(sys, F, eig_only=True, with_flag=True)
        charge = _orbital_charges(sys, v)
        notconverged = notconverged | eig_failed
    return EnergyOutput(Hf, Etot, Eel, Enuc, Eiso_sum, EnucAB,
                        static_unpack_mat(Pp, K, A), notconverged, F=F,
                        Hcore=static_unpack_mat(M, K, A), e=e, charge=charge,
                        w=w)


def hamiltonian(const: Constants, tables: Mapping[str, torch.Tensor],
                cfg: SEQMConfig, species, coordinates: torch.Tensor,
                learned: Optional[LearnedParams] = None,
                P0: Optional[torch.Tensor] = None,
                charges=None) -> HamiltonianOutput:
    """SCF-converged Hamiltonian-level quantities without the energy
    readout: (F, e, P, Hcore, w, charge, notconverged), as the reference
    Hamiltonian.forward returns them (basics.py:216-249)."""
    out = energy(const, tables, cfg, species, coordinates, learned, P0,
                 charges)
    return HamiltonianOutput(out.F, out.e, out.P, out.Hcore, out.w,
                             out.charge, out.notconverged)


def _detach_tree(t):
    if torch.is_tensor(t):
        return t.detach()
    if isinstance(t, tuple):
        return type(t)(*[_detach_tree(u) for u in t])
    return t


def _detach(out):
    return type(out)(*[_detach_tree(t) for t in out])


def force(const: Constants, tables: Mapping[str, torch.Tensor],
          cfg: SEQMConfig, species, coordinates: torch.Tensor,
          learned: Optional[LearnedParams] = None,
          P0: Optional[torch.Tensor] = None,
          charges=None) -> Tuple[torch.Tensor, EnergyOutput]:
    """Forces -dHf/dR (eV/Angstrom) + energy terms (cf. Force,
    basics.py:348)."""
    coords = coordinates.detach().requires_grad_(True)
    with torch.enable_grad():
        out = energy(const, tables, cfg, species, coords, learned, P0,
                     charges)
        (grad,) = torch.autograd.grad(out.Hf.sum(), coords)
    return -grad, _detach(out)


def build(method: str = "AM1", dtype=torch.float32, device="cuda",
          **cfg_kwargs):
    """Convenience constructor: (const, tables, cfg) on ``device`` (CUDA by
    default; raises without a GPU unless device="cpu").  Turns TF32 off."""
    disable_tf32()
    const = make_constants(dtype=dtype, device=device)
    tables = load_element_tables(method, device=device, dtype=dtype)
    cfg = SEQMConfig(method=method, **cfg_kwargs)
    return const, tables, cfg
