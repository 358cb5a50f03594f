"""Single-point energy / force models (the flagship API).

PyTorch counterpart of ``pyseqm_tpu/models/energy.py`` (cf. the reference
Energy / Force / Hamiltonian modules, seqm/basics.py:216-390).  The
integral layout is chosen as the JAX package chooses it
(``_resolve_pair_layout``): the flat pair list for small molecules, the
ordered dense grid at A >= 64, and the class-segmented dense grid with the
static packed SCF when ``SCFConfig.pack_heavy`` is set, or the
class-segmented flat pair list (``pack_pairs`` with
``dense_pair_grid=False``); plus the orbital energies and per-MO atomic
charges of ``eig=True``.  The density differentiates by the SCF's backward
mode (``SCFConfig.backward``): constant (Hellmann-Feynman), the recursive
adjoint, or the unrolled fixed point.  Learned parameters come as a dict
or a callable (``models/ml.py``, ``models/hipnn.py``), with two hooks
beside the table's names: ``Kbeta`` (nmol, NP, 4), per-pair factors of the
resonance blocks in canonical ``pair_index(A)`` order, and ``g_ss_nuc``
(nmol, A), the per-atom gamma of the core-core term (cf. the reference
basics.py:279-327).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Tuple, Union)

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..constants import EV, Constants, disable_tf32, make_constants
from ..ops.density import (orbital_permutation, packed_solver_size,
                           static_unpack_mat, sym_eig)
from ..ops.energy import (assemble_energies, elec_energy_isolated_atom,
                          elec_energy_tf, pair_nuclear_energy,
                          pair_nuclear_energy_dense)
from ..ops.fock import fock, fock_packed_split
from ..ops.hcore import hcore, hcore_dense, hcore_dense_split, hcore_split
from ..ops.matrix import grid_to_mat
from ..ops.tetci import from_grid
from ..parameters import gather_atom_parameters, load_element_tables
from ..scf import SCFConfig, scf_solve
from ..system import (System, make_system, pair_packed_from_canonical,
                      validate)
from ..utils.timing import count, span


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
    # grid-resident two-electron integrals (scatter-free Fock builds).
    # None = auto: on for the class-segmented packed layout (pack_heavy)
    # and for large molecules (A >= 64)
    dense_pair_grid: Optional[bool] = None
    # Fock layout when the integrals are grid-resident: None = the dense
    # grid Fock, False = the flat pair list extracted from the grid
    dense_fock: Optional[bool] = None
    # recompute the integral stack in the force backward instead of
    # storing its intermediates (torch.utils.checkpoint); None = auto, on
    # for A >= 32
    remat_integrals: Optional[bool] = None
    # class-segmented pair list keyed on scf.pack_heavy.  None = auto: on
    # when pack_heavy is set; on the flat pair list (dense_pair_grid
    # False) it selects hcore_split / fock(WPackSplit)
    pack_pairs: Optional[bool] = None
    # row-3 elements (Na..Cl) through the generated-coefficient overlap
    # (ops/overlap_general.py), on every pair layout; beyond the
    # reference, which raises for any row-3 pair (diat_overlap.py:65-72).
    # Elements whose parameter row is all zero for the method stay
    # unsupported (check_species)
    row3: bool = False


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
        with span("learned"):
            nmol, A = sys.species.shape
            count("molecules", nmol)
            count("atoms", nmol * A)
            learned = learned(sys.species, coordinates)
    return gather_atom_parameters(tables, method, sys.species, learned)


def _learned_hooks(p: Dict[str, torch.Tensor]):
    """(Kbeta, g_ss_nuc), each None when absent, popped from the per-atom
    parameter dict ``p``."""
    return p.pop("Kbeta", None), p.pop("g_ss_nuc", None)


def _hook_gamma(sys: System, g_ss_nuc: torch.Tensor) -> torch.Tensor:
    """The core-core term's (ss|ss) gamma per flat pair from the learned
    per-atom ``g_ss_nuc`` (cf. basics.py:321-327).  Padding lanes (g = 0
    there) are sanitized before the division, so gradients stay finite."""
    ga, gb = g_ss_nuc[:, sys.pair_i], g_ss_nuc[:, sys.pair_j]
    pm = sys.pair_mask
    one = torch.ones_like(ga)
    r0a = 0.5 * EV / torch.where(pm, ga, one)
    r0b = 0.5 * EV / torch.where(pm, gb, one)
    gam = EV / torch.sqrt(sys.rij ** 2 + (r0a + r0b) ** 2)
    return torch.where(pm, gam, torch.zeros_like(gam))


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


def _resolve_pair_layout(cfg: SEQMConfig, A: int) -> Tuple[bool, Optional[int]]:
    """(dense, packK): the integral layout, as the JAX package decides it.
    The class-segmented dense grid (pack_heavy) runs the packed electronic
    chain; without packing the dense grid only pays off at large A.
    packK without the dense grid is the class-segmented flat pair list."""
    pp = cfg.pack_pairs
    if pp is None:
        pp = cfg.scf.pack_heavy is not None
    if pp and cfg.scf.pack_heavy is None:
        raise ValueError("pack_pairs=True requires scf.pack_heavy "
                         "(= packed_heavy_count(species))")
    packK = cfg.scf.pack_heavy if pp else None
    dense = cfg.dense_pair_grid
    if dense is None:
        dense = A >= 64 or packK is not None
    return dense, packK


def _packed_layout(cfg: SEQMConfig, A: int) -> Optional[Tuple[int, int]]:
    """(K, n_st) when the run uses the static packed electronic state (the
    class-segmented dense grid, with packing able to shrink 4A), else
    None (the full (nmol, 4A, 4A) layout)."""
    dense, packK = _resolve_pair_layout(cfg, A)
    if not (dense and packK is not None):
        return None
    n_st = packed_solver_size(packK, A)
    return None if n_st is None else (packK, n_st)


def _integral_stack(const, sys, p, cfg, packed_m: Optional[int] = None,
                    Kbeta: Optional[torch.Tensor] = None):
    """(M, w, w_f): the core Hamiltonian (the block grid, or the static
    packed matrix of size ``packed_m`` on the class-segmented path), the
    two-electron integrals, and the integrals to feed the final Fock build
    (the flat pairs extracted from the grid under dense_fock=False).

    Large molecules build the integrals on the dense grid (hcore_dense:
    no per-pair gathers); the class-segmented paths (hcore_dense_split,
    hcore_split) cut hydrogen pairs to their 4- and 1-integral classes.
    With remat_integrals (auto at A >= 32) the build is checkpointed: the
    force backward recomputes it instead of keeping every intermediate.
    ``Kbeta`` (nmol, NP, 4), in canonical pair_index(A) order, is reordered
    to the class-segmented pair order where the layout uses it.
    """
    nmol, A = sys.species.shape
    dense, packK = _resolve_pair_layout(cfg, A)
    if Kbeta is not None:
        want = (nmol, A * (A - 1) // 2, 4)
        if tuple(Kbeta.shape) != want:
            raise ValueError(f"Kbeta has shape {tuple(Kbeta.shape)}, "
                             f"expected (nmol, NP, 4) = {want}")
        if packK is not None:
            order = pair_packed_from_canonical(A, packK)
            Kbeta = Kbeta[:, torch.as_tensor(order, device=Kbeta.device)]
    if packed_m is not None and not (dense and packK is not None):
        raise ValueError("packed_m requires the class-segmented dense path "
                         "(dense_pair_grid + pack_pairs)")
    if dense and packK is not None:
        def build(sys, p, Kbeta):
            return hcore_dense_split(const, sys, p, packK, packed_m,
                                     cfg.pair_outer_cutoff,
                                     cfg.precise_overlap, cfg.row3, Kbeta)
    elif dense:
        def build(sys, p, Kbeta):
            return hcore_dense(const, sys, p, cfg.pair_outer_cutoff,
                               cfg.precise_overlap, cfg.row3, Kbeta)
    elif packK is not None:
        def build(sys, p, Kbeta):
            return hcore_split(const, sys, p, packK, cfg.precise_overlap,
                               cfg.row3, Kbeta)
    else:
        def build(sys, p, Kbeta):
            return hcore(const, sys, p, False, cfg.precise_overlap,
                         cfg.row3, Kbeta)
    remat = cfg.remat_integrals
    if remat is None:
        remat = A >= 32
    if remat and torch.is_grad_enabled():
        M, w = checkpoint(build, sys, p, Kbeta, use_reentrant=False)
    else:
        M, w = build(sys, p, Kbeta)
    if dense and cfg.dense_fock is False:
        if not hasattr(w, "rig"):
            raise ValueError(
                "dense_fock=False (flat extraction) is not supported with "
                "class-segmented dense integrals; set pack_pairs=False")
        return M, w, from_grid(w, sys.pair_i, sys.pair_j)
    return M, w, w


def _nuclear_term(const, sys, w, cfg, p, gam=None):
    """(EnucAB, its pair mask or None for sys.pair_mask): gather-free on
    grid-resident integrals, per flat pair otherwise.  ``gam`` (nmol, NP)
    overrides the integrals' gamma per flat pair (the g_ss_nuc hook,
    :func:`_hook_gamma`)."""
    if gam is not None:
        return pair_nuclear_energy(const, sys, gam, cfg.method, p), None
    if hasattr(w, "gam_grid"):
        return pair_nuclear_energy_dense(const, sys, w.gam_grid(), cfg.method,
                                         p, cfg.pair_outer_cutoff)
    if hasattr(w, "rig"):
        return pair_nuclear_energy_dense(const, sys, w.rig[..., 0],
                                         cfg.method, p, cfg.pair_outer_cutoff)
    gam = w.gam() if hasattr(w, "gam") else w.ri[..., 0]     # (ss|ss)
    return pair_nuclear_energy(const, sys, gam, cfg.method, p), None


def _species_tensor(species, device) -> torch.Tensor:
    return torch.as_tensor(species, dtype=torch.long, device=device)


def check_species(cfg: SEQMConfig, tables, species, charges=None
                  ) -> np.ndarray:
    """Host-side species/config checks, run on every call: element range,
    row 3 only with ``cfg.row3``, descending-Z sort, closed shell, and no
    element whose parameter row is all zero for the method (which would
    silently zero its integrals).  Returns the species as a host array."""
    sp = np.asarray(species.cpu() if torch.is_tensor(species) else species)
    ch = None
    if charges is not None:
        ch = np.asarray(charges.cpu() if torch.is_tensor(charges)
                        else charges)
    validate(sp, ch, allow_row3=cfg.row3)
    present = np.unique(sp[sp > 0])
    if present.size == 0:
        return sp
    zrow = tables["zeta_s"].cpu().numpy()[present]
    if (zrow == 0).any():
        bad = sorted(int(z) for z in present[zrow == 0])
        raise ValueError(
            f"elements Z={bad} have no {cfg.method} parameters "
            "(all-zero rows in the published table) — energies would "
            "be silently wrong")
    return sp


def energy(const: Constants, tables: Mapping[str, torch.Tensor],
           cfg: SEQMConfig, species, coordinates: torch.Tensor,
           learned: Optional[LearnedParams] = None,
           P0: Optional[torch.Tensor] = None,
           charges=None) -> EnergyOutput:
    """Single-point SCF energy for a batch of molecules (cf. Energy.forward,
    basics.py:271-346).  Differentiable with respect to ``coordinates``
    and learned parameters; the converged density is held constant
    (backward mode 0, Hellmann-Feynman) or differentiated by the SCF
    adjoint (mode 1) or through the unrolled iterations (mode 2, also
    twice)."""
    with span("system"):
        sp = check_species(cfg, tables, species, charges)
        species = _species_tensor(species, coordinates.device)
        A = species.shape[1]
        _, packK = _resolve_pair_layout(cfg, A)
        packed = _packed_layout(cfg, A)
        sys = make_system(const, species, coordinates, charges,
                          cfg.pair_outer_cutoff, heavy_count=packK,
                          species_host=sp)
        p = _atom_parameters(tables, cfg.method, sys, learned, coordinates)
        Kbeta, g_ss_nuc = _learned_hooks(p)

    if packed is not None:
        # the whole fixed point at the static packed size, no relayouts
        K, n_st = packed
        with span("integrals"):
            M, w, _ = _integral_stack(const, sys, p, cfg, packed_m=n_st,
                                      Kbeta=Kbeta)
        Pp, notconverged = scf_solve(const, sys, M, w, p, cfg.scf, P0,
                                     packed=packed)
        with span("fock"):
            Fp = fock_packed_split(sys, Pp, M, w, p, K, n_st)
        eel = (Pp, Fp, M)
        P = static_unpack_mat(Pp, K, A)
        F = static_unpack_mat(Fp, K, A)
        H = static_unpack_mat(M, K, A)
    else:
        with span("integrals"):
            M, w, w_f = _integral_stack(const, sys, p, cfg, Kbeta=Kbeta)
        P, notconverged = scf_solve(const, sys, M, w, p, cfg.scf, P0)
        with span("fock"):
            F = fock(sys, P, M, w_f, p)
        H = grid_to_mat(M)
        eel = (P, F, H)
    with span("energy"):
        eel_tf = elec_energy_tf(*eel)
        gam = None if g_ss_nuc is None else _hook_gamma(sys, g_ss_nuc)
        EnucAB, enuc_mask = _nuclear_term(const, sys, w, cfg, p, gam)
        Eiso = elec_energy_isolated_atom(const, sys.species, p)
        Hf, Etot, Eel, Enuc, Eiso_sum = assemble_energies(
            const, sys, eel_tf, EnucAB, Eiso, cfg.hf_flag,
            pair_mask=enuc_mask)
    e = charge = None
    if cfg.eig:
        # with_flag surfaces a molecule whose Jacobi sweeps failed (re-solved
        # exactly inside sym_eig) in notconverged, as the SCF flag does
        # (cf. scf_loop.py:753-762)
        e, v, eig_failed = sym_eig(sys, F, eig_only=True, with_flag=True)
        charge = _orbital_charges(sys, v)
        notconverged = notconverged | eig_failed
    return EnergyOutput(Hf, Etot, Eel, Enuc, Eiso_sum, EnucAB, P,
                        notconverged, F=F, Hcore=H, e=e, charge=charge, w=w)


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
    with span("model.force"):
        count("molecules", coordinates.shape[0])
        coords = coordinates.detach().requires_grad_(True)
        with torch.enable_grad():
            out = energy(const, tables, cfg, species, coords, learned, P0,
                         charges)
            Hf = out.Hf.sum()
            with span("backward"):
                (grad,) = torch.autograd.grad(Hf, coords)
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
