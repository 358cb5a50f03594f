"""Extended-Lagrangian BOMD energy/force model (no SCF during dynamics).

PyTorch counterpart of ``pyseqm_tpu/models/xlbomd.py`` (cf. EnergyXL /
ForceXL, seqm/XLBOMD.py:54-220): one Hcore build and one Fock build from
the dynamic density field P, one density D (the eigensolver by default, or
SP2) held constant under differentiation, and the XL functional
E(D, P) = Tr(D F) - 1/2 Tr((F - Hcore) P).  ``packed_io`` runs the whole
electronic chain in the static packed layout of the class-segmented dense
grid; otherwise P and D are (nmol, 4A, 4A) on the layout that
``_resolve_pair_layout`` picks, with the optional ``eigh_rescue`` of the
worst SP2 molecules (``SCFConfig.sp2_rescue``).  The learned hooks act as
in ``energy()``: ``Kbeta`` in the Hcore build, ``g_ss_nuc`` in the
core-core term (the JAX package's energy_xl drops g_ss_nuc,
pyseqm_tpu/models/xlbomd.py:77).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import torch

from ..constants import Constants
from ..ops.density import eigh_rescue, sp2, sym_eig
from ..ops.energy import (assemble_energies, elec_energy_isolated_atom,
                          elec_energy_xl_tf)
from ..ops.fock import fock, fock_packed_split
from ..ops.matrix import grid_to_mat
from ..system import make_system
from ..utils.timing import count, span
from .energy import (LearnedParams, SEQMConfig, _atom_parameters,
                     _hook_gamma, _integral_stack, _learned_hooks,
                     _nuclear_term, _packed_layout, _resolve_pair_layout,
                     _species_tensor)


class XLEnergyOutput(NamedTuple):
    Hf: torch.Tensor
    Etot: torch.Tensor
    Eelec: torch.Tensor
    Enuc: torch.Tensor
    Eiso_sum: torch.Tensor
    EnucAB: torch.Tensor
    D: torch.Tensor


def energy_xl(const: Constants, tables: Mapping[str, torch.Tensor],
              cfg: SEQMConfig, species, coordinates: torch.Tensor,
              P: torch.Tensor, learned: Optional[LearnedParams] = None,
              charges=None, packed_io: bool = False) -> XLEnergyOutput:
    """XL-BOMD energy terms given the dynamic density field P.

    ``packed_io``: P is in the static packed layout
    (density.packed_solver_size) and the returned D stays packed; requires
    the class-segmented dense path (scf.pack_heavy).  Otherwise P and D
    are (nmol, 4A, 4A)."""
    with span("system"):
        species = _species_tensor(species, coordinates.device)
        A = species.shape[1]
        _, packK = _resolve_pair_layout(cfg, A)
        sys = make_system(const, species, coordinates, charges,
                          cfg.pair_outer_cutoff, heavy_count=packK)
        p = _atom_parameters(tables, cfg.method, sys, learned, coordinates)
        Kbeta, g_ss_nuc = _learned_hooks(p)
    scf = cfg.scf
    if packed_io:
        packed = _packed_layout(cfg, A)
        if packed is None:
            raise ValueError("packed_io requires the class-segmented dense "
                             "path (scf.pack_heavy) with a packed size "
                             "below 4A")
        if scf.sp2_rescue > 0.0:
            raise ValueError("sp2_rescue applies on the full layout only; "
                             "the packed XL route (packed_io) cannot apply "
                             "it")
        K, n_st = packed
        if P.shape[-1] != n_st:
            raise ValueError(f"packed P has n={P.shape[-1]}, expected "
                             f"packed_solver_size={n_st}")
        with span("integrals"):
            M, w, _ = _integral_stack(const, sys, p, cfg, packed_m=n_st,
                                      Kbeta=Kbeta)
        H = M
        with span("fock"):
            F = fock_packed_split(sys, P, M, w, p, K, n_st)
        # D is built once from F and held constant (XLBOMD.py:124-128).
        # The eigh branch solves the packed F directly: the JAX package
        # unpacks F, solves with pack_heavy and packs D again, which
        # selects the same rows and applies the same 0/1 masks
        with torch.no_grad():
            if scf.use_sp2:
                D = sp2(sys, F.detach(), scf.sp2_eps, scf.sp2_tight_bounds,
                        pack_heavy=K, prepacked=True)
            else:
                D = sym_eig(sys, F.detach(), pack_heavy=K,
                            prepacked=True)[1]
    else:
        with span("integrals"):
            M, w, w_f = _integral_stack(const, sys, p, cfg, Kbeta=Kbeta)
        H = grid_to_mat(M)
        with span("fock"):
            F = fock(sys, P, M, w_f, p)
        with torch.no_grad():
            Fd = F.detach()
            if scf.use_sp2:
                D = sp2(sys, Fd, scf.sp2_eps, scf.sp2_tight_bounds,
                        pack_n=scf.pack_orbitals, pack_heavy=scf.pack_heavy)
                if scf.sp2_rescue > 0.0:
                    # the propagated field P tracks the physical state, so
                    # ||D - P|| sees occupation flips the commutator cannot
                    D = eigh_rescue(sys, Fd, D, scf.sp2_rescue,
                                    ref=P.detach())
            else:
                D = sym_eig(sys, Fd, pack_n=scf.pack_orbitals,
                            pack_heavy=scf.pack_heavy)[1]
    with span("energy"):
        gam = None if g_ss_nuc is None else _hook_gamma(sys, g_ss_nuc)
        EnucAB, enuc_mask = _nuclear_term(const, sys, w, cfg, p, gam)
        Eiso = elec_energy_isolated_atom(const, sys.species, p)
        Hf, Etot, Eelec, Enuc, Eiso_sum = assemble_energies(
            const, sys, elec_energy_xl_tf(D, P, F, H), EnucAB, Eiso,
            cfg.hf_flag, pair_mask=enuc_mask)
    return XLEnergyOutput(Hf, Etot, Eelec, Enuc, Eiso_sum, EnucAB, D)


def force_xl(const: Constants, tables: Mapping[str, torch.Tensor],
             cfg: SEQMConfig, species, coordinates: torch.Tensor,
             P: torch.Tensor, learned: Optional[LearnedParams] = None,
             charges=None, packed_io: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(force, Hf, D): -dHf/dR through the single Fock build
    (cf. ForceXL, XLBOMD.py:189-220); ``packed_io``: see energy_xl."""
    with span("model.force"):
        count("molecules", coordinates.shape[0])
        coords = coordinates.detach().requires_grad_(True)
        with torch.enable_grad():
            out = energy_xl(const, tables, cfg, species, coords, P.detach(),
                            learned, charges, packed_io)
            Hf = out.Hf.sum()
            with span("backward"):
                (grad,) = torch.autograd.grad(Hf, coords)
        return -grad, out.Hf.detach(), out.D
