"""Extended-Lagrangian BOMD energy/force model (no SCF during dynamics).

PyTorch counterpart of ``pyseqm_tpu/models/xlbomd.py`` on its ``packed_io``
route (cf. EnergyXL / ForceXL, seqm/XLBOMD.py:54-220): one Hcore build and
one Fock build from the dynamic density field P, one density D (the packed
eigensolver by default, or SP2) held constant under differentiation, and
the XL functional E(D, P) = Tr(D F) - 1/2 Tr((F - Hcore) P), all in the static packed layout.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import torch

from ..constants import Constants
from ..ops.density import sp2, sym_eig
from ..ops.energy import (assemble_energies, elec_energy_isolated_atom,
                          elec_energy_xl_tf)
from ..ops.fock import fock_packed_split
from ..system import make_system
from .energy import (LearnedParams, SEQMConfig, _atom_parameters,
                     _integral_stack, _nuclear_term, _packed_layout,
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
              charges=None) -> XLEnergyOutput:
    """XL-BOMD energy terms given the dynamic density field P, which is in
    the static packed layout (density.packed_solver_size); the returned D
    stays packed."""
    species = _species_tensor(species, coordinates.device)
    K, n_st = _packed_layout(cfg, species.shape[1])
    if P.shape[-1] != n_st:
        raise ValueError(f"packed P has n={P.shape[-1]}, expected "
                         f"packed_solver_size={n_st}")
    sys = make_system(const, species, coordinates, charges,
                      cfg.pair_outer_cutoff, heavy_count=K)
    p = _atom_parameters(tables, cfg.method, sys, learned, coordinates)
    M, w = _integral_stack(const, sys, p, cfg, K, n_st)
    F = fock_packed_split(sys, P, M, w, p, K, n_st)
    # D is built once from F and held constant (XLBOMD.py:124-128).  The
    # eigh branch solves the packed F directly: the JAX package unpacks F,
    # solves with pack_heavy and packs D again, which selects the same rows
    # and applies the same 0/1 masks
    with torch.no_grad():
        if cfg.scf.use_sp2:
            D = sp2(sys, F.detach(), cfg.scf.sp2_eps, pack_heavy=K,
                    prepacked=True)
        else:
            D = sym_eig(sys, F.detach(), pack_heavy=K, prepacked=True)[1]
    EnucAB, enuc_mask = _nuclear_term(const, sys, w, cfg, p)
    Eiso = elec_energy_isolated_atom(const, sys.species, p)
    Hf, Etot, Eelec, Enuc, Eiso_sum = assemble_energies(
        const, sys, elec_energy_xl_tf(D, P, F, M), EnucAB, Eiso,
        cfg.hf_flag, pair_mask=enuc_mask)
    return XLEnergyOutput(Hf, Etot, Eelec, Enuc, Eiso_sum, EnucAB, D)


def force_xl(const: Constants, tables: Mapping[str, torch.Tensor],
             cfg: SEQMConfig, species, coordinates: torch.Tensor,
             P: torch.Tensor, learned: Optional[LearnedParams] = None,
             charges=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(force, Hf, D): -dHf/dR through the single Fock build
    (cf. ForceXL, XLBOMD.py:189-220)."""
    coords = coordinates.detach().requires_grad_(True)
    with torch.enable_grad():
        out = energy_xl(const, tables, cfg, species, coords, P.detach(),
                        learned, charges)
        (grad,) = torch.autograd.grad(out.Hf.sum(), coords)
    return -grad, out.Hf.detach(), out.D
