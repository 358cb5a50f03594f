"""Energy terms: electronic, core-core, isolated-atom, heat of formation.

PyTorch counterpart of ``pyseqm_tpu/ops/energy.py`` (cf. the reference
seqm/seqm_functions/energy.py:4-118): the plain and compensated electronic
energies, the core-core term on the flat pair list and on the dense grid,
and the compensated Hf assembly.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..constants import A0, Constants
from ..system import System
from .accmath import exp as _exp
from .xsum import TwoFloat, csum, csum2, tf_add, tf_neg, tf_scale


def elec_energy(P, F, Hcore):
    """Eelec = 0.5 sum P o (Hcore + F); all matrices full-symmetric (eV)."""
    return 0.5 * (P * (Hcore + F)).sum(dim=(1, 2))


def elec_energy_xl(D, P, F, Hcore):
    """XL-BOMD functional E(D,P) = Tr(D F) - 0.5 Tr((F - Hcore) P)
    (cf. seqm/XLBOMD.py:40-52)."""
    return (D * F - 0.5 * (F - Hcore) * P).sum(dim=(1, 2))


def elec_energy_tf(P, F, Hcore) -> TwoFloat:
    """Compensated Eelec = 0.5 sum P o (Hcore + F) (eV)."""
    return tf_scale(csum2(P * (Hcore + F)), 0.5)


def elec_energy_xl_tf(D, P, F, Hcore) -> TwoFloat:
    """Compensated XL-BOMD functional Tr(D F) - 0.5 Tr((F - Hcore) P)
    (cf. seqm/XLBOMD.py:40-52)."""
    return csum2(D * F - 0.5 * (F - Hcore) * P)


def elec_energy_isolated_atom(const: Constants, Z, p: Dict[str, torch.Tensor]):
    """Ground-state electronic energy of each isolated atom (eV)."""
    return (p["U_ss"] * const.ussc[Z] + p["U_pp"] * const.uppc[Z]
            + p["g_ss"] * const.gssc[Z] + p["g_pp"] * const.gppc[Z]
            + p["g_sp"] * const.gspc[Z] + p["g_p2"] * const.gp2c[Z]
            + p["h_sp"] * const.hspc[Z])


def _gaussians(p, method):
    """(K, L, M) core-core Gaussian parameters, each (nmol, A, ng); None for
    MNDO."""
    if method == "MNDO":
        return None
    ng = {"AM1": 4, "PM3": 2}[method]
    return tuple(torch.stack([p[f"Gaussian{g + 1}_{c}"] for g in range(ng)],
                             dim=-1) for c in "KLM")


def pair_nuclear_energy(const: Constants, sys: System, gam, method: str,
                        p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Core-core repulsion per flat pair (eV), masked (cf. energy.py:38-78).

    gam: (nmol, NP) = (s_i s_i | s_j s_j) two-center integral.
    """
    iu, ju = sys.pair_i, sys.pair_j
    rija = sys.rij * A0                           # Angstrom
    tore_i, tore_j = const.tore[sys.zi], const.tore[sys.zj]
    t1 = tore_i * tore_j * gam
    # N-H / O-H: the i-side exponential gains a factor r
    xh = ((sys.zi == 7) | (sys.zi == 8)) & (sys.zj == 1)
    t2 = _exp(-p["alpha"][:, iu] * rija) * torch.where(
        xh, rija, torch.ones_like(rija))
    t3 = _exp(-p["alpha"][:, ju] * rija)
    enuc = t1 * (1.0 + t2 + t3)
    g = _gaussians(p, method)
    if g is not None:
        K, L, Mg = g
        r = rija[..., None]
        t5 = (K[:, iu] * _exp(-L[:, iu] * (r - Mg[:, iu]) ** 2)).sum(dim=-1)
        t6 = (K[:, ju] * _exp(-L[:, ju] * (r - Mg[:, ju]) ** 2)).sum(dim=-1)
        enuc = enuc + tore_i * tore_j / rija * (t5 + t6)
    return torch.where(sys.pair_mask, enuc, torch.zeros_like(enuc))


def pair_nuclear_energy_dense(const: Constants, sys: System, gam_grid,
                              method: str, p: Dict[str, torch.Tensor],
                              pair_outer_cutoff: float = 1.0e10,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Core-core repulsion on the ordered (nmol, A, A) grid (cf.
    energy.py:38-78).  The upper triangle selects each pair once; atoms
    sorted by descending Z make the row atom the heavier one.

    gam_grid: (nmol, A, A) (ss|ss) integrals.
    Returns (EnucAB (nmol, A*A), its pair mask (nmol, A*A)).
    """
    from .hcore import dense_pair_geometry

    nmol, A = sys.species.shape
    Z = sys.species
    _, rija, pm_full = dense_pair_geometry(sys, pair_outer_cutoff)
    idx = torch.arange(A, device=Z.device)
    tri = idx[:, None] < idx[None, :]
    pm = pm_full & tri[None]
    rija = torch.where(pm, rija, torch.ones_like(rija))

    row = lambda v: v[:, :, None]                # noqa: E731
    col = lambda v: v[:, None, :]                # noqa: E731
    tore = const.tore[Z]
    t1 = row(tore) * col(tore) * gam_grid
    xh = ((row(Z) == 7) | (row(Z) == 8)) & (col(Z) == 1)
    t2 = _exp(-row(p["alpha"]) * rija) * torch.where(xh, rija,
                                                     torch.ones_like(rija))
    t3 = _exp(-col(p["alpha"]) * rija)
    enuc = t1 * (1.0 + t2 + t3)

    g = _gaussians(p, method)
    if g is not None:
        K, L, Mg = g
        r = rija[..., None]
        rw = lambda v: v[:, :, None, :]          # noqa: E731
        cl = lambda v: v[:, None, :, :]          # noqa: E731
        t5 = (rw(K) * _exp(-rw(L) * (r - rw(Mg)) ** 2)).sum(dim=-1)
        t6 = (cl(K) * _exp(-cl(L) * (r - cl(Mg)) ** 2)).sum(dim=-1)
        enuc = enuc + row(tore) * col(tore) / rija * (t5 + t6)

    enuc = torch.where(pm, enuc, torch.zeros_like(enuc))
    return enuc.reshape(nmol, A * A), pm.reshape(nmol, A * A)


def total_energy(EnucAB, Eelec) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Etot, Enuc) from the per-pair core-core terms."""
    Enuc = EnucAB.sum(dim=-1)
    return Eelec + Enuc, Enuc


def heat_formation(const: Constants, sys: System, Etot, Eiso, hf_flag=True):
    """Hf = Etot - sum_A Eiso_A + sum_A dHf_A (eV); cf. energy.py:97-118."""
    m = sys.atom_mask
    Eiso_sum = torch.where(m, Eiso, torch.zeros_like(Eiso)).sum(dim=-1)
    if hf_flag:
        eh = const.eheat[sys.species]
        eheat_sum = torch.where(m, eh, torch.zeros_like(eh)).sum(dim=-1)
        return Etot - Eiso_sum + eheat_sum, Eiso_sum
    return Etot - Eiso_sum, Eiso_sum


def assemble_energies(const: Constants, sys: System, Eelec_tf: TwoFloat,
                      EnucAB, Eiso, hf_flag=True, pair_mask=None):
    """(Hf, Etot, Eelec, Enuc, Eiso_sum) with every large accumulation and
    the Etot - Eiso cancellation carried as compensated pairs."""
    m = sys.atom_mask
    if pair_mask is None:
        pair_mask = sys.pair_mask
    z = lambda t: torch.zeros_like(t)            # noqa: E731
    Enuc_tf = csum(torch.where(pair_mask, EnucAB, z(EnucAB)))
    Eiso_tf = csum(torch.where(m, Eiso, z(Eiso)))
    Etot_tf = tf_add(Eelec_tf, Enuc_tf)
    Hf_tf = tf_add(Etot_tf, tf_neg(Eiso_tf))
    if hf_flag:
        eh = const.eheat[sys.species]
        Hf_tf = tf_add(Hf_tf, csum(torch.where(m, eh, z(eh))))
    return (Hf_tf.value(), Etot_tf.value(), Eelec_tf.value(),
            Enuc_tf.value(), Eiso_tf.value())
