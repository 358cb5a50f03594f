"""Core Hamiltonian assembly on the class-segmented dense layout.

PyTorch counterpart of the main-path part of ``pyseqm_tpu/ops/hcore.py``
(cf. the reference hcore, seqm/seqm_functions/hcore.py:6-167):
``atom_multipoles``, ``dense_pair_geometry`` and ``hcore_dense_split`` with
the core Hamiltonian returned as the static packed matrix.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..constants import Constants, LENGTH_CONVERSION_FACTOR, OVERLAP_CUTOFF
from ..system import System
from .matrix import assemble_packed_mat
from .multipole import dd_qq, rho1_additive, rho2_additive
from .overlap import diatom_overlap, diatom_overlap_hh, diatom_overlap_xh
from .tetci import (WPackGrid, WPackGridSplit, _core_block, frame_matrix,
                    local_frame_integrals, local_frame_integrals_hh,
                    pair_w_xh)


def atom_multipoles(const: Constants, species, p: Dict[str, torch.Tensor]):
    """Per-atom multipole separations & Klopman additive terms
    (cf. two_elec_two_center_int.py:22-43): dict of dd, qq, rho0, rho1,
    rho2 shaped like ``species``."""
    Z = species
    is_h = Z == 1
    is_x = Z > 2
    has_core = is_h | is_x
    one = torch.ones_like(p["g_ss"])
    zero = torch.zeros_like(one)

    qn0 = const.qn[Z]
    gss = p["g_ss"]
    hsp = p["h_sp"]
    hpp = 0.5 * (p["g_pp"] - p["g_p2"])

    zs = torch.where(is_x, p["zeta_s"], one)
    zp = torch.where(is_x, p["zeta_p"], one)
    dd, qq = dd_qq(torch.where(is_x, qn0, one), zs, zp)
    dd = torch.where(is_x, dd, zero)
    qq = torch.where(is_x, qq, zero)

    rho0 = torch.where(has_core, 0.5 * 27.21 / torch.where(has_core, gss, one),
                       zero)
    rho1 = rho1_additive(hsp, dd, is_x)
    rho2 = rho2_additive(hpp, qq, is_x)
    return {"dd": dd, "qq": qq, "rho0": rho0, "rho1": rho1, "rho2": rho2}


def dense_pair_geometry(sys: System, pair_outer_cutoff: float):
    """Shared (nmol, A, A) ordered-pair geometry: dvec[n, i, j] = x_j - x_i,
    dist in Angstrom, pm the off-diagonal valid-pair mask (atom masks, no
    self-pairs, outer cutoff).  Single source of the zero-distance guard
    for the Hcore and the nuclear term.  Differentiable."""
    x = sys.coordinates
    am = sys.atom_mask
    A = x.shape[1]
    dvec = x[:, None, :, :] - x[:, :, None, :]
    eye = torch.eye(A, dtype=torch.bool, device=x.device)
    pm = am[:, :, None] & am[:, None, :] & ~eye[None]
    dist2 = (dvec * dvec).sum(dim=-1)
    dist2 = torch.where(dist2 == 0.0, torch.full_like(dist2, 1.0e-4), dist2)
    dist = torch.sqrt(dist2)
    pm = pm & (dist < pair_outer_cutoff)
    return dvec, dist, pm


def _diag_add(blk, d0, dp):
    """blk (..., 4, 4) + diag(d0, dp, dp, dp)."""
    return blk + torch.diag_embed(torch.stack([d0, dp, dp, dp], dim=-1))


def hcore_dense_split(
    const: Constants,
    sys: System,
    p: Dict[str, torch.Tensor],
    K: int,
    packed_m: int,
    pair_outer_cutoff: float = 1.0e10,
    precise_overlap: bool = True,
) -> Tuple[torch.Tensor, WPackGridSplit]:
    """Class-segmented gather-free core Hamiltonian and integrals.

    Keyed on the batch-max heavy count K: the [0:K, 0:K] ordered sub-grid
    runs the full 22-integral machinery (with qn-swapped overlap cells: a
    molecule with fewer than K heavies has hydrogens inside the block), the
    [0:K, K:A] block the 4-integral X-H class (column atoms are s-only in
    every molecule by the descending-Z sort), the [K:A, K:A] block the
    scalar (ss|ss).  M comes back as the (nmol, packed_m, packed_m) static
    packed matrix (packed_m = density.packed_solver_size(K, A)).
    """
    nmol, A = sys.species.shape
    AH = A - K
    am = sys.atom_mask

    dvec, dist, pm = dense_pair_geometry(sys, pair_outer_cutoff)
    one = torch.ones_like(dist)
    rij = torch.where(pm, dist * LENGTH_CONVERSION_FACTOR, one)
    ez = torch.eye(3, dtype=dist.dtype, device=dist.device)[2]
    xij = torch.where(pm[..., None], dvec / dist[..., None], ez)
    ov_mask = pm & (rij <= OVERLAP_CUTOFF)
    # sanitize rij beyond the overlap cutoff: the r^5 prefactors times the
    # clamped B integrals overflow f32 in the backward there
    rij_ov = torch.where(ov_mask, rij, one)

    qn = const.qn_int[sys.species]
    zeta = torch.stack([p["zeta_s"], p["zeta_p"]], dim=-1)   # (nmol, A, 2)
    tore = const.tore[sys.species]
    mp = atom_multipoles(const, sys.species, p)
    bi_full = torch.stack([p["beta_s"], p["beta_p"], p["beta_p"],
                           p["beta_p"]], dim=-1)             # (nmol, A, 4)
    row = lambda v, s: v[:, s, None]                        # noqa: E731
    col = lambda v, s: v[:, None, s]                        # noqa: E731
    z4 = lambda t: torch.zeros_like(t)                       # noqa: E731

    # ---- XX sub-grid [0:K, 0:K]: full ordered cells ----
    sH = slice(0, K)
    qni = qn[:, sH, None].expand(nmol, K, K)
    qnj = qn[:, None, sH].expand(nmol, K, K)
    swap = qni < qnj
    z_i = zeta[:, sH, None, :].expand(nmol, K, K, 2)
    z_j = zeta[:, None, sH, :].expand(nmol, K, K, 2)
    za = torch.where(swap[..., None], z_j, z_i)
    zb = torch.where(swap[..., None], z_i, z_j)
    xij_xx = xij[:, sH, sH]
    xeff = torch.where(swap[..., None], -xij_xx, xij_xx)
    di = diatom_overlap(torch.maximum(qni, qnj), torch.minimum(qni, qnj),
                        xeff, rij_ov[:, sH, sH], za, zb,
                        precise=precise_overlap)
    di = torch.where(swap[..., None, None], di.transpose(-1, -2), di)
    di = torch.where(ov_mask[:, sH, sH][..., None, None], di, z4(di))
    beta_xx = 0.5 * (bi_full[:, sH, None, :, None]
                     + bi_full[:, None, sH, None, :])
    off_xx = di * beta_xx

    pm_xx = pm[:, sH, sH]
    ri_xx, core_a, _ = local_frame_integrals(
        rij[:, sH, sH], row(tore, sH), col(tore, sH),
        row(mp["dd"], sH), col(mp["dd"], sH),
        row(mp["qq"], sH), col(mp["qq"], sH),
        row(mp["rho0"], sH), col(mp["rho0"], sH),
        row(mp["rho1"], sH), col(mp["rho1"], sH),
        row(mp["rho2"], sH), col(mp["rho2"], sH))
    ri_xx = torch.where(pm_xx[..., None], ri_xx, z4(ri_xx))
    U_xx = frame_matrix(xij_xx)
    e1b = _core_block(U_xx, core_a)
    e1b = torch.where(pm_xx[..., None, None], e1b, z4(e1b))
    dblk_h = e1b.sum(dim=2)                             # (nmol, K, 4, 4)

    # ---- XH block [0:K, K:A]: 4-integral class, s-only columns ----
    sL = slice(K, A)
    pm_xh = pm[:, sH, sL]
    col_ov = diatom_overlap_xh(
        qn[:, sH, None].expand(nmol, K, AH),
        qn[:, None, sL].expand(nmol, K, AH),
        xij[:, sH, sL], rij_ov[:, sH, sL],
        zeta[:, sH, None, :].expand(nmol, K, AH, 2),
        p["zeta_s"][:, None, sL].expand(nmol, K, AH),
        precise=precise_overlap)
    col_ov = torch.where(ov_mask[:, sH, sL][..., None], col_ov, z4(col_ov))
    beta_xh = 0.5 * (bi_full[:, sH, None, :] + p["beta_s"][:, None, sL, None])
    off_xh = col_ov * beta_xh                           # (nmol, K, AH, 4)
    wxh, e1b_xh, e2a_ss = pair_w_xh(
        rij[:, sH, sL], xij[:, sH, sL],
        row(tore, sH), col(tore, sL),
        row(mp["dd"], sH), row(mp["qq"], sH),
        row(mp["rho0"], sH), col(mp["rho0"], sL),
        row(mp["rho1"], sH), row(mp["rho2"], sH))
    wxh = torch.where(pm_xh[..., None, None], wxh, z4(wxh))
    dblk_h = dblk_h + torch.where(pm_xh[..., None, None], e1b_xh,
                                  z4(e1b_xh)).sum(dim=2)
    dl00 = torch.where(pm_xh, e2a_ss, z4(e2a_ss)).sum(dim=1)   # (nmol, AH)

    # ---- HH block [K:A, K:A]: scalar (ss|ss) ----
    pm_hh = pm[:, sL, sL]
    s111 = diatom_overlap_hh(
        qn[:, sL, None].expand(nmol, AH, AH),
        qn[:, None, sL].expand(nmol, AH, AH),
        rij_ov[:, sL, sL],
        p["zeta_s"][:, sL, None].expand(nmol, AH, AH),
        p["zeta_s"][:, None, sL].expand(nmol, AH, AH),
        precise=precise_overlap)
    s111 = torch.where(ov_mask[:, sL, sL], s111, z4(s111))
    off_hh = s111 * 0.5 * (p["beta_s"][:, sL, None] + p["beta_s"][:, None, sL])
    whh = local_frame_integrals_hh(rij[:, sL, sL], row(mp["rho0"], sL),
                                   col(mp["rho0"], sL))
    whh = torch.where(pm_hh, whh, z4(whh))
    # ordered row sum covers both electron/core orientations
    dl00 = dl00 + (-col(tore, sL) * whh).sum(dim=2)

    # ---- assemble M in the static packed layout ----
    zK = torch.zeros_like(p["U_ss"][:, sH])
    uss = torch.where(am[:, sH], p["U_ss"][:, sH], zK)
    upp = torch.where(am[:, sH], p["U_pp"][:, sH], zK)
    dblk_h = _diag_add(dblk_h, uss, upp)
    dl00 = dl00 + torch.where(am[:, sL], p["U_ss"][:, sL],
                              torch.zeros_like(dl00))
    eyeK = torch.eye(K, dtype=torch.bool, device=dblk_h.device)
    xx_grid = torch.where(eyeK[None, :, :, None, None], dblk_h[:, :, None],
                          off_xx)
    Mp = assemble_packed_mat(xx_grid, off_xh, off_hh, dl00, packed_m)
    w_out = WPackGridSplit(xx=WPackGrid(rig=ri_xx, ug=U_xx), xh=wxh, hh=whh)
    return Mp, w_out
