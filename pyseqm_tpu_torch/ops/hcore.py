"""Core Hamiltonian assembly and two-electron integrals.

PyTorch counterpart of ``pyseqm_tpu/ops/hcore.py`` (cf. the reference
hcore, seqm/seqm_functions/hcore.py:6-167): ``atom_multipoles``, the flat
pair-list ``hcore`` (optionally placing its integrals on the grid),
``dense_pair_geometry``, the ordered-pair ``hcore_dense`` for large
molecules, the class-segmented ``hcore_dense_split``, whose core
Hamiltonian comes back as the static packed matrix or as the block grid,
and the class-segmented flat pair list ``hcore_split``.  ``row3`` (each
of them) adds the row-3 overlap classes (ops/overlap_general.py), and
``Kbeta`` (each of them) scales every pair's resonance block by learned
per-pair factors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import (_QN, Constants, LENGTH_CONVERSION_FACTOR,
                         OVERLAP_CUTOFF)
from ..system import System, pair_segment_sizes
from .matrix import assemble_packed_mat, block00, col0_block
from .multipole import dd_qq, rho1_additive, rho2_additive
from .overlap import diatom_overlap, diatom_overlap_hh, diatom_overlap_xh
from .tetci import (WPack, WPackGrid, WPackGridSplit, WPackSplit,
                    _core_block,
                    frame_matrix, local_frame_integrals,
                    local_frame_integrals_hh, pair_w_pack, pair_w_xh,
                    to_grid)


def atom_multipoles(const: Constants, species, p: Dict[str, torch.Tensor],
                    K: Optional[int] = None):
    """Per-atom multipole separations & Klopman additive terms
    (cf. two_elec_two_center_int.py:22-43): dict of dd, qq, rho0, rho1,
    rho2 shaped like ``species``.  With the batch's heavy count ``K`` (the
    descending-Z sort puts every heavy atom in the first K slots) rho1 and
    rho2 are solved on those slots alone."""
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
    if K is None:
        rho1 = rho1_additive(hsp, dd, is_x)
        rho2 = rho2_additive(hpp, qq, is_x)
    else:
        pad = (0, Z.shape[-1] - K)
        rho1 = F.pad(rho1_additive(hsp[:, :K], dd[:, :K], is_x[:, :K]), pad)
        rho2 = F.pad(rho2_additive(hpp[:, :K], qq[:, :K], is_x[:, :K]), pad)
    return {"dd": dd, "qq": qq, "rho0": rho0, "rho1": rho1, "rho2": rho2}


def _diag_add(blk, d0, dp):
    """blk (..., 4, 4) + diag(d0, dp, dp, dp)."""
    return blk + torch.diag_embed(torch.stack([d0, dp, dp, dp], dim=-1))


def _kbeta_block(kb):
    """The (..., 4, 4) scale of a pair's resonance block from its four
    learned factors kb (..., 4) = (ss, sp, ps, pp) (the Kbeta hook,
    cf. the reference hcore.py:138-143)."""
    k0, k1, k2, k3 = kb.unbind(-1)
    row_s = torch.stack([k0, k1, k1, k1], dim=-1)
    row_p = torch.stack([k2, k3, k3, k3], dim=-1)
    return torch.stack([row_s, row_p, row_p, row_p], dim=-2)


def _kbeta_col(kb):
    """The (..., 4) scale of an X-H pair's resonance column (heavy
    orbitals against the hydrogen s): (ss, ps, ps, ps)."""
    return torch.cat([kb[..., 0:1], kb[..., 2:3].expand(kb.shape[:-1] + (3,))],
                     dim=-1)


def _kbeta_grid(Kbeta, sys: System):
    """The per-pair factors (nmol, NP, 4), in the order of the System's
    pair list, mirrored onto the ordered (nmol, A, A, 4) grid: the cell
    (j, i) of a pair takes its transposed block's factors (ss, ps, sp,
    pp)."""
    nmol, A = sys.species.shape
    iu, ju = sys.pair_i, sys.pair_j
    kg = Kbeta.new_zeros((nmol, A, A, 4))
    kg[:, iu, ju] = Kbeta
    kg[:, ju, iu] = Kbeta[..., [0, 2, 1, 3]]
    return kg


def _qn_host(sys: System) -> Optional[np.ndarray]:
    """Host principal quantum numbers (nmol, A), None without host
    species."""
    if sys.species_host is None:
        return None
    return np.asarray(_QN, np.int64)[sys.species_host]


def _qn_pairs_host(sys: System, s=slice(None)):
    """Host (qn_i, qn_j) of the pair list's slice ``s``, or None."""
    qh = _qn_host(sys)
    if qh is None:
        return None
    iu, ju = sys.pair_host
    return qh[:, iu[s]], qh[:, ju[s]]


def hcore(const: Constants, sys: System, p: Dict[str, torch.Tensor],
          dense_grid: bool = False, precise_overlap: bool = True,
          row3: bool = False, Kbeta: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, Union[WPack, WPackGrid]]:
    """Core Hamiltonian block grid and two-electron integrals on the flat
    (i < j) pair list.

    Returns M (nmol, A, A, 4, 4), the symmetric core Hamiltonian grid (eV),
    and the compact integrals: WPack (ri (nmol, NP, 22), U (nmol, NP, 4,
    4)), or with ``dense_grid`` the same placed on the ordered grid
    (WPackGrid, tetci.to_grid), so the SCF's Fock builds need no scatters.
    ``Kbeta`` (nmol, NP, 4): per-pair factors of the resonance blocks (the
    learned hook), in the pair list's order.
    """
    nmol, A = sys.species.shape
    iu, ju = sys.pair_i, sys.pair_j
    am, pm = sys.atom_mask, sys.pair_mask

    # ---- overlap x resonance (off-diagonal blocks) ----
    zeta = torch.stack([p["zeta_s"], p["zeta_p"]], dim=-1)  # (nmol, A, 2)
    ov_mask = pm & (sys.rij <= OVERLAP_CUTOFF)
    # evaluate masked-out pairs at a harmless rij: beyond the cutoff the
    # r^5 prefactors times the clamped B integrals overflow f32 in the
    # backward
    rij_ov = torch.where(ov_mask, sys.rij, torch.ones_like(sys.rij))
    di = diatom_overlap(const.qn_int[sys.zi], const.qn_int[sys.zj], sys.xij,
                        rij_ov, zeta[:, iu], zeta[:, ju],
                        precise=precise_overlap, row3=row3,
                        qn_host=_qn_pairs_host(sys) if row3 else None)
    di = torch.where(ov_mask[..., None, None], di, torch.zeros_like(di))
    bi = torch.stack([p["beta_s"], p["beta_p"], p["beta_p"], p["beta_p"]],
                     dim=-1)                                 # (nmol, A, 4)
    off = di * 0.5 * (bi[:, iu, :, None] + bi[:, ju, None, :])
    if Kbeta is not None:
        off = off * _kbeta_block(Kbeta)

    # ---- two-electron two-center integrals (compact representation) ----
    mp = atom_multipoles(const, sys.species, p)
    w, e1b, e2a = pair_w_pack(
        sys.rij, sys.xij, const.tore[sys.zi], const.tore[sys.zj],
        mp["dd"][:, iu], mp["dd"][:, ju], mp["qq"][:, iu], mp["qq"][:, ju],
        mp["rho0"][:, iu], mp["rho0"][:, ju],
        mp["rho1"][:, iu], mp["rho1"][:, ju],
        mp["rho2"][:, iu], mp["rho2"][:, ju])
    z4 = lambda t: torch.zeros_like(t)                       # noqa: E731
    w = WPack(ri=torch.where(pm[..., None], w.ri, z4(w.ri)), U=w.U)
    e1b = torch.where(pm[..., None, None], e1b, z4(e1b))
    e2a = torch.where(pm[..., None, None], e2a, z4(e2a))

    # ---- diagonal blocks: U_ss/U_pp + summed electron-core attraction ----
    zA = torch.zeros_like(p["U_ss"])
    dblk = torch.diag_embed(torch.stack(
        [torch.where(am, p["U_ss"], zA)] + 3 * [torch.where(am, p["U_pp"],
                                                            zA)], dim=-1))
    dblk = dblk.index_add(1, iu, e1b).index_add(1, ju, e2a)

    # ---- assemble the symmetric grid ----
    M = off.new_zeros((nmol, A, A, 4, 4))
    idx = torch.arange(A, device=off.device)
    M[:, idx, idx] = dblk
    M[:, iu, ju] = off
    M[:, ju, iu] = off.transpose(-1, -2)
    if dense_grid:
        return M, to_grid(w, A, iu, ju)
    return M, w


def hcore_split(const: Constants, sys: System, p: Dict[str, torch.Tensor],
                K: int, precise_overlap: bool = True, row3: bool = False,
                Kbeta: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, WPackSplit]:
    """Class-segmented flat pair list: per-pair-class integral formulas on
    the static segments of pair_index_packed (the System built with
    make_system(heavy_count=K)).  XX pairs (i < j < K) run the full
    22-integral pipeline, XH pairs (i < K <= j, j s-only by the
    descending-Z sort) the 4-integral one, HH pairs (K <= i) the single
    integral.  Matches hcore() on every physical matrix element; the dead
    hydrogen p positions hold zeros.  ``Kbeta`` (nmol, NP, 4): the learned
    resonance factors in the class-segmented pair order.  Returns (M
    (nmol, A, A, 4, 4), WPackSplit)."""
    nmol, A = sys.species.shape
    n_xx, n_xh, n_hh = pair_segment_sizes(A, K)
    if sys.npairs != n_xx + n_xh + n_hh:
        raise ValueError("System pair list does not match heavy_count "
                         f"{K} (build with make_system(heavy_count={K}))")
    segs = (slice(0, n_xx), slice(n_xx, n_xx + n_xh),
            slice(n_xx + n_xh, None))
    s_xx, s_xh, s_hh = segs
    iu, ju = sys.pair_i, sys.pair_j
    am = sys.atom_mask
    z4 = lambda t: torch.zeros_like(t)                       # noqa: E731

    mp = atom_multipoles(const, sys.species, p, K)
    tore = const.tore[sys.species]
    zeta = torch.stack([p["zeta_s"], p["zeta_p"]], dim=-1)   # (nmol, A, 2)
    qn = const.qn_int[sys.species]
    bi_full = torch.stack([p["beta_s"], p["beta_p"], p["beta_p"],
                           p["beta_p"]], dim=-1)             # (nmol, A, 4)
    ai = lambda v, s: v[:, iu[s]]                            # noqa: E731
    aj = lambda v, s: v[:, ju[s]]                            # noqa: E731
    ov_mask = sys.pair_mask & (sys.rij <= OVERLAP_CUTOFF)
    rij_ov = torch.where(ov_mask, sys.rij, torch.ones_like(sys.rij))

    # ---- XX segment: full 22-integral pipeline ----
    pm = sys.pair_mask[:, s_xx]
    di = diatom_overlap(ai(qn, s_xx), aj(qn, s_xx), sys.xij[:, s_xx],
                        rij_ov[:, s_xx], ai(zeta, s_xx), aj(zeta, s_xx),
                        precise=precise_overlap, row3=row3,
                        qn_host=_qn_pairs_host(sys, s_xx) if row3 else None)
    di = torch.where(ov_mask[:, s_xx][..., None, None], di, z4(di))
    off_xx = di * 0.5 * (ai(bi_full, s_xx)[..., :, None]
                         + aj(bi_full, s_xx)[..., None, :])
    if Kbeta is not None:
        off_xx = off_xx * _kbeta_block(Kbeta[:, s_xx])
    wxx, e1b, e2a = pair_w_pack(
        sys.rij[:, s_xx], sys.xij[:, s_xx], ai(tore, s_xx), aj(tore, s_xx),
        ai(mp["dd"], s_xx), aj(mp["dd"], s_xx),
        ai(mp["qq"], s_xx), aj(mp["qq"], s_xx),
        ai(mp["rho0"], s_xx), aj(mp["rho0"], s_xx),
        ai(mp["rho1"], s_xx), aj(mp["rho1"], s_xx),
        ai(mp["rho2"], s_xx), aj(mp["rho2"], s_xx))
    wxx = WPack(ri=torch.where(pm[..., None], wxx.ri, z4(wxx.ri)), U=wxx.U)
    ei_xx = torch.where(pm[..., None, None], e1b, z4(e1b))
    ej_xx = torch.where(pm[..., None, None], e2a, z4(e2a))

    # ---- XH segment: 4-integral pipeline, s-only ket ----
    pm = sys.pair_mask[:, s_xh]
    col = diatom_overlap_xh(ai(qn, s_xh), aj(qn, s_xh), sys.xij[:, s_xh],
                            rij_ov[:, s_xh], ai(zeta, s_xh),
                            aj(p["zeta_s"], s_xh), precise=precise_overlap,
                            row3=row3, qn_host=(_qn_pairs_host(sys, s_xh)
                                                if row3 else None))
    col = torch.where(ov_mask[:, s_xh][..., None], col, z4(col))
    off_xh = col * 0.5 * (ai(bi_full, s_xh)
                          + aj(p["beta_s"], s_xh)[..., None])
    if Kbeta is not None:
        off_xh = off_xh * _kbeta_col(Kbeta[:, s_xh])
    wxh, e1b, e2a_ss = pair_w_xh(
        sys.rij[:, s_xh], sys.xij[:, s_xh], ai(tore, s_xh), aj(tore, s_xh),
        ai(mp["dd"], s_xh), ai(mp["qq"], s_xh),
        ai(mp["rho0"], s_xh), aj(mp["rho0"], s_xh),
        ai(mp["rho1"], s_xh), ai(mp["rho2"], s_xh))
    wxh = torch.where(pm[..., None, None], wxh, z4(wxh))
    ei_xh = torch.where(pm[..., None, None], e1b, z4(e1b))
    ej_xh = block00(torch.where(pm, e2a_ss, z4(e2a_ss)))

    # ---- HH segment: single-integral pipeline ----
    pm = sys.pair_mask[:, s_hh]
    s111 = diatom_overlap_hh(ai(qn, s_hh), aj(qn, s_hh), rij_ov[:, s_hh],
                             ai(p["zeta_s"], s_hh), aj(p["zeta_s"], s_hh),
                             precise=precise_overlap)
    s111 = torch.where(ov_mask[:, s_hh], s111, z4(s111))
    off_hh = s111 * 0.5 * (ai(p["beta_s"], s_hh) + aj(p["beta_s"], s_hh))
    if Kbeta is not None:
        off_hh = off_hh * Kbeta[:, s_hh, 0]
    whh = local_frame_integrals_hh(sys.rij[:, s_hh], ai(mp["rho0"], s_hh),
                                   aj(mp["rho0"], s_hh))
    whh = torch.where(pm, whh, z4(whh))
    ei_hh = block00(-aj(tore, s_hh) * whh)
    ej_hh = block00(-ai(tore, s_hh) * whh)

    # ---- assemble the symmetric grid: each pair once per orientation ----
    off = torch.cat([off_xx, col0_block(off_xh), block00(off_hh)], dim=1)
    zA = torch.zeros_like(p["U_ss"])
    dblk = torch.diag_embed(torch.stack(
        [torch.where(am, p["U_ss"], zA)] + 3 * [torch.where(am, p["U_pp"],
                                                            zA)], dim=-1))
    dblk = dblk.index_add(1, iu, torch.cat([ei_xx, ei_xh, ei_hh], dim=1))
    dblk = dblk.index_add(1, ju, torch.cat([ej_xx, ej_xh, ej_hh], dim=1))
    M = off.new_zeros((nmol, A, A, 4, 4))
    idx = torch.arange(A, device=off.device)
    M[:, iu, ju] = off
    M[:, ju, iu] = off.transpose(-1, -2)
    M[:, idx, idx] = dblk
    return M, WPackSplit(xx=wxx, xh=wxh, hh=whh)


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


def _dense_cells(sys: System, pair_outer_cutoff: float):
    """(pm, rij in Bohr, xij, overlap mask, rij for the overlap) on the
    ordered grid; masked cells get rij = 1 and the z axis."""
    dvec, dist, pm = dense_pair_geometry(sys, pair_outer_cutoff)
    one = torch.ones_like(dist)
    rij = torch.where(pm, dist * LENGTH_CONVERSION_FACTOR, one)
    ez = torch.eye(3, dtype=dist.dtype, device=dist.device)[2]
    xij = torch.where(pm[..., None], dvec / dist[..., None], ez)
    ov_mask = pm & (rij <= OVERLAP_CUTOFF)
    # sanitize rij beyond the overlap cutoff: the r^5 prefactors times the
    # clamped B integrals overflow f32 in the backward there
    return pm, rij, xij, ov_mask, torch.where(ov_mask, rij, one)


def _xx_cells(const, sys, p, mp, rij, xij, pm, ov_mask, rij_ov, s,
              precise_overlap, row3=False):
    """Full 22-integral machinery on the ordered sub-grid [s, s]: (off
    (nmol, n, n, 4, 4) overlap x resonance, with qn-swapped cells, ri,
    U, the row-summed electron-core blocks (nmol, n, 4, 4))."""
    nmol = sys.species.shape[0]
    qn = const.qn_int[sys.species]
    zeta = torch.stack([p["zeta_s"], p["zeta_p"]], dim=-1)   # (nmol, A, 2)
    bi_full = torch.stack([p["beta_s"], p["beta_p"], p["beta_p"],
                           p["beta_p"]], dim=-1)             # (nmol, A, 4)
    tore = const.tore[sys.species]
    n = qn[:, s].shape[1]
    row = lambda v: v[:, s, None]                           # noqa: E731
    col = lambda v: v[:, None, s]                           # noqa: E731
    z4 = lambda t: torch.zeros_like(t)                       # noqa: E731

    # overlap blocks want the heavier atom first: cells with qn_i < qn_j
    # swap roles and transpose the block
    qni = qn[:, s, None].expand(nmol, n, n)
    qnj = qn[:, None, s].expand(nmol, n, n)
    swap = qni < qnj
    z_i = zeta[:, s, None, :].expand(nmol, n, n, 2)
    z_j = zeta[:, None, s, :].expand(nmol, n, n, 2)
    za = torch.where(swap[..., None], z_j, z_i)
    zb = torch.where(swap[..., None], z_i, z_j)
    xc = xij[:, s, s]
    xeff = torch.where(swap[..., None], -xc, xc)
    qh = _qn_host(sys) if row3 else None
    if qh is not None:
        qh = (np.maximum(qh[:, s, None], qh[:, None, s]),
              np.minimum(qh[:, s, None], qh[:, None, s]))
    di = diatom_overlap(torch.maximum(qni, qnj), torch.minimum(qni, qnj),
                        xeff, rij_ov[:, s, s], za, zb,
                        precise=precise_overlap, row3=row3, qn_host=qh)
    di = torch.where(swap[..., None, None], di.transpose(-1, -2), di)
    di = torch.where(ov_mask[:, s, s][..., None, None], di, z4(di))
    off = di * 0.5 * (bi_full[:, s, None, :, None]
                      + bi_full[:, None, s, None, :])

    pmc = pm[:, s, s]
    ri, core_a, _ = local_frame_integrals(
        rij[:, s, s], row(tore), col(tore),
        row(mp["dd"]), col(mp["dd"]), row(mp["qq"]), col(mp["qq"]),
        row(mp["rho0"]), col(mp["rho0"]), row(mp["rho1"]), col(mp["rho1"]),
        row(mp["rho2"]), col(mp["rho2"]))
    ri = torch.where(pmc[..., None], ri, z4(ri))
    U = frame_matrix(xc)
    e1b = _core_block(U, core_a)
    # each ordered cell (i, j) is "electron on i, core of j": the row sum
    # covers both of the flat path's e1b/e2a halves
    dblk = torch.where(pmc[..., None, None], e1b, z4(e1b)).sum(dim=2)
    return off, ri, U, dblk


def _with_diag_cells(off, dblk):
    """The (nmol, n, n, 4, 4) cells ``off`` with the diagonal cells
    replaced by dblk (nmol, n, 4, 4)."""
    n = off.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=off.device)
    return torch.where(eye[None, :, :, None, None], dblk[:, :, None], off)


def hcore_dense(const: Constants, sys: System, p: Dict[str, torch.Tensor],
                pair_outer_cutoff: float = 1.0e10,
                precise_overlap: bool = True, row3: bool = False,
                Kbeta: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, WPackGrid]:
    """Gather-free ordered-pair core Hamiltonian for large molecules.

    Every pairwise quantity is built on the full ordered (nmol, A, A) grid
    by row/column broadcasting of per-atom arrays, both (i, j) and (j, i)
    evaluated; each cell computes its own (ri, U) with the bra on the row
    atom, which is WPackGrid's contract.  ``Kbeta`` (nmol, NP, 4): the
    learned resonance factors of the (i < j) pairs, mirrored onto the
    grid.  Returns (M (nmol, A, A, 4, 4), WPackGrid); M matches hcore()'s
    grid.
    """
    am = sys.atom_mask
    pm, rij, xij, ov_mask, rij_ov = _dense_cells(sys, pair_outer_cutoff)
    mp = atom_multipoles(const, sys.species, p)
    off, ri, U, dblk = _xx_cells(const, sys, p, mp, rij, xij, pm, ov_mask,
                                 rij_ov, slice(None), precise_overlap, row3)
    if Kbeta is not None:
        off = off * _kbeta_block(_kbeta_grid(Kbeta, sys))
    zA = torch.zeros_like(p["U_ss"])
    dblk = _diag_add(dblk, torch.where(am, p["U_ss"], zA),
                     torch.where(am, p["U_pp"], zA))
    return _with_diag_cells(off, dblk), WPackGrid(rig=ri, ug=U)


def hcore_dense_split(
    const: Constants,
    sys: System,
    p: Dict[str, torch.Tensor],
    K: int,
    packed_m: Optional[int] = None,
    pair_outer_cutoff: float = 1.0e10,
    precise_overlap: bool = True,
    row3: bool = False,
    Kbeta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, WPackGridSplit]:
    """Class-segmented gather-free core Hamiltonian and integrals.

    Keyed on the batch-max heavy count K: the [0:K, 0:K] ordered sub-grid
    runs hcore_dense's full 22-integral machinery (with qn-swapped overlap
    cells: a molecule with fewer than K heavies has hydrogens inside the
    block), the [0:K, K:A] block the 4-integral X-H class (column atoms are
    s-only in every molecule by the descending-Z sort), the [K:A, K:A]
    block the scalar (ss|ss).  With ``packed_m`` (=
    density.packed_solver_size(K, A)) M comes back as the (nmol, packed_m,
    packed_m) static packed matrix, assembled by block concatenation;
    without it as the (nmol, A, A, 4, 4) block grid.  ``Kbeta`` (nmol, NP,
    4): the learned resonance factors in the class-segmented pair order
    (make_system(heavy_count=K)), mirrored onto the grid once.
    """
    nmol, A = sys.species.shape
    AH = A - K
    am = sys.atom_mask
    pm, rij, xij, ov_mask, rij_ov = _dense_cells(sys, pair_outer_cutoff)
    qn = const.qn_int[sys.species]
    zeta = torch.stack([p["zeta_s"], p["zeta_p"]], dim=-1)   # (nmol, A, 2)
    tore = const.tore[sys.species]
    mp = atom_multipoles(const, sys.species, p, K)
    bi_full = torch.stack([p["beta_s"], p["beta_p"], p["beta_p"],
                           p["beta_p"]], dim=-1)             # (nmol, A, 4)
    row = lambda v, s: v[:, s, None]                        # noqa: E731
    col = lambda v, s: v[:, None, s]                        # noqa: E731
    z4 = lambda t: torch.zeros_like(t)                       # noqa: E731

    # ---- XX sub-grid [0:K, 0:K]: full ordered cells ----
    sH = slice(0, K)
    off_xx, ri_xx, U_xx, dblk_h = _xx_cells(const, sys, p, mp, rij, xij, pm,
                                            ov_mask, rij_ov, sH,
                                            precise_overlap, row3)
    kg = None if Kbeta is None else _kbeta_grid(Kbeta, sys)
    if kg is not None:
        off_xx = off_xx * _kbeta_block(kg[:, sH, sH])

    # ---- XH block [0:K, K:A]: 4-integral class, s-only columns ----
    sL = slice(K, A)
    pm_xh = pm[:, sH, sL]
    qh = _qn_host(sys) if row3 else None
    col_ov = diatom_overlap_xh(
        qn[:, sH, None].expand(nmol, K, AH),
        qn[:, None, sL].expand(nmol, K, AH),
        xij[:, sH, sL], rij_ov[:, sH, sL],
        zeta[:, sH, None, :].expand(nmol, K, AH, 2),
        p["zeta_s"][:, None, sL].expand(nmol, K, AH),
        precise=precise_overlap, row3=row3,
        qn_host=None if qh is None else (qh[:, sH, None], qh[:, None, sL]))
    col_ov = torch.where(ov_mask[:, sH, sL][..., None], col_ov, z4(col_ov))
    beta_xh = 0.5 * (bi_full[:, sH, None, :] + p["beta_s"][:, None, sL, None])
    off_xh = col_ov * beta_xh                           # (nmol, K, AH, 4)
    if kg is not None:
        off_xh = off_xh * _kbeta_col(kg[:, sH, sL])
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
    if kg is not None:
        off_hh = off_hh * kg[:, sL, sL, 0]
    whh = local_frame_integrals_hh(rij[:, sL, sL], row(mp["rho0"], sL),
                                   col(mp["rho0"], sL))
    whh = torch.where(pm_hh, whh, z4(whh))
    # ordered row sum covers both electron/core orientations
    dl00 = dl00 + (-col(tore, sL) * whh).sum(dim=2)

    # ---- assemble M ----
    zK = torch.zeros_like(p["U_ss"][:, sH])
    dblk_h = _diag_add(dblk_h, torch.where(am[:, sH], p["U_ss"][:, sH], zK),
                       torch.where(am[:, sH], p["U_pp"][:, sH], zK))
    dl00 = dl00 + torch.where(am[:, sL], p["U_ss"][:, sL],
                              torch.zeros_like(dl00))
    xx_grid = _with_diag_cells(off_xx, dblk_h)
    w_out = WPackGridSplit(xx=WPackGrid(rig=ri_xx, ug=U_xx), xh=wxh, hh=whh)
    if packed_m is not None:
        return (assemble_packed_mat(xx_grid, off_xh, off_hh, dl00, packed_m),
                w_out)
    M = off_xx.new_zeros((nmol, A, A, 4, 4))
    M[:, sH, sH] = xx_grid
    M[:, sH, sL, :, 0] = off_xh
    M[:, sL, sH, 0, :] = off_xh.transpose(1, 2)
    M[:, sL, sL, 0, 0] = torch.diagonal_scatter(off_hh, dl00, dim1=1, dim2=2)
    return M, w_out
