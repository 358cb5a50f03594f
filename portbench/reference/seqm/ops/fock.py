"""Fock matrix construction F = Hcore + G(P).

PyTorch counterpart of ``pyseqm_tpu/ops/fock.py`` (cf. the reference fock,
seqm/seqm_functions/fock.py:6-139): ``fock_packed_split`` in the static
packed layout, and ``fock`` on the block grid for the flat pair list
(WPack), the ordered dense grid (WPackGrid), the class-segmented grid
(WPackGridSplit) and the class-segmented flat pair list (WPackSplit).
Every 22-integral two-electron contraction is the fused apply K3
(tetci._w_apply); X-H pairs are a 4x4 elementwise block product and H-H
pairs a scalar.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..system import System
from .matrix import (assemble_packed_mat, block00, col0_block, diag_blocks,
                     grid_to_mat, mat_to_grid)
from .tetci import (WPack, WPackGrid, WPackGridSplit, WPackSplit,
                    w_coulomb_i, w_coulomb_j, w_exchange)


def _one_center(Pd, gss, gsp, gpp, gp2, hsp):
    """One-center two-electron terms of each heavy atom's diagonal block
    (cf. fock.py:30-80): (..., 4, 4) from the (..., 4, 4) density block."""
    pss = Pd[..., 0, 0]
    pkk = [Pd[..., k, k] for k in (1, 2, 3)]
    pptot = pkk[0] + pkk[1] + pkk[2]
    t00 = 0.5 * pss * gss + pptot * (gsp - 0.5 * hsp)
    tkk = [pss * (gsp - 0.5 * hsp) + 0.5 * pk * gpp
           + (pptot - pk) * (1.25 * gp2 - 0.25 * gpp) for pk in pkk]
    t0k = [Pd[..., 0, k] * (1.5 * hsp - 0.5 * gsp) for k in (1, 2, 3)]
    cx = 0.75 * gpp - 1.25 * gp2
    t12, t13, t23 = (Pd[..., 1, 2] * cx, Pd[..., 1, 3] * cx,
                     Pd[..., 2, 3] * cx)
    return torch.stack([
        torch.stack([t00, t0k[0], t0k[1], t0k[2]], dim=-1),
        torch.stack([t0k[0], tkk[0], t12, t13], dim=-1),
        torch.stack([t0k[1], t12, tkk[1], t23], dim=-1),
        torch.stack([t0k[2], t13, t23, tkk[2]], dim=-1),
    ], dim=-2)


def fock_packed_split(sys: System, Pp: torch.Tensor, Mp: torch.Tensor,
                      w: WPackGridSplit, p: Dict[str, torch.Tensor],
                      K: int, n_st: int) -> torch.Tensor:
    """Fock matrix built entirely in the static packed layout.

    Pp, Mp: (nmol, n_st, n_st) packed density / core Hamiltonian
    (``hcore_dense_split(packed_m=n_st)``).  Returns packed F with dead
    p-rows and padding zeroed, directly consumable by
    ``sp2(prepacked=True)``.
    """
    from .density import orbital_mask, static_pack_vec
    nmol, A = sys.species.shape
    AH = A - K
    sH = slice(0, K)

    # density views — every slice below is contiguous in this layout
    PH4 = Pp[:, :4 * K, :4 * K]
    Pg_h = PH4.reshape(nmol, K, 4, K, 4).transpose(2, 3)   # (nmol,K,K,4,4)
    Pd_h = torch.diagonal(Pg_h, dim1=1, dim2=2).permute(0, 3, 1, 2)
    P_hs = Pp[:, 4 * K:4 * K + AH, 4 * K:4 * K + AH]      # (nmol, AH, AH)
    pss_l = torch.diagonal(P_hs, dim1=1, dim2=2)          # (nmol, AH)
    # Pcol[i, j, b] = P[4i+b, 4K+j] (the heavy-row/H-column strip)
    Pcol = (Pp[:, :4 * K, 4 * K:4 * K + AH]
            .reshape(nmol, K, 4, AH).transpose(2, 3))

    tmp_h = _one_center(Pd_h, p["g_ss"][:, sH], p["g_sp"][:, sH],
                        p["g_pp"][:, sH], p["g_p2"][:, sH], p["h_sp"][:, sH])
    tmp_l = 0.5 * pss_l * p["g_ss"][:, K:A]

    # XX ordered sub-grid
    pack = WPack(ri=w.xx.rig, U=w.xx.ug)
    dsum_h = w_coulomb_i(pack, Pd_h[:, None]).sum(dim=2)
    xch = -0.5 * w_exchange(pack, Pg_h)

    # XH block: w[ab, cd] = wblk[ab] delta_c0 delta_d0
    dsum_h = dsum_h + (w.xh * pss_l[:, None, :, None, None]).sum(dim=2)
    dsum_l = (w.xh * Pd_h[:, :, None]).sum(dim=(1, -1, -2))
    xcol = -0.5 * (w.xh * Pcol[..., None, :]).sum(dim=-1)

    # HH block
    dsum_l = dsum_l + (w.hh * pss_l[:, None, :]).sum(dim=2)
    xss = -0.5 * w.hh * P_hs

    eyeK = torch.eye(K, dtype=Pp.dtype, device=Pp.device)[None, :, :, None,
                                                          None]
    xxg = xch + eyeK * (tmp_h + dsum_h)[:, :, None]
    F = Mp + assemble_packed_mat(xxg, xcol, xss, tmp_l + dsum_l, n_st)
    mk = static_pack_vec(orbital_mask(sys).to(Pp.dtype), K, n_st)
    return F * (mk[:, :, None] * mk[:, None, :])


def fock(sys: System, P: torch.Tensor, M: torch.Tensor, w,
         p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Fock matrix (nmol, 4A, 4A) from the total density P (nmol, 4A, 4A),
    the core Hamiltonian grid M (nmol, A, A, 4, 4), the compact integrals w
    (WPack, WPackGrid, WPackGridSplit or WPackSplit; w is never
    materialized) and the per-atom parameters g_ss, g_sp, g_pp, g_p2, h_sp
    (each (nmol, A))."""
    nmol, A = sys.species.shape
    iu, ju = sys.pair_i, sys.pair_j
    Pg = mat_to_grid(P, A)
    Pd = diag_blocks(P, A)                          # (nmol, A, 4, 4)
    idx = torch.arange(A, device=P.device)
    # one-center two-electron terms on the diagonal blocks (fock.py:54-64)
    tmp = _one_center(Pd, p["g_ss"], p["g_sp"], p["g_pp"], p["g_p2"],
                      p["h_sp"])
    F = M.clone()

    if isinstance(w, WPackGridSplit):
        # class-segmented grid: the [0:K, 0:K] ordered sub-grid pays the
        # fused apply, the X-H block one elementwise 4x4 product (one array
        # serves both orientations), the H-H block a scalar
        K = w.xh.shape[1]
        sH, sL = slice(0, K), slice(K, None)
        Pd_h = Pd[:, sH]
        pss_l = Pd[:, sL, 0, 0]                     # (nmol, AH)
        pack = WPack(ri=w.xx.rig, U=w.xx.ug)
        dsum_h = w_coulomb_i(pack, Pd_h[:, None]).sum(dim=2)
        F[:, sH, sH] += -0.5 * w_exchange(pack, Pg[:, sH, sH])
        # XH block: w[ab, cd] = wblk[ab] delta_c0 delta_d0
        dsum_h = dsum_h + (w.xh * pss_l[:, None, :, None, None]).sum(dim=2)
        dsum_l = (w.xh * Pd_h[:, :, None]).sum(dim=(1, -1, -2))
        xcol = -0.5 * (w.xh * Pg[:, sH, sL, :, 0][..., None, :]).sum(dim=-1)
        F[:, sH, sL, :, 0] += xcol
        F[:, sL, sH, 0, :] += xcol.transpose(1, 2)
        # HH block: scalar (ss|ss); the ordered square covers both
        # orientations in one row reduction
        dsum_l = dsum_l + (w.hh * pss_l[:, None, :]).sum(dim=2)
        F[:, sL, sL, 0, 0] += -0.5 * w.hh * Pg[:, sL, sL, 0, 0]
        idh, idl = idx[:K], idx[K:]
        F[:, idh, idh] += tmp[:, sH] + dsum_h
        F[:, idl, idl] += tmp[:, sL]
        F[:, idl, idl, 0, 0] += dsum_l
        return grid_to_mat(F)

    if isinstance(w, WPackGrid):
        # ordered dense grid: each cell (i, j) carries the bra on i, so one
        # ket pairing covers both Coulomb halves of the flat path and the
        # exchange grid yields both F triangles; no scatters
        pack = WPack(ri=w.rig, U=w.ug)
        dsum = w_coulomb_i(pack, Pd[:, None]).sum(dim=2)
        F = F - 0.5 * w_exchange(pack, Pg)           # zero on diagonal cells
        F[:, idx, idx] += tmp + dsum
        return grid_to_mat(F)

    if isinstance(w, WPackSplit):
        # class-segmented pairs (system.pair_index_packed): XX pairs pay
        # the fused apply, XH pairs a 4x4 elementwise block product (w[ab,
        # cd] = wblk[ab] delta_c0 delta_d0), HH pairs a scalar (ss|ss); the
        # per-pair blocks of the three segments are scattered together
        n_xx, n_xh = w.xx.ri.shape[1], w.xh.shape[1]
        s_xx = slice(0, n_xx)
        s_xh = slice(n_xx, n_xx + n_xh)
        s_hh = slice(n_xx + n_xh, None)
        i_x, j_x = iu[s_xx], ju[s_xx]
        i_h, j_h = iu[s_xh], ju[s_xh]
        i_l, j_l = iu[s_hh], ju[s_hh]
        ss = Pd[..., 0, 0]                              # (nmol, A)
        to_i = torch.cat([
            w_coulomb_i(w.xx, Pd[:, j_x]),
            w.xh * ss[:, j_h, None, None],
            block00(w.hh * ss[:, j_l])], dim=1)
        to_j = torch.cat([
            w_coulomb_j(w.xx, Pd[:, i_x]),
            block00((w.xh * Pd[:, i_h]).sum(dim=(-1, -2))),
            block00(w.hh * ss[:, i_l])], dim=1)
        dsum = torch.zeros_like(Pd).index_add(1, iu, to_i).index_add(
            1, ju, to_j)
        x = torch.cat([
            -0.5 * w_exchange(w.xx, Pg[:, i_x, j_x]),
            col0_block(-0.5 * (w.xh * Pg[:, i_h, j_h, :, 0][..., None, :])
                       .sum(dim=-1)),
            block00(-0.5 * w.hh * Pg[:, i_l, j_l, 0, 0])], dim=1)
    elif isinstance(w, WPack):
        # flat pair list: two-center Coulomb on the diagonal blocks
        # (fock.py:80-110) and exchange on the pair blocks (fock.py:117-131)
        dsum = torch.zeros_like(Pd).index_add(
            1, iu, w_coulomb_i(w, Pd[:, ju])).index_add(
            1, ju, w_coulomb_j(w, Pd[:, iu]))
        x = -0.5 * w_exchange(w, Pg[:, iu, ju])
    else:
        raise TypeError(f"fock() takes WPack, WPackGrid, WPackGridSplit or "
                        f"WPackSplit integrals, not {type(w).__name__}")
    F[:, idx, idx] += tmp + dsum
    F[:, iu, ju] += x
    F[:, ju, iu] += x.transpose(-1, -2)
    return grid_to_mat(F)
