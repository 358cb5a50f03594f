"""Fock matrix construction F = Hcore + G(P) in the static packed layout.

PyTorch counterpart of ``pyseqm_tpu/ops/fock.py::fock_packed_split``
(cf. the reference fock, seqm/seqm_functions/fock.py:6-139).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..system import System
from .matrix import assemble_packed_mat
from .tetci import WPack, WPackGridSplit, w_coulomb_i, w_exchange


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
