"""Two-electron two-center integrals (NDDO multipole model) + frame rotation.

PyTorch counterpart of ``pyseqm_tpu/ops/tetci.py`` (a redesign of the
reference's local-frame integral routine and its unrolled rotation,
seqm/seqm_functions/two_elec_two_center_int_local_frame.py:18-281,
two_elec_two_center_int.py:56-878):

1. Unified pair formula: hydrogen multipole separations and additive terms
   set to zero make every multipole term vanish, so the 22-integral X-X
   formula reproduces all pair classes.
2. Tensor rotation: with the per-pair AO frame U = [[1, 0], [0, R]], the
   molecular-frame block is w[a,b,c,d] = U[a,k] U[b,l] U[c,m] U[d,n]
   RI[k,l,m,n], RI holding the 22 unique local values on a constant 0/1
   sparsity tensor T.

The Fock contractions never materialize w: a 4x4 density block is rotated
into the local frame (U^T X U), contracted against T and the 22 local
integrals, and rotated back (U y U^T).  That apply is kernel K3 on a card
(ops/wapply_kernel.py, csrc/wapply.cu); its plain version, small batched
matrix products and one contraction with the (16, 22*16) constant, runs
on the CPU.

Orbital order, local frame: (s, p_sigma, p_pi, p_pi*).
Orbital order, molecular frame: (s, p_x, p_y, p_z).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..constants import EV
from .wapply_kernel import w_apply


# ------------------------------------------------------------------
# Local-frame integrals: 22 unique values per pair (MOPAC repp order)
# ------------------------------------------------------------------

def _dinv(x2, y2, d):
    """1/sqrt(x2) - 1/sqrt(y2), given d = y2 - x2 exactly: with no
    cancellation where a large additive term (a learned h_sp near 0 makes
    rho1 run to 1e2-1e5 Bohr) swamps the two squared distances, so its
    value and its derivatives keep their relative precision."""
    sx, sy = torch.sqrt(x2), torch.sqrt(y2)
    return d / (sx * sy * (sx + sy))


def local_frame_integrals(r, tore_i, tore_j, da, db, qa0, qb0,
                          rho0a, rho0b, rho1a, rho1b, rho2a, rho2b):
    """The 22 unique local-frame (mu nu|la si) integrals and core columns.

    All args broadcast to a common (...,) shape; hydrogens carry
    da=qa0=rho1=rho2=0.  Returns (ri (..., 22) in eV, core_a (..., 4),
    core_b (..., 4)): core_a = electron on atom i attracted by the core of
    j, columns (ss, s sigma, sigma sigma, pi pi); core_b the mirror.
    """
    ev1, ev2, ev3, ev4 = EV / 2.0, EV / 4.0, EV / 8.0, EV / 16.0
    qa = 2.0 * qa0
    qb = 2.0 * qb0

    aee = (rho0a + rho0b) ** 2
    ade = (rho1a + rho0b) ** 2
    aqe = (rho2a + rho0b) ** 2
    aed = (rho0a + rho1b) ** 2
    aeq = (rho0a + rho2b) ** 2
    axx = (rho1a + rho1b) ** 2
    adq = (rho1a + rho2b) ** 2
    aqd = (rho2a + rho1b) ** 2
    aqq = (rho2a + rho2b) ** 2

    sq = torch.sqrt
    rsq = lambda t, add: sq(t ** 2 + add)                # noqa: E731

    ee = EV / rsq(r, aee)
    dze = ev1 * _dinv((r - da) ** 2 + ade, (r + da) ** 2 + ade, 4.0 * r * da)
    e_qe = ev1 / rsq(r, aqe)
    qzze = ev2 / rsq(r - qa, aqe) + ev2 / rsq(r + qa, aqe) - e_qe
    qxxe = ev1 / sq(r ** 2 + qa ** 2 + aqe) - e_qe
    edz = ev1 * _dinv((r + db) ** 2 + aed, (r - db) ** 2 + aed, -4.0 * r * db)
    e_eq = ev1 / rsq(r, aeq)
    eqzz = ev2 / rsq(r - qb, aeq) + ev2 / rsq(r + qb, aeq) - e_eq
    eqxx = ev1 / sq(r ** 2 + qb ** 2 + aeq) - e_eq

    # the dipole terms pair the point charges that share an additive term
    # (the pairs' differences of squared distances taken exactly, _dinv)
    dxdx = ev1 * _dinv(r ** 2 + (da - db) ** 2 + axx,
                       r ** 2 + (da + db) ** 2 + axx, 4.0 * da * db)
    dzdz = ev2 * (_dinv((r + da - db) ** 2 + axx, (r + da + db) ** 2 + axx,
                        4.0 * (r + da) * db)
                  + _dinv((r - da + db) ** 2 + axx, (r - da - db) ** 2 + axx,
                          -4.0 * (r - da) * db))

    dq_r = _dinv((r - da) ** 2 + adq, (r + da) ** 2 + adq, 4.0 * r * da)
    qd_r = _dinv((r - db) ** 2 + aqd, (r + db) ** 2 + aqd, 4.0 * r * db)

    dzqzz = (ev3 * (_dinv((r - da - qb) ** 2 + adq, (r + da - qb) ** 2 + adq,
                          4.0 * (r - qb) * da)
                    + _dinv((r - da + qb) ** 2 + adq,
                            (r + da + qb) ** 2 + adq, 4.0 * (r + qb) * da))
             - ev2 * dq_r)
    qzzdz = (ev3 * (_dinv((r + qa + db) ** 2 + aqd, (r + qa - db) ** 2 + aqd,
                          -4.0 * (r + qa) * db)
                    + _dinv((r - qa + db) ** 2 + aqd,
                            (r - qa - db) ** 2 + aqd, -4.0 * (r - qa) * db))
             + ev2 * qd_r)
    dzqxx = ev2 * (_dinv((r - da) ** 2 + qb ** 2 + adq,
                         (r + da) ** 2 + qb ** 2 + adq, 4.0 * r * da) - dq_r)
    qxxdz = ev2 * (qd_r - _dinv((r - db) ** 2 + qa ** 2 + aqd,
                                (r + db) ** 2 + qa ** 2 + aqd, 4.0 * r * db))
    # off-axis multipoles use the single charge separation (qa0/qb0),
    # cf. repp.f SQR(54)-SQR(72)
    dxqxz = ev2 * (_dinv((da - qb0) ** 2 + (r + qb0) ** 2 + adq,
                         (da - qb0) ** 2 + (r - qb0) ** 2 + adq,
                         -4.0 * r * qb0)
                   + _dinv((da + qb0) ** 2 + (r - qb0) ** 2 + adq,
                           (da + qb0) ** 2 + (r + qb0) ** 2 + adq,
                           4.0 * r * qb0))
    qxzdx = ev2 * (_dinv((qa0 - db) ** 2 + (r - qa0) ** 2 + aqd,
                         (qa0 - db) ** 2 + (r + qa0) ** 2 + aqd,
                         4.0 * r * qa0)
                   + _dinv((qa0 + db) ** 2 + (r + qa0) ** 2 + aqd,
                           (qa0 + db) ** 2 + (r - qa0) ** 2 + aqd,
                           -4.0 * r * qa0))

    ev2_aqq = ev2 / sq(r ** 2 + aqq)
    ev2_qa_aqq = ev2 / sq(r ** 2 + qa ** 2 + aqq)
    ev2_qb_aqq = ev2 / sq(r ** 2 + qb ** 2 + aqq)
    ev3_mqb = ev3 / rsq(r - qb, aqq)
    ev3_pqb = ev3 / rsq(r + qb, aqq)
    ev3_pqa = ev3 / rsq(r + qa, aqq)
    ev3_mqa = ev3 / rsq(r - qa, aqq)

    qzzqzz = (ev4 / rsq(r + qa - qb, aqq) + ev4 / rsq(r + qa + qb, aqq)
              + ev4 / rsq(r - qa - qb, aqq) + ev4 / rsq(r - qa + qb, aqq)
              - ev3_mqa - ev3_pqa - ev3_mqb - ev3_pqb + ev2_aqq)
    qxxqzz = (ev3 / sq((r - qb) ** 2 + qa ** 2 + aqq)
              + ev3 / sq((r + qb) ** 2 + qa ** 2 + aqq)
              - ev3_mqb - ev3_pqb - ev2_qa_aqq + ev2_aqq)
    qzzqxx = (ev3 / sq((r + qa) ** 2 + qb ** 2 + aqq)
              + ev3 / sq((r - qa) ** 2 + qb ** 2 + aqq)
              - ev3_pqa - ev3_mqa - ev2_qb_aqq + ev2_aqq)
    qxxqxx = (ev3 / sq(r ** 2 + (qa - qb) ** 2 + aqq)
              + ev3 / sq(r ** 2 + (qa + qb) ** 2 + aqq)
              - ev2_qa_aqq - ev2_qb_aqq + ev2_aqq)
    qxxqyy = (ev2 / sq(r ** 2 + qa ** 2 + qb ** 2 + aqq)
              - ev2_qa_aqq - ev2_qb_aqq + ev2_aqq)
    qxzqxz = (ev3 / sq((r + qa0 - qb0) ** 2 + (qa0 - qb0) ** 2 + aqq)
              - ev3 / sq((r + qa0 + qb0) ** 2 + (qa0 - qb0) ** 2 + aqq)
              - ev3 / sq((r - qa0 - qb0) ** 2 + (qa0 - qb0) ** 2 + aqq)
              + ev3 / sq((r - qa0 + qb0) ** 2 + (qa0 - qb0) ** 2 + aqq)
              - ev3 / sq((r + qa0 - qb0) ** 2 + (qa0 + qb0) ** 2 + aqq)
              + ev3 / sq((r + qa0 + qb0) ** 2 + (qa0 + qb0) ** 2 + aqq)
              + ev3 / sq((r - qa0 - qb0) ** 2 + (qa0 + qb0) ** 2 + aqq)
              - ev3 / sq((r - qa0 + qb0) ** 2 + (qa0 + qb0) ** 2 + aqq))

    terms = [
        ee,                                   # 1  (ss|ss)
        -dze,                                 # 2  (so|ss)
        ee + qzze,                            # 3  (oo|ss)
        ee + qxxe,                            # 4  (pp|ss)
        -edz,                                 # 5  (ss|os)
        dzdz,                                 # 6  (so|so)
        dxdx,                                 # 7  (sp|sp)
        -edz - qzzdz,                         # 8  (oo|so)
        -edz - qxxdz,                         # 9  (pp|so)
        -qxzdx,                               # 10 (po|sp)
        ee + eqzz,                            # 11 (ss|oo)
        ee + eqxx,                            # 12 (ss|pp)
        -dze - dzqzz,                         # 13 (so|oo)
        -dze - dzqxx,                         # 14 (so|pp)
        -dxqxz,                               # 15 (sp|op)
        ee + eqzz + qzze + qzzqzz,            # 16 (oo|oo)
        ee + eqzz + qxxe + qxxqzz,            # 17 (pp|oo)
        ee + eqxx + qzze + qzzqxx,            # 18 (oo|pp)
        ee + eqxx + qxxe + qxxqxx,            # 19 (pp|pp)
        qxzqxz,                               # 20 (po|po)
        ee + eqxx + qxxe + qxxqyy,            # 21 (pp|p*p*)
        0.5 * (qxxqxx - qxxqyy),              # 22 (p*p|p*p)
    ]
    ri = torch.stack(torch.broadcast_tensors(*terms), dim=-1)

    # electron-core attraction columns (repp.f CORE): a-side feels core of j
    core_a = tore_j[..., None] * ri[..., [0, 1, 2, 3]]
    core_b = tore_i[..., None] * ri[..., [0, 4, 10, 11]]
    return ri, core_a, core_b


def local_frame_integrals_xh(r, da, qa0, rho0a, rho0b, rho1a, rho2a):
    """X-H pair class: the 4 unique local integrals (ss|ss), (so|ss),
    (oo|ss), (pp|ss) in eV (the lighter atom carries only an s
    distribution; cf. two_elec_two_center_int_local_frame.py:64-66)."""
    ev1, ev2 = EV / 2.0, EV / 4.0
    qa = 2.0 * qa0
    aee = (rho0a + rho0b) ** 2
    ade = (rho1a + rho0b) ** 2
    aqe = (rho2a + rho0b) ** 2
    rsq = lambda t, add: torch.sqrt(t ** 2 + add)           # noqa: E731
    ee = EV / rsq(r, aee)
    dze = ev1 * _dinv((r - da) ** 2 + ade, (r + da) ** 2 + ade, 4.0 * r * da)
    e_qe = ev1 / rsq(r, aqe)
    qzze = ev2 / rsq(r - qa, aqe) + ev2 / rsq(r + qa, aqe) - e_qe
    qxxe = ev1 / torch.sqrt(r ** 2 + qa ** 2 + aqe) - e_qe
    return torch.stack([ee, -dze, ee + qzze, ee + qxxe], dim=-1)


def local_frame_integrals_hh(r, rho0a, rho0b):
    """H-H pair class: the single (ss|ss) integral (eV)."""
    return EV / torch.sqrt(r ** 2 + (rho0a + rho0b) ** 2)


# ------------------------------------------------------------------
# Sparse local tensor and frame rotation
# ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ri_expansion_table() -> np.ndarray:
    """Constant (22, 4, 4, 4, 4) 0/1 tensor T: RI[klmn] = ri @ T.

    Local orbitals: 0=s, 1=p_sigma, 2=p_pi, 3=p_pi*.  Each entry lists the
    (bra, ket) orbital pairs carrying that unique integral; bra/ket are
    symmetric under index swap.
    """
    ENTRIES = [
        [((0, 0), (0, 0))],                                # 1  (ss|ss)
        [((1, 0), (0, 0))],                                # 2  (so|ss)
        [((1, 1), (0, 0))],                                # 3  (oo|ss)
        [((2, 2), (0, 0)), ((3, 3), (0, 0))],              # 4  (pp|ss)
        [((0, 0), (1, 0))],                                # 5  (ss|os)
        [((1, 0), (1, 0))],                                # 6  (so|so)
        [((2, 0), (2, 0)), ((3, 0), (3, 0))],              # 7  (sp|sp)
        [((1, 1), (1, 0))],                                # 8  (oo|so)
        [((2, 2), (1, 0)), ((3, 3), (1, 0))],              # 9  (pp|so)
        [((2, 1), (2, 0)), ((3, 1), (3, 0))],              # 10 (po|sp)
        [((0, 0), (1, 1))],                                # 11 (ss|oo)
        [((0, 0), (2, 2)), ((0, 0), (3, 3))],              # 12 (ss|pp)
        [((1, 0), (1, 1))],                                # 13 (so|oo)
        [((1, 0), (2, 2)), ((1, 0), (3, 3))],              # 14 (so|pp)
        [((2, 0), (2, 1)), ((3, 0), (3, 1))],              # 15 (sp|op)
        [((1, 1), (1, 1))],                                # 16 (oo|oo)
        [((2, 2), (1, 1)), ((3, 3), (1, 1))],              # 17 (pp|oo)
        [((1, 1), (2, 2)), ((1, 1), (3, 3))],              # 18 (oo|pp)
        [((2, 2), (2, 2)), ((3, 3), (3, 3))],              # 19 (pp|pp)
        [((2, 1), (2, 1)), ((3, 1), (3, 1))],              # 20 (po|po)
        [((2, 2), (3, 3)), ((3, 3), (2, 2))],              # 21 (pp|p*p*)
        [((2, 3), (2, 3))],                                # 22 (p*p|p*p)
    ]
    T = np.zeros((22, 4, 4, 4, 4), dtype=np.float64)
    for idx, pairs in enumerate(ENTRIES):
        for (k, l), (m, n) in pairs:
            for kk, ll in {(k, l), (l, k)}:
                for mm, nn in {(m, n), (n, m)}:
                    T[idx, kk, ll, mm, nn] = 1.0
    return T


def frame_matrix(xij):
    """Per-pair AO frame transform U (..., 4, 4).

    U[0,0] = 1; U[1+a, 1:] = (x_a, y_a, z_a) where x = -xij is the local
    sigma axis and (y, z) complete an orthonormal frame.  The integrals are
    invariant under rotations about the bond, so y is built by crossing x
    with the coordinate axis least aligned with it (|x cross ref| >=
    1/sqrt(2)): stable for every bond direction.
    """
    dtype, device = xij.dtype, xij.device
    x = -xij
    use_z = (torch.abs(x[..., 2]) < 0.70710678)[..., None]
    eye = torch.eye(3, dtype=dtype, device=device)
    ref = torch.where(use_z, eye[2], eye[0])
    y = torch.linalg.cross(x, ref, dim=-1)
    y = y / torch.sqrt((y * y).sum(dim=-1, keepdim=True))
    z = torch.linalg.cross(x, y, dim=-1)
    R = torch.stack([x, y, z], dim=-1)                   # (..., 3, 3)
    zero = torch.zeros(x.shape[:-1] + (1, 3), dtype=dtype, device=device)
    one = torch.ones(x.shape[:-1] + (1, 1), dtype=dtype, device=device)
    top = torch.cat([one, zero], dim=-1)
    low = torch.cat([zero.transpose(-1, -2), R], dim=-1)
    return torch.cat([top, low], dim=-2)


def _rot_to_local(U, X):
    """Xloc = U^T X U."""
    return U.transpose(-1, -2) @ X @ U


def _rot_from_local(U, y):
    """e = U y U^T."""
    return U @ y @ U.transpose(-1, -2)


class WPack(NamedTuple):
    """Compact two-electron integral representation: w is implicit."""
    ri: torch.Tensor   # (..., 22) local-frame unique integrals (eV)
    U: torch.Tensor    # (..., 4, 4) per-pair AO frame transform


def _w_apply(pack: WPack, X, perm):
    """y[f1, f2] = sum w_perm[f1, f2, c1, c2] X[c1, c2] for 4x4 blocks X,
    with w never materialized: kernel K3 on a card, its plain version (the
    contraction as small matrix products) on the CPU
    (ops/wapply_kernel.py)."""
    return w_apply(pack.ri, pack.U, X, perm)


def w_coulomb_i(pack: WPack, pdiag_j):
    """sum_cd w[ab,cd] Pdiag_j[cd] -> (..., 4, 4) added to atom i's block."""
    return _w_apply(pack, pdiag_j, (1, 2, 3, 4))


def w_coulomb_j(pack: WPack, pdiag_i):
    """sum_ab w[ab,cd] Pdiag_i[ab] -> (..., 4, 4) added to atom j's block."""
    return _w_apply(pack, pdiag_i, (3, 4, 1, 2))


def w_exchange(pack: WPack, p_pair):
    """sum_bd w[ab,cd] P_pair[bd] -> (..., 4, 4) (a,c block)."""
    return _w_apply(pack, p_pair, (1, 3, 2, 4))


def rotate_w(ri, xij, U=None):
    """Rotate local integrals to the molecular frame: (..., 4, 4, 4, 4)."""
    T = torch.as_tensor(_ri_expansion_table(), dtype=ri.dtype,
                        device=ri.device)
    RI = torch.einsum('...r,rklmn->...klmn', ri, T)
    if U is None:
        U = frame_matrix(xij)
    W = torch.einsum('...ak,...klmn->...almn', U, RI)
    W = torch.einsum('...bl,...almn->...abmn', U, W)
    W = torch.einsum('...cm,...abmn->...abcn', U, W)
    return torch.einsum('...dn,...abcn->...abcd', U, W)


def rotate_core(core, xij):
    """Negated symmetric e1b/e2a block: e[a,b] = -U[a,k] U[b,l] C[k,l]."""
    return _core_block(frame_matrix(xij), core)


def assemble_w(pack: WPack) -> torch.Tensor:
    """Materialize the full (..., 4, 4, 4, 4) integral tensor (tests only)."""
    return rotate_w(pack.ri, None, U=pack.U)


# bra<->ket swap permutation of the 22 local integrals: w_ji = w_ij^T
# (transpose over the (ab),(cd) index groups) equals the rotation of the
# relabeled locals with the same frame U
RI_SWAP = np.array([0, 4, 10, 11, 1, 5, 6, 12, 13, 14,
                    2, 3, 7, 8, 9, 15, 17, 16, 18, 19, 20, 21])


class WPackGrid(NamedTuple):
    """Grid-resident two-electron integrals: rig[n, i, j] holds the local
    integrals of the ordered pair (i, j) (bra on the row atom), ug[n, i, j]
    its frame."""
    rig: torch.Tensor   # (nmol, A, A, 22)
    ug: torch.Tensor    # (nmol, A, A, 4, 4)


def to_grid(pack: WPack, A: int, iu, ju) -> WPackGrid:
    """Flat (i < j) integrals placed on the ordered grid: (i, j) as given,
    (j, i) with the bra/ket-swapped locals and the same frame; diagonal
    cells zero.  (A diagonal cell's U = 0 breaks the frame structure K3
    assumes; with ri = 0 there its apply is 0 either way, and its
    cotangents fall on constants.)"""
    nmol = pack.ri.shape[0]
    swap = torch.as_tensor(RI_SWAP, device=pack.ri.device)
    rig = pack.ri.new_zeros((nmol, A, A, 22))
    rig[:, iu, ju] = pack.ri
    rig[:, ju, iu] = pack.ri[..., swap]
    ug = pack.U.new_zeros((nmol, A, A, 4, 4))
    ug[:, iu, ju] = pack.U
    ug[:, ju, iu] = pack.U
    return WPackGrid(rig=rig, ug=ug)


def from_grid(wg: WPackGrid, iu, ju) -> WPack:
    """The flat (i < j) WPack of grid-resident integrals (one gather)."""
    return WPack(ri=wg.rig[:, iu, ju], U=wg.ug[:, iu, ju])


def _local_matrix(c00, c01, c11, c22):
    """Symmetric local 4x4 with the electron-core sparsity: [0,0], [0,1] =
    [1,0], [1,1], [2,2] = [3,3]."""
    z = torch.zeros_like(c00)
    return torch.stack([
        torch.stack([c00, c01, z, z], dim=-1),
        torch.stack([c01, c11, z, z], dim=-1),
        torch.stack([z, z, c22, z], dim=-1),
        torch.stack([z, z, z, c22], dim=-1),
    ], dim=-2)


def _core_block(U, core):
    """e[a,b] = -sum_kl U[a,k] C[k,l] U[b,l] with the sparse local C
    (counterpart of the JAX package's ``_core_block_unrolled``)."""
    C = _local_matrix(core[..., 0], core[..., 1], core[..., 2], core[..., 3])
    return -_rot_from_local(U, C)


def rotate_xh_block(U, ri4):
    """(mu nu | ss) molecular-frame 4x4 block from the 4 local integrals
    ([0,0]=(ss|ss), [0,1]=[1,0]=(so|ss), [1,1]=(oo|ss), [2,2]=[3,3]=(pp|ss))."""
    return _rot_from_local(U, _local_matrix(ri4[..., 0], ri4[..., 1],
                                            ri4[..., 2], ri4[..., 3]))


def pair_w_xh(rij, xij, tore_i, tore_j, da, qa, rho0a, rho0b, rho1a, rho2a):
    """X-H pair segment pipeline: (wblk, e1b, e2a_ss).

    wblk (..., 4, 4) is the rotated (mu nu | ss) block; e1b = -tore_j *
    wblk (electron on i, core of j); e2a_ss = -tore_i * (ss|ss).
    """
    ri4 = local_frame_integrals_xh(rij, da, qa, rho0a, rho0b, rho1a, rho2a)
    wblk = rotate_xh_block(frame_matrix(xij), ri4)
    e1b = -tore_j[..., None, None] * wblk
    e2a_ss = -tore_i * ri4[..., 0]
    return wblk, e1b, e2a_ss


def pair_w_pack(rij, xij, tore_i, tore_j, da, db, qa, qb,
                rho0a, rho0b, rho1a, rho1b, rho2a, rho2b):
    """Flat pair pipeline: (WPack, e1b, e2a), e1b the electron on i
    attracted by the core of j, e2a the mirror."""
    ri, core_a, core_b = local_frame_integrals(
        rij, tore_i, tore_j, da, db, qa, qb,
        rho0a, rho0b, rho1a, rho1b, rho2a, rho2b)
    U = frame_matrix(xij)
    return WPack(ri=ri, U=U), _core_block(U, core_a), _core_block(U, core_b)


def two_center_integrals(rij, xij, tore_i, tore_j, da, db, qa, qb,
                         rho0a, rho0b, rho1a, rho1b, rho2a, rho2b):
    """Full pipeline to the molecular frame: (w (..., 4,4,4,4), e1b, e2a),
    w[ab,cd] = (mu_a nu_b on i | la_c si_d on j) (tests only)."""
    ri, core_a, core_b = local_frame_integrals(
        rij, tore_i, tore_j, da, db, qa, qb,
        rho0a, rho0b, rho1a, rho1b, rho2a, rho2b)
    return (rotate_w(ri, xij), rotate_core(core_a, xij),
            rotate_core(core_b, xij))


class WPackSplit(NamedTuple):
    """Class-segmented flat integrals over the pair_index_packed
    enumeration (system.py) for heavy count K: xx the full pairs
    (i < j < K), xh (nmol, n_xh, 4, 4) rotated (mu nu | ss) blocks
    (i < K <= j), hh (nmol, n_hh) (ss|ss) integrals (K <= i < j); the
    segment sizes are the arrays' lengths."""
    xx: WPack
    xh: torch.Tensor
    hh: torch.Tensor

    def gam(self) -> torch.Tensor:
        """(ss|ss) per pair in segment order (the nuclear term's gamma);
        rotation leaves xh[..., 0, 0] the local (ss|ss)."""
        return torch.cat([self.xx.ri[..., 0], self.xh[..., 0, 0], self.hh],
                         dim=-1)


class WPackGridSplit(NamedTuple):
    """Class-segmented grid-resident integrals keyed on the batch-max heavy
    count K: xx the ordered (nmol, K, K) heavy sub-grid with full 22-integral
    cells; xh (nmol, K, A-K, 4, 4) rotated (mu nu | ss) blocks serving both
    orientations; hh (nmol, A-K, A-K) (ss|ss) scalars (zero diagonal)."""
    xx: WPackGrid
    xh: torch.Tensor
    hh: torch.Tensor

    def gam_grid(self) -> torch.Tensor:
        """Full (nmol, A, A) (ss|ss) grid for the dense nuclear term."""
        gxh = self.xh[..., 0, 0]
        top = torch.cat([self.xx.rig[..., 0], gxh], dim=2)
        bot = torch.cat([gxh.transpose(1, 2), self.hh], dim=2)
        return torch.cat([top, bot], dim=1)
