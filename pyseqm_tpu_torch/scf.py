"""SCF engine: converger 2 + backward mode 0.

PyTorch counterpart of ``pyseqm_tpu/scf.py`` (cf. the reference
scf_loop.py:32-806), on the full (nmol, 4A, 4A) layout with the block-grid
Fock build (``fock``) and on the static packed layout
(``fock_packed_split``).  Each iteration's density comes from the
eigensolver (``sym_eig``, the default) or SP2 (``use_sp2``).
Converger 2: two direct steps, one
adaptive-mixing step, then Pulay DIIS.  The fixed point runs as a Python
loop over masked batched updates: converged molecules stop changing but
keep riding the batch, and the host checks convergence once per _CHUNK
iterations (the JAX package's default chunk, which fixes where max_iter
can overshoot).

The DIIS machinery (nFock=5 ring buffer of [F,P] commutators, EMAT linear
system, scf_loop.py:264-510) uses fixed-size buffers with a modular counter
and a masked identity-embedded 6x6 solve.

Backward mode 0 (Hellmann-Feynman): the converged density is a constant;
energy terms still differentiate through Hcore and the integrals.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .constants import Constants
from .ops.density import sp2, static_pack_mat, sym_eig
from .ops.fock import fock, fock_packed_split
from .ops.matrix import grid_to_mat
from .system import System

SCF_PARAM_NAMES = ("g_ss", "g_pp", "g_sp", "g_p2", "h_sp")

_NFOCK = 5
_CHUNK = 4


class SCFConvergenceError(RuntimeError):
    """Raised (opt-in) when molecules fail to converge."""


@dataclasses.dataclass(frozen=True)
class SCFConfig:
    eps: float = 1.0e-4                 # |dEelec| convergence (eV)
    converger: Tuple = (2,)             # adaptive mixing + DIIS
    use_sp2: bool = False
    sp2_eps: float = 1.0e-4
    # refine Gershgorin spectral bounds by Gelfand squaring before SP2
    # (fewer iterations and less amplified rounding noise)
    sp2_tight_bounds: bool = False
    # XL-BOMD on the full layout only: re-solve the worst frac of
    # molecules (scored by ||D - P|| against the propagated field) with the
    # exact degeneracy-aware eigh after SP2 (ops/density.py eigh_rescue).
    # 0 = off.  The SCF ignores it; the packed XL route raises on it.
    sp2_rescue: float = 0.0
    max_iter: int = 1000
    raise_on_forward_failure: bool = False
    # plain adaptive-mixing iterations run on all molecules after the
    # energy criterion fires: the |dEelec| stop is quadratically blind to
    # density error, and ~8 contraction steps bring f32 forces to the
    # 1e-3 eV/A class.  None = auto: 8 for float32, 0 for float64.
    polish_iters: Optional[int] = None
    # fractional occupations across a degenerate Fermi level
    # (cf. diag.CHECK_DEGENERACY, diag.py:7,79-98)
    check_degeneracy: bool = False
    # compact-orbital size of the density solves on the full layout
    # (= packed_orbital_size(species), >= every molecule's norb; 884-atom
    # alkane: 1792 instead of 3536).  None = full 4A
    pack_orbitals: Optional[int] = None
    # max heavy-atom count K of the static packed layout
    # (= packed_heavy_count(species))
    pack_heavy: Optional[int] = None
    # The JAX package's sp2_precision, sp2_dots, sort_packing and panel_out
    # are TPU knobs and not ported: with TF32 off every float32 product
    # here is full float32.


def init_density(const: Constants, sys: System) -> torch.Tensor:
    """Neutral-atom diagonal initial guess (cf. scf_loop.py:700-710),
    (nmol, 4A, 4A)."""
    nmol, A = sys.species.shape
    q = const.tore[sys.species] / 4.0
    q = torch.where(sys.species == 1, torch.ones_like(q), q)
    q = torch.where(sys.atom_mask, q, torch.zeros_like(q))
    pq = torch.where(sys.heavy_mask, q, torch.zeros_like(q))
    blk = torch.diag_embed(torch.stack([q, pq, pq, pq], dim=-1))
    eye = torch.eye(A, dtype=q.dtype, device=q.device)
    g = eye[None, :, :, None, None] * blk[:, :, None]
    return grid_to_mat(g)


def _elec_energy(P, F, H):
    return 0.5 * (P * (H + F)).sum(dim=(1, 2))


def _adaptive_fac(Pnew, P, Pold):
    """MOPAC cnvg.f damping factor from density-diagonal deltas."""
    d_new = torch.diagonal(Pnew, dim1=-2, dim2=-1)
    d_cur = torch.diagonal(P, dim1=-2, dim2=-1)
    d_old = torch.diagonal(Pold, dim1=-2, dim2=-1)
    num = ((d_new - d_cur) ** 2).sum(dim=-1)
    den = ((d_new - 2.0 * d_cur + d_old) ** 2).sum(dim=-1)
    return torch.sqrt(num / torch.where(den > 0.0, den, torch.ones_like(den)))


@dataclasses.dataclass
class _State:
    P: torch.Tensor
    Pold: torch.Tensor
    F: torch.Tensor
    Eelec: torch.Tensor
    err: torch.Tensor
    notconverged: torch.Tensor
    k: int
    cfock: int
    counter: int
    FOCK: torch.Tensor
    FPPF: torch.Tensor
    EMAT: torch.Tensor


def _make_density(sys: System, cfg: SCFConfig,
                  packed: Optional[Tuple[int, int]]):
    """The density solve F -> P of one SCF iteration in the run layout."""
    if packed is not None:
        K = packed[0]
        if cfg.use_sp2:
            return lambda F: sp2(sys, F, cfg.sp2_eps, cfg.sp2_tight_bounds,
                                 pack_heavy=K, prepacked=True)
        return lambda F: sym_eig(sys, F,
                                 check_degeneracy=cfg.check_degeneracy,
                                 pack_heavy=K, prepacked=True)[1]
    if cfg.use_sp2:
        return lambda F: sp2(sys, F, cfg.sp2_eps, cfg.sp2_tight_bounds,
                             pack_n=cfg.pack_orbitals,
                             pack_heavy=cfg.pack_heavy)
    return lambda F: sym_eig(sys, F, check_degeneracy=cfg.check_degeneracy,
                             pack_n=cfg.pack_orbitals,
                             pack_heavy=cfg.pack_heavy)[1]


def _layout_fock(sys: System, packed: Optional[Tuple[int, int]]):
    """(fock_of(M, w, p, P), H_of(M)): the Fock builder and the core
    Hamiltonian matrix of the run layout.  ``packed=(K, n_st)``: M is the
    packed core matrix and every iterate lives at n_st; otherwise M is the
    (nmol, A, A, 4, 4) grid and the iterates are (nmol, 4A, 4A)."""
    if packed is None:
        return (lambda M, w, p, P: fock(sys, P, M, w, p),
                lambda M: grid_to_mat(M))
    K, n_st = packed
    return (lambda M, w, p, P: fock_packed_split(sys, P, M, w, p, K, n_st),
            lambda M: M)


@torch.no_grad()
def scf_iterate(sys: System, M: torch.Tensor, w, p: Dict[str, torch.Tensor],
                P0: torch.Tensor, cfg: SCFConfig,
                packed: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the fixed-point iteration; returns (Pconv, notconverged).
    ``packed=(K, n_st)``: the whole loop runs in the static packed layout
    (M the packed core matrix, P0/P/F/DIIS buffers (nmol, n_st, n_st));
    otherwise on the full layout (M the block grid)."""
    density = _make_density(sys, cfg, packed)
    fock_m, H_of = _layout_fock(sys, packed)

    def fock_of(P):
        return fock_m(M, w, p, P)

    H = H_of(M)
    if tuple(cfg.converger) != (2,):
        raise NotImplementedError("only converger (2,) is ported yet")

    F1 = fock_of(P0)
    E1 = _elec_energy(P0, F1, H)
    nmol = P0.shape[0]
    dtype, device = P0.dtype, P0.device
    nF = torch.zeros((nmol, _NFOCK) + P0.shape[1:], dtype=dtype,
                     device=device)
    emat = torch.as_tensor(np.tril(np.eye(_NFOCK + 1) - 1.0), dtype=dtype,
                           device=device)
    st = _State(P=P0, Pold=torch.zeros_like(P0), F=F1, Eelec=E1,
                err=torch.ones_like(E1),
                notconverged=torch.ones_like(E1, dtype=torch.bool),
                k=0, cfock=0, counter=-1, FOCK=nF, FPPF=nF.clone(),
                EMAT=emat.expand(nmol, -1, -1).clone())

    # |dEelec| cannot resolve below a few ULPs of Eelec itself
    eps_mach = float(torch.finfo(dtype).eps)

    def tol(E):
        return torch.clamp(8.0 * eps_mach * torch.abs(E), min=cfg.eps)

    def finish(st, P, Pold, **extra):
        """Common tail: rebuild F, energies, masked commit."""
        nc = st.notconverged
        ncm = nc[:, None, None]
        P = torch.where(ncm, P, st.P)
        Pold = torch.where(ncm, Pold, st.Pold)
        F = fock_of(P)
        Enew = _elec_energy(P, F, H)
        err = torch.where(nc, torch.abs(Enew - st.Eelec), st.err)
        Eelec = torch.where(nc, Enew, st.Eelec)
        d = dict(P=P, Pold=Pold, F=F, Eelec=Eelec, err=err,
                 notconverged=err > tol(Eelec), k=st.k + 1)
        d.update(extra)
        return dataclasses.replace(st, **d)

    def phase_direct(st):
        return finish(st, density(st.F), st.P)

    def phase_adaptive(st):
        Pnew = density(st.F)
        fac = _adaptive_fac(Pnew, st.P, st.Pold)[:, None, None]
        return finish(st, (1.0 + fac) * Pnew - fac * st.P, st.P)

    def record(st, F, P):
        """Push (F, [F,P]) into the ring buffer and refresh the EMAT row."""
        nc = st.notconverged
        cfock = min(st.cfock + 1, _NFOCK)
        counter = (st.counter + 1) % _NFOCK
        comm = torch.triu(F @ P - P @ F)
        ncm = nc[:, None, None]
        FOCK = st.FOCK.clone()
        FPPF = st.FPPF.clone()
        FOCK[:, counter] = torch.where(ncm, F, st.FOCK[:, counter])
        FPPF[:, counter] = torch.where(ncm, comm, st.FPPF[:, counter])
        dots = torch.einsum('nij,nkij->nk', comm, FPPF)   # (nmol, 5)
        cols = torch.arange(_NFOCK, device=device) < cfock
        EMAT = st.EMAT.clone()
        EMAT[:, counter, :_NFOCK] = torch.where(
            cols[None, :] & nc[:, None], dots, st.EMAT[:, counter, :_NFOCK])
        return dict(cfock=cfock, counter=counter, FOCK=FOCK, FPPF=FPPF,
                    EMAT=EMAT)

    def phase_diis_warm(st):
        # record current (F, P), then take the new density directly
        extra = record(st, st.F, st.P)
        return finish(st, density(st.F), st.Pold, **extra)

    def phase_diis(st):
        nc = st.notconverged
        cfock, counter = st.cfock, st.counter
        # EVEC: symmetrized EMAT scaled by the newest diagonal element
        EVEC = st.EMAT + torch.tril(st.EMAT, -1).transpose(-1, -2)
        scale = EVEC[:, counter, counter][:, None, None]
        i = torch.arange(_NFOCK + 1, device=device)
        lead = (i[:, None] < cfock) & (i[None, :] < cfock)
        EVEC = torch.where(lead[None], EVEC / scale, EVEC)
        # invert the (cfock+1) leading block via identity embedding
        sel = (i[:, None] <= cfock) & (i[None, :] <= cfock)
        eye6 = torch.eye(_NFOCK + 1, dtype=dtype, device=device)
        B = torch.where(sel[None], EVEC, eye6[None])
        rhs = torch.zeros((nmol, _NFOCK + 1, 1), dtype=dtype, device=device)
        rhs[:, cfock] = 1.0
        # solve_ex: a singular system yields non-finite coefficients, which
        # the sanity guard below routes to the plain latest Fock
        col = torch.linalg.solve_ex(B, rhs)[0][..., 0]
        coeff = -col[:, :_NFOCK] * (torch.arange(_NFOCK, device=device)
                                    < cfock)
        sane = (torch.isfinite(coeff).all(dim=-1)
                & (torch.abs(coeff).amax(dim=-1) < 1.0e3))
        Fd = torch.einsum('nk,nkij->nij', coeff, st.FOCK)
        Fd = torch.where((nc & sane)[:, None, None], Fd, st.F)

        ncm = nc[:, None, None]
        P = torch.where(ncm, density(Fd), st.P)
        F = torch.where(ncm, fock_of(P), st.F)
        extra = record(dataclasses.replace(st, P=P, F=F), F, P)
        Enew = _elec_energy(P, F, H)
        err = torch.where(nc, torch.abs(Enew - st.Eelec), st.err)
        Eelec = torch.where(nc, Enew, st.Eelec)
        return dataclasses.replace(st, P=P, F=F, Eelec=Eelec, err=err,
                                   notconverged=err > tol(Eelec), k=st.k + 1,
                                   **extra)

    def body(st):
        if st.k < 2:
            return phase_direct(st)
        if st.k < 3:
            return phase_adaptive(st)
        return phase_diis_warm(st) if st.cfock < 2 else phase_diis(st)

    while st.k < cfg.max_iter and bool(st.notconverged.any()):
        for _ in range(_CHUNK):
            st = body(st)

    npolish = cfg.polish_iters
    if npolish is None:
        npolish = 8 if dtype == torch.float32 else 0
    if npolish:
        # run the adaptive-mixing map on every molecule; the flags reported
        # are the pre-polish ones (the energy criterion's verdict)
        nc_final = st.notconverged
        all_on = torch.ones_like(nc_final)
        st = dataclasses.replace(st, notconverged=all_on)
        for _ in range(int(npolish)):
            st = dataclasses.replace(phase_adaptive(st), notconverged=all_on)
        st = dataclasses.replace(st, notconverged=nc_final)
    return st.P, st.notconverged


def scf_solve(const: Constants, sys: System, M: torch.Tensor, w,
              p: Dict[str, torch.Tensor], cfg: SCFConfig,
              P0: Optional[torch.Tensor] = None,
              packed: Optional[Tuple[int, int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SCF solve with backward mode 0 (modes 1 and 2 are not ported yet).

    ``packed=(K, n_st)`` runs the fixed point in the static packed layout
    (M the packed core matrix) and returns Pconv (nmol, n_st, n_st);
    otherwise M is the block grid and Pconv (nmol, 4A, 4A).  Returns
    (Pconv, notconverged).  The density is a constant for autograd
    (Hellmann-Feynman forces); inputs are detached so the fixed-point loop
    is never recorded.  P0 may be given in either layout.
    """
    pscf = {k: p[k].detach() for k in SCF_PARAM_NAMES}
    if P0 is None:
        P0 = init_density(const, sys)
    if packed is not None and P0.shape[-1] != packed[1]:
        P0 = static_pack_mat(P0, packed[0], packed[1])
    w0 = type(w)(*[t.detach() if torch.is_tensor(t) else
                   type(t)(*[u.detach() for u in t]) for t in w])
    P, nc = scf_iterate(sys, M.detach(), w0, pscf, P0.detach(), cfg, packed)
    if cfg.raise_on_forward_failure and bool(nc.any()):
        bad = torch.nonzero(nc).flatten().tolist()
        raise SCFConvergenceError(f"SCF forward failed for molecules {bad}")
    return P, nc
