"""SCF engine: the three convergers and the three backward modes.

PyTorch counterpart of ``pyseqm_tpu/scf.py`` (cf. the reference
scf_loop.py:32-806), on the full (nmol, 4A, 4A) layout with the block-grid
Fock build (``fock``) and on the static packed layout
(``fock_packed_split``).  Each iteration's density comes from the
eigensolver (``sym_eig``, the default) or SP2 (``use_sp2``).

Convergers: 0 constant mixing (``(0, alpha)``), 1 two direct steps then
adaptive mixing, 2 two direct steps, one adaptive-mixing step, then Pulay
DIIS.  The fixed point runs as a Python loop over masked batched updates:
converged molecules stop changing but keep riding the batch, and the host
checks convergence once per _CHUNK iterations (the JAX package's default
chunk, which fixes where max_iter can overshoot).

The DIIS machinery (nFock=5 ring buffer of [F,P] commutators, EMAT linear
system, scf_loop.py:264-510) uses fixed-size buffers with a modular counter
and a masked identity-embedded 6x6 solve.

Differentiation (``SCFConfig.backward``):

- 0 (Hellmann-Feynman): the converged density is a constant; energy terms
  still differentiate through Hcore and the integrals.
- 1 (recursive adjoint, cf. SCF.backward, scf_loop.py:557-657): an
  autograd.Function whose backward iterates vector-Jacobian products of
  one Fock + eigh step at the converged density until the running
  cotangent decays (the JAX package's custom_vjp; once differentiable).
- 2 (unrolled): a fixed number of masked iterations recorded by autograd,
  so reverse mode differentiates through them, twice for Hessians.

Both differentiable routes solve the density with ``sym_eig``: SP2 has no
derivative.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .constants import Constants
from .ops.density import sp2, static_pack_mat, sym_eig
from .ops.fock import fock, fock_packed_split
from .ops.matrix import grid_to_mat
from .system import System
from .utils.timing import count, span

SCF_PARAM_NAMES = ("g_ss", "g_pp", "g_sp", "g_p2", "h_sp")

_NFOCK = 5
_CHUNK = 4

# adjoint iterations run by backward mode 1, and molecules whose gradients
# it zeroed as backward failures (plain integers; reset by callers that
# count)
adjoint_iterations = 0
backward_failures = 0


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
    backward: int = 0                   # 0 HF | 1 adjoint | 2 unrolled
    # mode 1: stop when the converged molecules' max |cotangent| < eps;
    # at most backward_max_iter iterations; a growing cotangent >= 1 stops
    # it as diverged only after backward_diverge_min_iter iterations
    backward_eps: float = 1.0e-2
    backward_max_iter: int = 10
    backward_diverge_min_iter: int = 5
    backward_scan_iters: int = 100      # mode 2: iterations unrolled
    # raise instead of warn+mask when molecules fail to converge
    # (cf. RAISE_ERROR_IF_SCF_FORWARD/BACKWARD_FAILS, scf_loop.py:23-27)
    raise_on_forward_failure: bool = False
    raise_on_backward_failure: bool = False
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
    # here is full float32.  Its chunk (iterations per while_loop trip) is
    # the fixed _CHUNK here.


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
    # a constant when differentiating through the loop (cf. the no_grad
    # block in scf_loop.py:199-208)
    return torch.sqrt(num / torch.where(den > 0.0, den, torch.ones_like(
        den))).detach()


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
                  packed: Optional[Tuple[int, int]],
                  differentiable: bool = False):
    """The density solve F -> P of one SCF iteration in the run layout
    (always sym_eig when the loop is differentiated)."""
    sp2_on = cfg.use_sp2 and not differentiable
    if packed is not None:
        K = packed[0]
        if sp2_on:
            return lambda F: sp2(sys, F, cfg.sp2_eps, cfg.sp2_tight_bounds,
                                 pack_heavy=K, prepacked=True)
        return lambda F: sym_eig(sys, F,
                                 check_degeneracy=cfg.check_degeneracy,
                                 pack_heavy=K, prepacked=True)[1]
    if sp2_on:
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
        def fock_of(M, w, p, P):
            with span("fock"):
                return fock(sys, P, M, w, p)
        return fock_of, lambda M: grid_to_mat(M)
    K, n_st = packed

    def fock_of(M, w, p, P):
        with span("fock"):
            return fock_packed_split(sys, P, M, w, p, K, n_st)
    return fock_of, lambda M: M


def scf_iterate(sys: System, M: torch.Tensor, w, p: Dict[str, torch.Tensor],
                P0: torch.Tensor, cfg: SCFConfig,
                packed: Optional[Tuple[int, int]] = None,
                differentiable: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the fixed-point iteration; returns (Pconv, notconverged).
    ``packed=(K, n_st)``: the whole loop runs in the static packed layout
    (M the packed core matrix, P0/P/F/DIIS buffers (nmol, n_st, n_st));
    otherwise on the full layout (M the block grid).

    ``differentiable=False`` iterates under no_grad until every molecule
    converges or max_iter, then polishes; ``differentiable=True`` runs
    exactly ``cfg.backward_scan_iters`` masked iterations recorded by
    autograd and no polish (backward mode 2, the JAX package's
    lax.scan)."""
    with contextlib.nullcontext() if differentiable else torch.no_grad():
        return _iterate(sys, M, w, p, P0, cfg, packed, differentiable)


def _iterate(sys, M, w, p, P0, cfg, packed, differentiable):
    density = _make_density(sys, cfg, packed, differentiable)
    fock_m, H_of = _layout_fock(sys, packed)

    def fock_of(P):
        return fock_m(M, w, p, P)

    H = H_of(M)
    conv = cfg.converger[0]
    if conv not in (0, 1, 2):
        raise ValueError(f"unknown converger {cfg.converger}")
    alpha = cfg.converger[1] if conv == 0 else 0.0

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

    def phase_mix(st):
        return finish(st, alpha * st.P + (1.0 - alpha) * density(st.F), st.P)

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
        if conv == 0:
            return phase_mix(st)
        if st.k < 2:
            return phase_direct(st)
        if conv == 1 or st.k < 3:
            return phase_adaptive(st)
        return phase_diis_warm(st) if st.cfock < 2 else phase_diis(st)

    if differentiable:
        for _ in range(cfg.backward_scan_iters):
            st = body(st)
        count("iterations", st.k)
        return st.P, st.notconverged

    def unconverged():
        """The host's read of the flags, which waits for the card."""
        with span("scf.read"):
            out = bool(st.notconverged.any())
        count("reads", 1)
        return out

    while st.k < cfg.max_iter and unconverged():
        for _ in range(_CHUNK):
            st = body(st)
    count("iterations", st.k)

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
        count("polish", int(npolish))
        st = dataclasses.replace(st, notconverged=nc_final)
    return st.P, st.notconverged


def _flatten(w):
    """(tensor leaves, rebuild) of an integrals NamedTuple that may nest
    others (WPackSplit, WPackGridSplit); rebuild(iter(leaves)) gives it
    back."""
    if torch.is_tensor(w):
        return [w], lambda it: next(it)
    subs = [_flatten(t) for t in w]
    return ([leaf for leaves, _ in subs for leaf in leaves],
            lambda it: type(w)(*[rebuild(it) for _, rebuild in subs]))


def _eig_step(sys: System, cfg: SCFConfig,
              packed: Optional[Tuple[int, int]]):
    """step(P, M, w, p) = sym_eig(fock_of(M, w, p, P)): the SCF map whose
    fixed point the adjoint differentiates."""
    fock_m, _ = _layout_fock(sys, packed)
    if packed is not None:
        return lambda P, M, w, p: sym_eig(sys, fock_m(M, w, p, P),
                                          pack_heavy=packed[0],
                                          prepacked=True)[1]
    return lambda P, M, w, p: sym_eig(sys, fock_m(M, w, p, P),
                                      pack_n=cfg.pack_orbitals,
                                      pack_heavy=cfg.pack_heavy)[1]


@dataclasses.dataclass
class _Run:
    """What the adjoint needs besides its tensor inputs."""
    sys: System
    cfg: SCFConfig
    packed: Optional[Tuple[int, int]]
    rebuild: object
    nw: int
    P0: torch.Tensor


class _SCFAdjoint(torch.autograd.Function):
    """(P, notconverged) = scf_iterate(...) with the recursive-adjoint VJP
    (backward mode 1; the JAX package's custom_vjp make_scf_apply).  The
    tensor inputs are M, the integrals' leaves and the five SCF
    parameters, each with the molecule axis first."""

    @staticmethod
    def forward(ctx, run, M, *leaves):
        w = run.rebuild(iter(leaves[:run.nw]))
        pscf = dict(zip(SCF_PARAM_NAMES, leaves[run.nw:]))
        P, nc = scf_iterate(run.sys, M, w, pscf, run.P0, run.cfg, run.packed)
        ctx.run = run
        ctx.save_for_backward(M, *leaves, P, nc)
        ctx.mark_non_differentiable(nc)
        return P, nc

    @staticmethod
    @once_differentiable
    def backward(ctx, gP, _gnc):
        global adjoint_iterations, backward_failures
        run, cfg = ctx.run, ctx.run.cfg
        *ins, P, nc = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        none = (None,) * (1 + len(ins))
        if gP is None or not any(need):
            return none
        # one Fock + eigh step at the converged density, built once: its
        # VJP is iterated, so the eigensolver's rescue check runs once
        with torch.enable_grad():
            Pc = P.detach().requires_grad_(True)
            xs = [t.detach().requires_grad_(n) for t, n in zip(ins, need)]
            w = run.rebuild(iter(xs[1:1 + run.nw]))
            pscf = dict(zip(SCF_PARAM_NAMES, xs[1 + run.nw:]))
            Pout = _eig_step(run.sys, cfg, run.packed)(Pc, xs[0], w, pscf)
        wrt = [Pc] + [x for x, n in zip(xs, need) if n]
        acc = [torch.zeros_like(x) for x in wrt[1:]]
        converged = ~nc

        def gmax(g):
            return g.abs().amax(dim=(1, 2))

        g, last_max, k = gP, gmax(gP), 0
        while k < cfg.backward_max_iter:
            got = torch.autograd.grad(Pout, wrt, g, retain_graph=True,
                                      allow_unused=True)
            g = got[0] if got[0] is not None else torch.zeros_like(P)
            acc = [a if t is None else a + t for a, t in zip(acc, got[1:])]
            cur = gmax(g)
            err = torch.where(converged, cur, torch.zeros_like(cur)).max()
            diverged = ((cur > last_max) & (cur >= 1.0)).any()
            last_max, k = cur, k + 1
            if bool((err < cfg.backward_eps)
                    | (diverged & (k >= cfg.backward_diverge_min_iter))):
                break
        adjoint_iterations += k
        # zero the gradients of molecules that failed forward or backward
        bad = nc | (last_max > cfg.backward_eps) | ~torch.isfinite(last_max)
        failed = bad & ~nc
        backward_failures += int(failed.sum())
        if cfg.raise_on_backward_failure and bool(failed.any()):
            raise SCFConvergenceError(
                f"SCF backward failed for molecules "
                f"{torch.nonzero(failed).flatten().tolist()}")
        keep = ~bad
        it = iter(a * keep.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)
                  for a in acc)
        return (None,) + tuple(next(it) if n else None for n in need)


def scf_solve(const: Constants, sys: System, M: torch.Tensor, w,
              p: Dict[str, torch.Tensor], cfg: SCFConfig,
              P0: Optional[torch.Tensor] = None,
              packed: Optional[Tuple[int, int]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SCF solve dispatched on ``cfg.backward`` (cf. scf_loop,
    scf_loop.py:671).  Returns (Pconv, notconverged).

    Mode 0 returns a constant density (Hellmann-Feynman forces; the inputs
    are detached so the loop is never recorded), mode 1 attaches the
    recursive adjoint, mode 2 (converger (0, alpha) or (1,); always from
    the initial guess) differentiates through the unrolled iterations.
    ``packed=(K, n_st)`` runs the fixed point in the static packed layout
    (M the packed core matrix) and returns Pconv (nmol, n_st, n_st);
    otherwise M is the block grid and Pconv (nmol, 4A, 4A).  P0 may be
    given in either layout and carries no gradient.
    """
    with span("scf"):
        pscf = {k: p[k] for k in SCF_PARAM_NAMES}
        if P0 is None or cfg.backward == 2:
            P0 = init_density(const, sys)
        if packed is not None and P0.shape[-1] != packed[1]:
            P0 = static_pack_mat(P0, packed[0], packed[1])
        P0 = P0.detach()
        if cfg.backward == 0:
            leaves, rebuild = _flatten(w)
            P, nc = scf_iterate(sys, M.detach(),
                                rebuild(iter([t.detach() for t in leaves])),
                                {k: v.detach() for k, v in pscf.items()}, P0,
                                cfg, packed)
        elif cfg.backward == 1:
            leaves, rebuild = _flatten(w)
            run = _Run(sys, cfg, packed, rebuild, len(leaves), P0)
            P, nc = _SCFAdjoint.apply(run, M, *leaves,
                                      *[pscf[k] for k in SCF_PARAM_NAMES])
        elif cfg.backward == 2:
            if cfg.converger[0] not in (0, 1):
                raise ValueError("backward mode 2 requires converger "
                                 "(0, alpha) or (1,)")
            P, nc = scf_iterate(sys, M, w, pscf, P0, cfg, packed,
                                differentiable=True)
        else:
            raise ValueError(f"unknown backward mode {cfg.backward}")
        if cfg.raise_on_forward_failure:
            with span("scf.read"):
                failed = bool(nc.any())
            count("reads", 1)
            if failed:
                bad = torch.nonzero(nc).flatten().tolist()
                raise SCFConvergenceError(
                    f"SCF forward failed for molecules {bad}")
        return P, nc
