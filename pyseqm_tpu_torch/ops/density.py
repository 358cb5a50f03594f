"""Density matrices by eigendecomposition or SP2 purification.

PyTorch counterpart of ``pyseqm_tpu/ops/density.py`` (cf. the reference
diag.py, SP2.py and pack.py): the static compact-orbital packing helpers,
``sym_eig`` and ``sp2`` on every route (``prepacked``, ``pack_heavy``, and
the valid-first orbital permutation, optionally cut to ``pack_n``), the
rescue of unconverged Jacobi molecules, the Gelfand-refined spectral
bounds of SP2 (``tight_bounds``) and ``eigh_rescue``, the exact re-solve
of the worst SP2 molecules.

The algorithm is chosen by dtype and size, as the JAX package chooses it
on its production backend: float32 at n <= 128 runs the kernels'
semantics (ops/eigh_kernel.py and ops/sp2_kernel.py: the hand-written
CUDA kernel on a card, its plain version on the CPU); float64 or larger n
runs torch.linalg.eigh, or the loop of the JAX package's XLA-path SP2 in
plain torch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as nnf

from ..system import System
from ..utils.timing import count, span, tracing
from . import eigh_kernel
from .eigh_kernel import eigh_batched_checked
from .sp2_kernel import MAX_N, sp2_purify

SP2_MAX_ITER = 200

# molecules re-solved by rescue_unconverged_panels, and iterations run by
# the SP2 loop of n > 128 or float64 (plain integers; reset by callers that
# count)
rescued = 0
sp2_iterations = 0


def orbital_mask(sys: System) -> torch.Tensor:
    """(nmol, 4A) bool: which orbital rows are physical."""
    per_atom = torch.stack(
        [sys.atom_mask, sys.heavy_mask, sys.heavy_mask, sys.heavy_mask],
        dim=-1)  # (nmol, A, 4)
    return per_atom.reshape(sys.species.shape[0], -1)


def orbital_permutation(sys: System):
    """Stable permutation packing valid orbitals first; plus its inverse."""
    invalid = (~orbital_mask(sys)).to(torch.int8)
    perm = torch.argsort(invalid, dim=-1, stable=True)
    inv = torch.argsort(perm, dim=-1)
    return perm, inv


def permute_mat(X, perm):
    X = torch.take_along_dim(X, perm[:, :, None], dim=1)
    return torch.take_along_dim(X, perm[:, None, :], dim=2)


def _gershgorin(Xp):
    aii = torch.diagonal(Xp, dim1=-2, dim2=-1)
    ri = torch.abs(Xp).sum(dim=-1) - torch.abs(aii)
    h1 = (aii - ri).min(dim=-1).values
    hN = (aii + ri).max(dim=-1).values
    return h1, hN


def _set_diag(X, diag):
    """X with its diagonal replaced by ``diag`` (out of place)."""
    eye = torch.eye(X.shape[-1], dtype=torch.bool, device=X.device)
    return torch.where(eye, torch.diag_embed(diag), X)


def _fill_padding_diag(Xp, norb, h1, hN, dx=0.005):
    """Distinct large diagonal values on padding rows (cf. diag.py:120-130).

    Spacing keeps padding eigenvalues non-degenerate so eigh stays
    differentiable."""
    n = Xp.shape[-1]
    idx = torch.arange(n, device=Xp.device)
    pad = idx[None, :] >= norb[:, None]
    k = idx[None, :] - norb[:, None] + 1  # 1-based padding position
    dE = hN - h1
    val = (1.0 + dx * k.to(Xp.dtype)) * dE[:, None] + hN[:, None]
    diag = torch.where(pad, val, torch.diagonal(Xp, dim1=-2, dim2=-1))
    return _set_diag(Xp, diag)


def _occupations(e, nocc, dtype, check_degeneracy: bool):
    """Per-orbital occupation coefficients (0/1, or fractional across a
    degenerate Fermi level when check_degeneracy; cf. construct_P,
    diag.py:79-98, batched)."""
    n = e.shape[-1]
    idx = torch.arange(n, device=e.device)
    if not check_degeneracy:
        return (idx[None, :] < nocc[:, None]).to(dtype)
    atol = 1.0e-7 if dtype == torch.float32 else 1.0e-14
    homo = torch.clamp(nocc - 1, min=0)
    e_homo = torch.take_along_dim(e, homo[:, None], dim=1)
    cond = (torch.abs(e - e_homo) <= atol).to(torch.int32)
    idx1 = torch.argmax(cond, dim=1)                          # first
    idx2 = n - torch.argmax(torch.flip(cond, dims=[1]), dim=1)  # last + 1
    frac = (nocc - idx1).to(dtype) / (idx2 - idx1).to(dtype)
    one, zero = torch.ones_like(e), torch.zeros_like(e)
    occ = torch.where(idx[None, :] < idx1[:, None], one,
                      torch.where(idx[None, :] < idx2[:, None],
                                  frac[:, None] * one, zero))
    return occ.to(dtype)


def _pack_slice(Fp, pack_n: int):
    """The valid-orbitals-first permuted matrix cut to the static compact
    size: rows >= pack_n are decoupled padding, so the retained spectrum is
    unchanged."""
    return Fp[:, :pack_n, :pack_n]


def _unpack_embed(Pp, n: int):
    """Embed a compact (nmol, m, m) block back into (nmol, n, n)."""
    m = Pp.shape[-1]
    if m == n:
        return Pp
    return nnf.pad(Pp, (0, n - m, 0, n - m))


def rescue_unconverged_panels(Fp, e0, v, resid):
    """Re-solve molecules whose Jacobi sweeps stopped at MAX_SWEEPS
    unconverged (resid > OFF_TOL) with torch.linalg.eigh, on those
    molecules only.  Costs one host check when nothing failed.  Returns
    (e, v, failed_mask); callers surface failed_mask like the SCF
    notconverged flag (cf. reference diag.py:102-139, whose eigh is
    always exact)."""
    global rescued
    bad = resid > eigh_kernel.OFF_TOL
    if bool(bad.any()):
        idx = torch.nonzero(bad).flatten()
        ex, vx = torch.linalg.eigh(Fp[idx])
        e0 = e0.index_put((idx,), ex.to(e0.dtype))
        v = v.index_put((idx,), vx.to(v.dtype))
        rescued += int(idx.numel())
    return e0, v, bad


def sym_eig(sys: System, F: torch.Tensor, eig_only: bool = False,
            check_degeneracy: bool = False, pack_n: Optional[int] = None,
            pack_heavy: Optional[int] = None, prepacked: bool = False,
            with_flag: bool = False):
    """Batched eigendecomposition of the Fock matrix (cf. sym_eig_trunc /
    construct_P, diag.py:57-139).

    Returns (e, P, v): orbital energies zero-padded after norb, the
    density P = 2 V_occ V_occ^T in the caller's layout, and the
    eigenvectors v in the solver's layout: permuted valid-first rows at
    4A, or the static compact layout when pack_heavy is set.
    ``eig_only`` returns (e, v); ``with_flag`` appends the mask of
    molecules whose Jacobi sweeps failed and were re-solved exactly.

    ``prepacked``: F is already in the static packed layout at
    packed_solver_size(pack_heavy, A) and P (and e, at length n_st) stays
    packed.  ``pack_heavy`` without ``prepacked`` packs a (nmol, 4A, 4A) F
    for the solve and unpacks P.  Otherwise the valid orbitals are
    permuted to the front at full 4A, and with ``pack_n`` (=
    packed_orbital_size(species)) the permuted matrix is cut to its first
    pack_n rows and columns (pure decoupled padding beyond every molecule's
    norb), so the solve runs at pack_n.
    """
    with span("density"):
        count("molecules", F.shape[0])
        return _sym_eig(sys, F, eig_only, check_degeneracy, pack_n,
                        pack_heavy, prepacked, with_flag)


def _sym_eig(sys, F, eig_only, check_degeneracy, pack_n, pack_heavy,
             prepacked, with_flag):
    n = F.shape[-1]
    A = sys.species.shape[1]
    n_st = None
    if prepacked:
        if pack_heavy is None:
            raise ValueError("prepacked=True requires pack_heavy")
        n_st = packed_solver_size(pack_heavy, A)
        if n_st is None or n != n_st:
            raise ValueError(f"prepacked F has n={n}, expected "
                             f"packed_solver_size={n_st}")
    elif pack_heavy is not None:
        n_st = static_pack_size(pack_heavy, A, multiple=16)
        if n_st > 128:
            n_st = static_pack_size(pack_heavy, A, multiple=128)
        if n_st >= n:
            n_st = None
    if n_st is not None:
        mfull = orbital_mask(sys).to(F.dtype)
        mk = static_pack_vec(mfull, pack_heavy, n_st)
        if prepacked:
            Fp = F * (mk[:, :, None] * mk[:, None, :])
        else:
            Fp = static_pack_mat(F * (mfull[:, :, None] * mfull[:, None, :]),
                                 pack_heavy, n_st)
        h1, hN = _gershgorin(Fp)
        # dead rows (interior p rows of lighter molecules, tail padding)
        # get distinct above-spectrum diagonal values (cf. diag.py:120-130)
        idxs = torch.arange(n_st, device=F.device)
        val = ((1.0 + 0.005 * (idxs + 1).to(F.dtype)) * (hN - h1)[:, None]
               + hN[:, None])
        Fp = _set_diag(Fp, torch.where(mk == 0.0, val, torch.diagonal(
            Fp, dim1=-2, dim2=-1)))
        m = mk if prepacked else mfull

        def unpack(a):
            return a if prepacked else static_unpack_mat(a, pack_heavy, A)
    else:
        perm, inv = orbital_permutation(sys)
        Fp = permute_mat(F, perm)
        if pack_n is not None and pack_n < n:
            Fp = _pack_slice(Fp, pack_n)
        h1, hN = _gershgorin(Fp)
        Fp = _fill_padding_diag(Fp, sys.norb, h1, hN)
        m = orbital_mask(sys).to(F.dtype)

        def unpack(a):
            return permute_mat(_unpack_embed(a, n), inv)

    if eigh_kernel.supported(Fp.shape[-1], F.dtype):
        # the Jacobi kernel's semantics; molecules whose sweeps stopped at
        # MAX_SWEEPS are re-solved exactly, as the reference's eigh cannot
        # fail silently
        e0, v, resid = eigh_batched_checked(Fp)
        e0, v, eig_failed = rescue_unconverged_panels(Fp, e0, v, resid)
    else:
        e0, v = torch.linalg.eigh(Fp)
        eig_failed = torch.zeros((F.shape[0],), dtype=torch.bool,
                                 device=F.device)
    ne = e0.shape[-1]
    idx = torch.arange(ne, device=F.device)
    e = torch.where(idx[None, :] < sys.norb[:, None], e0,
                    torch.zeros_like(e0))
    if ne < n:
        e = nnf.pad(e, (0, n - ne))
    if eig_only:
        return (e, v, eig_failed) if with_flag else (e, v)

    occ = _occupations(e0, sys.nocc, F.dtype, check_degeneracy)
    Pp = 2.0 * torch.einsum('nik,nk,njk->nij', v, occ, v)
    P = unpack(Pp) * (m[:, :, None] * m[:, None, :])
    return (e, P, v, eig_failed) if with_flag else (e, P, v)


def packed_orbital_size(species, multiple: int = 128) -> int:
    """Compact-orbital size for SCFConfig.pack_orbitals (host-side):
    ceil(max norb / multiple) * multiple, clamped to 4A, the smallest
    aligned size holding every molecule's physical orbitals (hydrogens 1,
    heavies 4).  At 884 atoms / 1766 orbitals: 1792 against 3536."""
    sp = np.asarray(species.cpu() if torch.is_tensor(species) else species)
    norb_max = int((4 * (sp > 1).sum(axis=-1) + (sp == 1).sum(axis=-1)).max())
    return int(min(4 * sp.shape[-1], -(-norb_max // multiple) * multiple))


def packed_heavy_count(species) -> int:
    """Max heavy-atom count K for SCFConfig.pack_heavy (host-side).

    The static packed layout keeps the full 4-orbital block for the first K
    atom slots and only the s orbital for the rest, valid because atoms are
    sorted by descending Z (validated here)."""
    sp = np.asarray(species.cpu() if torch.is_tensor(species) else species)
    K = int((sp > 1).sum(axis=-1).max())
    if not (sp[..., K:] <= 1).all():
        raise ValueError(
            "static orbital packing requires atoms sorted by descending "
            "atomic number (heavy atoms first in every molecule)")
    return K


def static_pack_size(K: int, A: int, multiple: int = 16) -> int:
    """4K heavy-block orbitals plus one s orbital per remaining atom slot,
    rounded up to ``multiple``, clamped to the full 4A."""
    return int(min(4 * A, -(-(3 * K + A) // multiple) * multiple))


def packed_solver_size(K: int, A: int) -> Optional[int]:
    """The static packed size the density solvers run at: 16-aligned inside
    the purifier kernel's n <= 128 range, 128-aligned beyond it, None when
    packing cannot shrink 4A.  Every producer and consumer of packed
    matrices uses this rule so layouts agree."""
    n_st = static_pack_size(K, A, multiple=16)
    if n_st > 128:
        n_st = static_pack_size(K, A, multiple=128)
    return None if n_st >= 4 * A else n_st


def _static_pack_rows(X, K: int, n_st: int):
    """(B, 4A, c) -> (B, n_st, c): rows [0, 4K), then the s row of every
    later atom, zero padded."""
    B, r, c = X.shape
    A = r // 4
    hs = X.reshape(B, A, 4, c)[:, K:, 0, :]
    rows = torch.cat([X[:, :4 * K], hs], dim=1)
    if n_st > rows.shape[1]:
        rows = nnf.pad(rows, (0, 0, 0, n_st - rows.shape[1]))
    return rows


def static_pack_mat(X, K: int, n_st: int):
    """(B, 4A, 4A) -> (B, n_st, n_st) static compact layout."""
    Xp = _static_pack_rows(X, K, n_st)
    Xp = _static_pack_rows(Xp.transpose(1, 2), K, n_st)
    return Xp.transpose(1, 2)


def static_pack_vec(v, K: int, n_st: int):
    """(B, 4A) -> (B, n_st)."""
    return _static_pack_rows(v[:, :, None], K, n_st)[:, :, 0]


def _static_unpack_rows(Xp, K: int, A: int):
    """(B, n_st, c) -> (B, 4A, c): re-expand the s-only tail with zero
    p rows."""
    B, _, c = Xp.shape
    heavy = Xp[:, :4 * K]
    hs = Xp[:, 4 * K:4 * K + (A - K)]
    z = torch.zeros((B, A - K, 3, c), dtype=Xp.dtype, device=Xp.device)
    hyd = torch.cat([hs[:, :, None, :], z], dim=2)
    return torch.cat([heavy, hyd.reshape(B, 4 * (A - K), c)], dim=1)


def static_unpack_mat(Xp, K: int, A: int):
    """(B, n_st, n_st) -> (B, 4A, 4A), zeros on the dropped p rows/cols."""
    X = _static_unpack_rows(Xp, K, A)
    X = _static_unpack_rows(X.transpose(1, 2), K, A)
    return X.transpose(1, 2)


def _sp2_loop(a0, noccd, eps, f32):
    """The JAX package's XLA-path SP2 loop (density.py:656-750) in plain
    torch: masked per-molecule updates, a running trace from scalars
    refreshed from the iterate every CHUNK iterations, and the host checks
    convergence once per chunk."""
    global sp2_iterations
    n = a0.shape[-1]
    tr = torch.diagonal(a0, dim1=-2, dim2=-1).sum(dim=-1)
    err0 = torch.abs(tr - noccd)
    errm0, errm1, errm2 = err0, err0, err0
    nc = torch.ones_like(err0, dtype=torch.bool)
    chunk = 16 if n < 1024 else 4
    k = 0
    while k < SP2_MAX_ITER and bool(nc.any()):
        for _ in range(chunk):
            a2 = a0 @ a0
            # tr(a^2) = |a|_F^2 for symmetric a, summed row-first
            tr_a2 = (a0 * a0).sum(dim=-1).sum(dim=-1)
            take_sq = (torch.abs(tr_a2 - noccd)
                       < torch.abs(2.0 * tr - tr_a2 - noccd))
            sel = (nc & take_sq)[:, None, None]
            ncm = nc[:, None, None]
            a0 = torch.where(sel, a2, torch.where(ncm, 2.0 * a0 - a2, a0))
            tr_new = torch.where(take_sq, tr_a2, 2.0 * tr - tr_a2)
            tr = torch.where(nc, tr_new, tr)
            e0 = torch.where(nc, torch.abs(tr - noccd), errm0)
            e1 = torch.where(nc, errm0, errm1)
            e2 = torch.where(nc, errm1, errm2)
            errm0, errm1, errm2 = e0, e1, e2
            if f32:
                done = (errm0 < eps) & (errm0 >= errm2)
            else:
                done = (errm0 < eps) & (errm1 < eps)
            nc = nc & ~done
            k += 1
        tr_exact = torch.diagonal(a0, dim1=-2, dim2=-1).sum(dim=-1)
        tr = torch.where(nc, tr_exact, tr)
    sp2_iterations += k
    return 2.0 * a0


def _gelfand_radius(Fc, sigma, squarings: int = 2):
    """Upper bound on max |lambda(Fc) - sigma| by Gelfand squaring:
    gersh((Fc - sigma I)^(2^k))^(2^-k), one batched product per squaring
    (normalized against overflow).  Tighter bounds than Gershgorin give
    SP2 a larger scaled gap: fewer iterations, less amplified noise."""
    n = Fc.shape[-1]
    eye = torch.eye(n, dtype=Fc.dtype, device=Fc.device)
    B = Fc - eye[None] * sigma[:, None, None]
    logr = torch.zeros_like(sigma)
    for k in range(squarings):
        B = B @ B
        g = torch.clamp(B.abs().sum(dim=-1).amax(dim=-1), min=1.0e-30)
        logr = logr + torch.log(g) / (2.0 ** (k + 1))
        B = B / g[:, None, None]
    return torch.exp(logr)


def _sp2_prep(sys: System, F: torch.Tensor, tight_bounds: bool,
              pack_n: Optional[int], pack_heavy: Optional[int],
              prepacked: bool):
    """(a0, nocc, out_mask, unpack, kernel): the pre-scaled SP2 iterate
    a0 = (hN I - F)/(hN - h1) in the solver's layout, the occupied counts,
    the orbital mask of the caller's layout, the map of the solver's
    layout back to it, and whether the purifier kernel's semantics apply
    (float32, n <= 128).  Padding orbitals are pinned at occupation zero
    by setting their diagonal to hN.

    Layouts: the static packed one (``pack_heavy``, when packing shrinks
    4A, or ``prepacked``); at kernel sizes the caller's own layout with
    padding pinned in place (SP2 sorts no eigenvalues, so it needs no
    permutation); otherwise the valid-first orbital permutation, cut to
    ``pack_n``.
    """
    dtype = F.dtype
    A = sys.species.shape[1]
    n_full = F.shape[-1]
    n_st = None
    if prepacked:
        if pack_heavy is None:
            raise ValueError("prepacked=True requires pack_heavy")
        n_st = packed_solver_size(pack_heavy, A)
        if n_st is None or n_full != n_st:
            raise ValueError(f"prepacked F has n={n_full}, expected "
                             f"packed_solver_size={n_st}")
    elif pack_heavy is not None:
        n_st = packed_solver_size(pack_heavy, A)
    m = orbital_mask(sys).to(dtype)
    kernel = dtype == torch.float32 and (n_st or n_full) <= MAX_N
    if n_st is not None:
        mk = static_pack_vec(m, pack_heavy, n_st)
        Fm = (F * (mk[:, :, None] * mk[:, None, :]) if prepacked else
              static_pack_mat(F * (m[:, :, None] * m[:, None, :]),
                              pack_heavy, n_st))
        pad = mk == 0.0
        mout = mk if prepacked else m

        def unpack(a):
            return a if prepacked else static_unpack_mat(a, pack_heavy, A)
    elif kernel:
        Fm = F * (m[:, :, None] * m[:, None, :])
        pad = m == 0.0
        mout = m

        def unpack(a):
            return a
    else:
        perm, inv = orbital_permutation(sys)
        Fm = permute_mat(F, perm)
        if pack_n is not None and pack_n < n_full:
            # the whole iteration at the compact valid-orbital size
            Fm = _pack_slice(Fm, pack_n)
        idx = torch.arange(Fm.shape[-1], device=F.device)
        pad = idx[None, :] >= sys.norb[:, None]
        mout = m

        def unpack(a):
            return permute_mat(_unpack_embed(a, n_full), inv)
    h1, hN = _gershgorin(Fm)
    dg = torch.diagonal(Fm, dim1=-2, dim2=-1)
    if tight_bounds:
        # pin padding mid-spectrum so it cannot widen the estimate, refine,
        # then pin it at the tightened upper bound below
        sigma = 0.5 * (h1 + hN)
        r = 1.02 * _gelfand_radius(
            _set_diag(Fm, torch.where(pad, sigma[:, None], dg)), sigma)
        h1 = torch.maximum(h1, sigma - r)
        hN = torch.minimum(hN, sigma + r)
    Fp = _set_diag(Fm, torch.where(pad, hN[:, None], dg))
    eye = torch.eye(Fm.shape[-1], dtype=dtype, device=F.device)
    # a molecule without orbitals (a padding row of species 0) has F = 0
    # and h1 = hN = 0: its a0 is 0, not 0/0, so it purifies to P = 0
    width = hN - h1
    width = torch.where(width > 0, width, torch.ones_like(width))
    a0 = (eye * hN[:, None, None] - Fp) / width[:, None, None]
    return a0.contiguous(), sys.nocc.to(dtype), mout, unpack, kernel


def sp2_input(sys: System, F: torch.Tensor, pack_heavy: int,
              prepacked: bool = False):
    """(a0, nocc, mk): the pre-scaled SP2 iterate in the static packed
    layout, the occupied counts and the packed orbital mask."""
    A = sys.species.shape[1]
    if packed_solver_size(pack_heavy, A) is None:
        raise ValueError(f"packing cannot shrink 4A={4 * A} at "
                         f"K={pack_heavy}")
    a0, nocc, _, _, _ = _sp2_prep(sys, F, False, None, pack_heavy, prepacked)
    mk = static_pack_vec(orbital_mask(sys).to(F.dtype), pack_heavy,
                         a0.shape[-1])
    return a0, nocc, mk


def sp2(sys: System, F: torch.Tensor, eps: float = 1.0e-4,
        tight_bounds: bool = False, pack_n: Optional[int] = None,
        pack_heavy: Optional[int] = None, prepacked: bool = False):
    """SP2 density-matrix purification (cf. SP2.py:3-72).

    Returns P in the caller's layout: (nmol, 4A, 4A), or packed at
    packed_solver_size(pack_heavy, A) when ``prepacked``.  Float32 at
    n <= 128 runs the purifier kernel's semantics (eps floored at 1e-5);
    otherwise the JAX package's XLA-path loop (eps floored at 3e-4 in
    float32, clamped to [1e-7, 1e-3] in float64), with every product in
    full float32 (TF32 off; the JAX package's ``precision``, ``dots``,
    ``sort_packing`` and ``panel_out`` are TPU knobs and not ported).
    ``tight_bounds`` refines the Gershgorin bounds by Gelfand squaring.
    """
    with span("density"):
        count("molecules", F.shape[0])
        f32 = F.dtype == torch.float32
        a0, noccd, mout, unpack, kernel = _sp2_prep(
            sys, F, tight_bounds, pack_n, pack_heavy, prepacked)
        if kernel and tracing():
            # the kernel's own per-molecule iteration counts
            P, iters = sp2_purify(a0, noccd, max(eps, 1.0e-5),
                                  return_iters=True)
            count("sp2_iterations", iters)
        elif kernel:
            P = sp2_purify(a0, noccd, max(eps, 1.0e-5))
        else:
            eps = max(eps, 3.0e-4) if f32 else min(max(eps, 1.0e-7), 1.0e-3)
            P = _sp2_loop(a0, noccd, eps, f32)
        return unpack(P) * (mout[:, :, None] * mout[:, None, :])


def _subset_system(sys: System, idx: torch.Tensor) -> System:
    """A molecule subset of a System (the static pair lists shared)."""
    return dataclasses.replace(
        sys, species=sys.species[idx], coordinates=sys.coordinates[idx],
        charges=sys.charges[idx], atom_mask=sys.atom_mask[idx],
        heavy_mask=sys.heavy_mask[idx], nheavy=sys.nheavy[idx],
        nhydro=sys.nhydro[idx], nocc=sys.nocc[idx], norb=sys.norb[idx],
        zi=sys.zi[idx], zj=sys.zj[idx], pair_mask=sys.pair_mask[idx],
        rij=sys.rij[idx], xij=sys.xij[idx])


def eigh_rescue(sys: System, F: torch.Tensor, P: torch.Tensor,
                frac: float = 1.0 / 64.0,
                ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Re-purify the worst SP2 molecules with the exact eigh path.

    SP2's trace criterion leaves a small tail of molecules (near-degenerate
    HOMO-LUMO) with a rotated or wrong-occupation subspace.  Scored by
    ||P - ref||^2 against a reference density that tracks the physical
    state (XL-BOMD's propagated field), which also sees occupation flips,
    or else by the commutator ||[F, P]||^2; the top ceil(frac * nmol)
    molecules are re-solved by sym_eig with degeneracy-aware occupations
    (F, P (nmol, 4A, 4A))."""
    nmol = F.shape[0]
    k = max(1, int(round(nmol * frac)))
    if k >= nmol:
        return sym_eig(sys, F, check_degeneracy=True)[1]
    if ref is not None:
        score = ((P - ref) ** 2).sum(dim=(-2, -1))
    else:
        G = F @ P
        score = ((G - G.transpose(-1, -2)) ** 2).sum(dim=(-2, -1))
    idx = torch.topk(score, k).indices
    Psub = sym_eig(_subset_system(sys, idx), F[idx],
                   check_degeneracy=True)[1]
    return P.index_put((idx,), Psub)
