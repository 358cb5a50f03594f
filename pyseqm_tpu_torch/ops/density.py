"""Density matrices by SP2 purification in the static packed layout.

PyTorch counterpart of the packed part of ``pyseqm_tpu/ops/density.py``
(cf. the reference SP2.py and pack.py): the static compact-orbital packing
helpers and ``sp2`` on its ``pack_heavy`` / ``prepacked`` routes.

The algorithm is chosen by dtype and size, as the JAX package chooses it
on its production backend: float32 at packed n <= 128 runs the purifier
kernel's semantics (ops/sp2_kernel.py: the hand-written CUDA kernel on a
card, its plain version on the CPU); float64 or n > 128 runs the loop of
the JAX package's XLA path in plain torch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as nnf

from ..system import System
from .sp2_kernel import MAX_N, sp2_purify

SP2_MAX_ITER = 200


def orbital_mask(sys: System) -> torch.Tensor:
    """(nmol, 4A) bool: which orbital rows are physical."""
    per_atom = torch.stack(
        [sys.atom_mask, sys.heavy_mask, sys.heavy_mask, sys.heavy_mask],
        dim=-1)  # (nmol, A, 4)
    return per_atom.reshape(sys.species.shape[0], -1)


def _gershgorin(Xp):
    aii = torch.diagonal(Xp, dim1=-2, dim2=-1)
    ri = torch.abs(Xp).sum(dim=-1) - torch.abs(aii)
    h1 = (aii - ri).min(dim=-1).values
    hN = (aii + ri).max(dim=-1).values
    return h1, hN


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
    return 2.0 * a0


def sp2_input(sys: System, F: torch.Tensor, pack_heavy: int,
              prepacked: bool = False):
    """(a0, nocc, mk): the pre-scaled SP2 iterate a0 = (hN I - F)/(hN - h1)
    in the static packed layout, the occupied counts, and the packed
    orbital mask.  Padding orbitals are pinned at occupation zero by
    setting their diagonal to the Gershgorin upper bound hN."""
    dtype = F.dtype
    A = sys.species.shape[1]
    K = pack_heavy
    n_st = packed_solver_size(K, A)
    if n_st is None:
        raise NotImplementedError(f"packing cannot shrink 4A={4 * A} at "
                                  f"K={K}; the unpacked sp2 is not ported")
    if prepacked and F.shape[-1] != n_st:
        raise ValueError(f"prepacked F has n={F.shape[-1]}, expected "
                         f"packed_solver_size={n_st}")
    m = orbital_mask(sys).to(dtype)
    mk = static_pack_vec(m, K, n_st)
    Fm = (F * (mk[:, :, None] * mk[:, None, :]) if prepacked else
          static_pack_mat(F * (m[:, :, None] * m[:, None, :]), K, n_st))
    n = Fm.shape[-1]
    h1, hN = _gershgorin(Fm)
    # padding diagonal at hN -> scaled eigenvalue 0 -> occupation 0
    Fp = Fm + torch.diag_embed((1.0 - mk) * hN[:, None])
    eye = torch.eye(n, dtype=dtype, device=F.device)
    a0 = (eye * hN[:, None, None] - Fp) / (hN - h1)[:, None, None]
    return a0.contiguous(), sys.nocc.to(dtype), mk


def sp2(sys: System, F: torch.Tensor, eps: float = 1.0e-4,
        pack_heavy: Optional[int] = None, prepacked: bool = False):
    """SP2 density-matrix purification (cf. SP2.py:3-72) on the static
    packed layout.

    ``prepacked``: F is already packed at packed_solver_size(pack_heavy, A)
    and the returned P stays packed; otherwise F is (nmol, 4A, 4A) and P
    comes back in that layout.
    """
    if pack_heavy is None:
        raise NotImplementedError(
            "sp2 without pack_heavy (orbital permutation / pack_n routes) "
            "is not ported yet")
    f32 = F.dtype == torch.float32
    a0, noccd, mk = sp2_input(sys, F, pack_heavy, prepacked)
    if f32 and a0.shape[-1] <= MAX_N:
        # the purifier kernel's semantics (eps floored at 1e-5)
        Pp = sp2_purify(a0, noccd, max(eps, 1.0e-5))
    else:
        eps = max(eps, 3.0e-4) if f32 else min(max(eps, 1.0e-7), 1.0e-3)
        Pp = _sp2_loop(a0, noccd, eps, f32)
    Pp = Pp * (mk[:, :, None] * mk[:, None, :])
    if Pp.shape[-1] != F.shape[-1]:
        Pp = static_unpack_mat(Pp, pack_heavy, sys.species.shape[1])
    return Pp
