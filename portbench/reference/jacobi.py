"""Sweeps that the one-sided Jacobi eigensolver (the port's K2) needs on
given inputs: a plain copy of the kernel's sweep loop (Gershgorin shift,
power-of-two padding, the cyclic xor pairing, per-molecule exit at
OFF_TOL or MAX_SWEEPS), with column sums in one float32 reduction rather
than the kernel's chain of FMAs, so a count can differ by one on a
molecule that sits at the exit threshold.  Used only to count work for
K2's roofline.
"""
from __future__ import annotations

import torch

MAX_SWEEPS = 16
OFF_TOL = 1.0e-12


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def solver_input(Fp: torch.Tensor, mk: torch.Tensor) -> torch.Tensor:
    """The matrix the port's ``sym_eig(prepacked=True)`` hands the solver:
    F masked to the live orbitals, dead rows given distinct diagonal values
    above the spectrum."""
    F = Fp * (mk[:, :, None] * mk[:, None, :])
    d = torch.diagonal(F, dim1=-2, dim2=-1)
    r = F.abs().sum(-1) - d.abs()
    h1, hN = (d - r).amin(-1), (d + r).amax(-1)
    idx = torch.arange(F.shape[-1], device=F.device)
    val = ((1.0 + 0.005 * (idx + 1).to(F.dtype)) * (hN - h1)[:, None]
           + hN[:, None])
    diag = torch.where(mk == 0.0, val, d)
    return F - torch.diag_embed(d) + torch.diag_embed(diag)


def sweeps(A: torch.Tensor) -> torch.Tensor:
    """(B,) int32 sweep counts of the Jacobi solver on A (B, n, n), in
    float32."""
    A = A.float()
    B, n0, _ = A.shape
    s = A.abs().sum(1)
    aii = torch.diagonal(A, dim1=-2, dim2=-1)
    r = s - aii.abs()
    h1, hN = (aii - r).amin(-1), (aii + r).amax(-1)
    sigma = hN + 0.05 * torch.clamp(hN - h1, min=1.0)
    n = _next_pow2(n0)
    G = A.new_zeros((B, n, n))
    eye = torch.eye(n0, dtype=A.dtype, device=A.device)
    G[:, :n0, :n0] = eye[None] * sigma[:, None, None] - A
    rot_tol = OFF_TOL * 0.01
    idx = torch.arange(n, device=A.device)
    off_max = torch.ones((B,), dtype=A.dtype, device=A.device)
    count = torch.zeros((B,), dtype=torch.int32, device=A.device)
    active = torch.ones((B,), dtype=torch.bool, device=A.device)
    while True:
        active = active & (off_max > OFF_TOL) & (count < MAX_SWEEPS)
        if not bool(active.any()):
            return count
        Gs = G
        off = torch.zeros((B, n), dtype=A.dtype, device=A.device)
        for d in range(1, n):
            p = idx ^ d
            Gx = Gs[:, :, p]
            alpha = (Gs * Gs).sum(-2)
            gamma = (Gs * Gx).sum(-2)
            beta = alpha[:, p]
            denom = alpha * beta
            dmax = torch.clamp(denom, min=1.0e-30)
            g2 = gamma * gamma
            off = torch.maximum(off, torch.where(denom > 0.0, g2 / dmax,
                                                 torch.zeros_like(g2)))
            rotate = g2 > rot_tol * dmax
            zeta = (beta - alpha) / (2.0 * torch.where(
                rotate, gamma, torch.ones_like(gamma)))
            t = torch.sign(zeta) / (torch.abs(zeta)
                                    + torch.sqrt(1.0 + zeta * zeta))
            t = torch.where(rotate, t, torch.zeros_like(t))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            Gs = c[:, None, :] * Gs - (t * c)[:, None, :] * Gx
        G = torch.where(active[:, None, None], Gs, G)
        off_max = torch.where(active, off.amax(dim=-1), off_max)
        count = count + active.to(torch.int32)
