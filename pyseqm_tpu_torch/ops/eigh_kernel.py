"""Batched symmetric eigensolver kernel (one-sided Jacobi; CUDA, sm_90a),
its plain PyTorch version and its autograd wrappers.

Replaces the TPU kernel ``pyseqm_tpu/ops/eigh_pallas.py::_eigh_kernel``
(entered through ``eigh_tpu``): for a batch of symmetric A (B, n, n) it
shifts and reflects G0 = sigma I - A with the Gershgorin bound
sigma = hN + 0.05 max(hN - h1, 1), pads n to a power of two (padding
diagonal at sigma, so padding columns have norm 0 and sort last), runs
Hestenes sweeps with the XOR pair order until the largest relative
off-diagonal gamma^2 / (alpha beta) of a sweep is <= OFF_TOL or MAX_SWEEPS
sweeps ran, and reads e = sigma - |g_j| (ascending) and v = g_j / |g_j|.
The lowest eigenvalues of A get the largest column norms, hence the best
relative accuracy, where the density needs it.

What bounds it on an H100, and what the design does about it: see the
note at the top of ``csrc/eigh.cu`` (FP32- and latency-bound at n = 16
and 32; one block per molecule, one thread per column, G double-buffered
in shared memory, per-molecule exit).

The shift, the padding, the sort and the normalisation stay plain torch
around the kernel.  ``eigh_jacobi`` launches the kernel for CUDA tensors
and raises if the build or the launch fails; for CPU tensors it runs the
plain version, which repeats the kernel's arithmetic step by step,
including each molecule's own exit.  ``MAX_SWEEPS`` and ``OFF_TOL`` are
read at call time.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_SWEEPS = 16
# stop when max gamma^2/(alpha beta) over the pairs of a sweep is below
# this (~(1e-6)^2); pairs rotate while gamma^2 > 0.01 OFF_TOL alpha beta
OFF_TOL = 1.0e-12
MAX_N = 128

SOURCE = "eigh"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

# launches of the CUDA kernel (plain integer; reset by callers that count)
launches = 0


def _load():
    return cuda_build.load(SOURCE, "eigh_jacobi_f32", _ARGTYPES)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def supported(n: int, dtype) -> bool:
    """Whether sym_eig runs the Jacobi semantics for this size and type."""
    return dtype == torch.float32 and next_pow2(n) <= MAX_N


def _check(A: torch.Tensor, dtypes=(torch.float32,)):
    if A.dtype not in dtypes:
        raise TypeError(f"eigh_jacobi takes {dtypes[0]} A, got {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (B, n, n), got {tuple(A.shape)}")
    if next_pow2(A.shape[1]) > MAX_N:
        raise ValueError(f"eigh_jacobi supports n <= {MAX_N} after padding "
                         f"to a power of two, got n={A.shape[1]}")
    if not A.is_contiguous():
        raise ValueError("eigh_jacobi needs a contiguous A")


def _shift_and_pad(A: torch.Tensor):
    """(G0, sigma): G0 = sigma I - A padded to a power of two, the padding
    diagonal of A at sigma (so G0's padding block is zero)."""
    B, n0, _ = A.shape
    n = next_pow2(n0)
    aii = torch.diagonal(A, dim1=-2, dim2=-1)
    ri = torch.abs(A).sum(dim=-1) - torch.abs(aii)
    h1 = (aii - ri).min(dim=-1).values
    hN = (aii + ri).max(dim=-1).values
    spread = torch.clamp(hN - h1, min=1.0)
    sigma = hN + 0.05 * spread
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    if n > n0:
        A = torch.nn.functional.pad(A, (0, n - n0, 0, n - n0))
        padd = (torch.arange(n, device=A.device) >= n0).to(A.dtype)
        A = A + eye[None] * (padd[None, :] * sigma[:, None])[:, None, :]
    G0 = eye[None] * sigma[:, None, None] - A
    return G0.contiguous(), sigma


def _sort(G, nrm, sigma, n0):
    """(e, v) ascending from the final columns, cut back to n0."""
    e_raw = sigma[:, None] - nrm
    order = torch.argsort(e_raw, dim=-1, stable=True)
    e = torch.take_along_dim(e_raw, order, dim=-1)
    v = torch.take_along_dim(G / torch.clamp(nrm, min=1.0e-20)[:, None, :],
                             order[:, None, :], dim=-1)
    return e[:, :n0], v[:, :n0, :n0]


def _column_dots(X, Y):
    """sum_i X[:, i, j] Y[:, i, j] as the kernel forms it: a sequential
    chain of fused multiply-adds over i, each rounded once to X's type.
    For float32 each FMA is evaluated in float64 (the product is exact
    there) and rounded to float32, which reproduces the FP32 FMA except
    for double-rounding ties (~2^-29 of operations)."""
    if X.dtype != torch.float32:
        return (X * Y).sum(dim=-2)
    Xd, Yd = X.double(), Y.double()
    acc = torch.zeros_like(Xd[:, 0])
    for i in range(X.shape[1]):
        acc = (Xd[:, i] * Yd[:, i] + acc).float().double()
    return acc.float()


def _sweeps_reference(G0, off_tol: float, max_sweeps: int):
    """The kernel's sweeps in plain torch: (G, column norms, resid,
    sweeps).  Every molecule runs until its own exit; a molecule that has
    left keeps its columns (masked commit per sweep)."""
    rot_tol = off_tol * 0.01
    B, n, _ = G0.shape
    idx = torch.arange(n, device=G0.device)
    G = G0
    off_max = torch.ones((B,), dtype=G0.dtype, device=G0.device)
    sweeps = torch.zeros((B,), dtype=torch.int32, device=G0.device)
    active = torch.ones((B,), dtype=torch.bool, device=G0.device)
    while True:
        active = active & (off_max > off_tol) & (sweeps < max_sweeps)
        if not bool(active.any()):
            break
        Gs = G
        off = torch.zeros((B, n), dtype=G0.dtype, device=G0.device)
        for d in range(1, n):
            p = idx ^ d
            Gx = Gs[:, :, p]
            alpha = _column_dots(Gs, Gs)
            gamma = _column_dots(Gs, Gx)
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
            s = t * c
            Gs = c[:, None, :] * Gs - s[:, None, :] * Gx
        G = torch.where(active[:, None, None], Gs, G)
        off_max = torch.where(active, off.amax(dim=-1), off_max)
        sweeps = sweeps + active.to(torch.int32)
    nrm = torch.sqrt(_column_dots(G, G))
    return G, nrm, off_max, sweeps


def _sweeps_kernel(G0, off_tol: float, max_sweeps: int, want_sweeps: bool):
    global launches
    lib = _load()
    B, n, _ = G0.shape
    G = torch.empty_like(G0)
    nrm = torch.empty((B, n), dtype=G0.dtype, device=G0.device)
    resid = torch.empty((B,), dtype=G0.dtype, device=G0.device)
    sweeps = (torch.empty((B,), dtype=torch.int32, device=G0.device)
              if want_sweeps else None)
    with torch.cuda.device(G0.device):
        stream = torch.cuda.current_stream(G0.device).cuda_stream
        rc = lib.eigh_jacobi_f32(
            G0.data_ptr(), G.data_ptr(), nrm.data_ptr(), resid.data_ptr(),
            sweeps.data_ptr() if sweeps is not None else None, B, n,
            float(off_tol), float(off_tol * 0.01), int(max_sweeps), stream)
    if rc != 0:
        raise RuntimeError(f"eigh kernel launch failed: CUDA error {rc}")
    launches += 1
    return G, nrm, resid, sweeps


def _outputs(e, v, resid, sweeps, with_resid, return_sweeps):
    out = (e, v)
    if with_resid:
        out += (resid,)
    if return_sweeps:
        out += (sweeps,)
    return out


def eigh_jacobi_reference(A: torch.Tensor, with_resid: bool = False,
                          return_sweeps: bool = False):
    """Plain-torch version of ``eigh_jacobi``, step by step (any device;
    float32, or float64 for checks of the surrounding algebra)."""
    _check(A, (torch.float32, torch.float64))
    G0, sigma = _shift_and_pad(A)
    G, nrm, resid, sweeps = _sweeps_reference(G0, OFF_TOL, MAX_SWEEPS)
    e, v = _sort(G, nrm, sigma, A.shape[-1])
    return _outputs(e, v, resid, sweeps, with_resid, return_sweeps)


def eigh_jacobi(A: torch.Tensor, with_resid: bool = False,
                return_sweeps: bool = False):
    """Batched eigendecomposition, ascending: (e (B, n), v (B, n, n)) with
    A v_j = e_j v_j, as torch.linalg.eigh lays them out.  A (B, n, n)
    float32 contiguous, n <= 128 after padding to a power of two.  The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    ``with_resid`` appends the (B,) convergence residual, the last sweep's
    largest gamma^2 / (alpha beta): > OFF_TOL means that molecule stopped
    at MAX_SWEEPS unconverged.  ``return_sweeps`` appends each molecule's
    sweep count (int32)."""
    _check(A)
    if A.device.type == "cpu":
        return eigh_jacobi_reference(A, with_resid, return_sweeps)
    if A.device.type != "cuda":
        raise ValueError(f"eigh_jacobi runs on cuda or cpu, not {A.device}")
    G0, sigma = _shift_and_pad(A)
    G, nrm, resid, sweeps = _sweeps_kernel(G0, OFF_TOL, MAX_SWEEPS,
                                           return_sweeps)
    e, v = _sort(G, nrm, sigma, A.shape[-1])
    return _outputs(e, v, resid, sweeps, with_resid, return_sweeps)


def perturbation_vjp(e, v, e_bar, v_bar):
    """Transpose of the first-order eigh perturbation JVP
    (``eigh_pallas._perturbation_jvp``): with F_ij = 1/(e_j - e_i) off the
    diagonal (0 where |e_j - e_i| <= 1e-20), M_bar = diag(e_bar) +
    F * (V^T v_bar) and A_bar = sym(V M_bar V^T)."""
    n = e.shape[-1]
    diff = e[:, None, :] - e[:, :, None]            # e_j - e_i at (i, j)
    big = torch.abs(diff) > 1.0e-20
    offd = ~torch.eye(n, dtype=torch.bool, device=e.device)
    F = torch.where(offd & big,
                    1.0 / torch.where(big, diff, torch.ones_like(diff)),
                    torch.zeros_like(diff))
    Mbar = torch.diag_embed(e_bar) + F * (v.transpose(-1, -2) @ v_bar)
    X = v @ Mbar @ v.transpose(-1, -2)
    return 0.5 * (X + X.transpose(-1, -2))


class JacobiEigh(torch.autograd.Function):
    """(e, v, resid) = eigh_jacobi(A, with_resid=True), differentiable in A
    through the perturbation formulas on the outputs (the rule
    torch.linalg.eigh uses too, 1/(e_j - e_i) sensitivity included);
    resid carries no gradient."""

    @staticmethod
    def forward(ctx, A):
        e, v, resid = eigh_jacobi(A, with_resid=True)
        ctx.save_for_backward(e, v)
        ctx.mark_non_differentiable(resid)
        return e, v, resid

    @staticmethod
    def backward(ctx, e_bar, v_bar, _resid_bar):
        e, v = ctx.saved_tensors
        return perturbation_vjp(e, v, e_bar, v_bar)


def eigh_batched_checked(A: torch.Tensor):
    """Differentiable batched eigh backed by the Jacobi kernel, with the
    per-molecule residual: (e, v, resid).  resid > OFF_TOL flags a
    molecule whose sweeps stopped at MAX_SWEEPS unconverged; callers
    rescue it (ops/density.py)."""
    return JacobiEigh.apply(A)
