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

On CUDA, ``eigh_jacobi`` is one launch: the kernel takes A and does the
shift, the padding, the sweeps, the sort and the normalisation.  Two
variants (see the note at the top of ``csrc/eigh.cu``): for n <= 32 a
warp kernel, one molecule per group of n lanes, columns in registers,
partner columns by ``__shfl_xor_sync``, no shared memory and no block
barrier; for n = 64 and 128 a block kernel, one thread per column, G
double-buffered in shared memory.  Both are FP32-bound and each molecule
leaves on its own.  ``eigh_jacobi`` raises if the build or the launch
fails; for CPU tensors it runs the plain version, which repeats the
kernel's arithmetic step by step: the sequential row sums of the shift,
each molecule's own exit, and the sort as a rank per column.
``MAX_SWEEPS`` and ``OFF_TOL`` are read at call time.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.timing import count, tracing
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

# launches of the CUDA kernel (plain integers; reset by callers that
# count): in all, and by the padded size n (n <= 32 the warp kernel)
launches = 0
launches_by_n: dict = {}


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


def gershgorin_shift(A: torch.Tensor) -> torch.Tensor:
    """sigma (B,) as the kernel forms it: row j's sum of |a_ij| read in
    order i = 0, 1, ... down column j (A is symmetric), one rounding per
    addition; r_j = that sum - |a_jj|; h1 = min(a_jj - r_j), hN =
    max(a_jj + r_j); sigma = hN + 0.05 max(hN - h1, 1)."""
    absA = torch.abs(A)
    s = torch.zeros_like(A[:, 0])
    for i in range(A.shape[1]):
        s = s + absA[:, i]
    aii = torch.diagonal(A, dim1=-2, dim2=-1)
    r = s - torch.abs(aii)
    h1 = (aii - r).amin(dim=-1)
    hN = (aii + r).amax(dim=-1)
    return hN + 0.05 * torch.clamp(hN - h1, min=1.0)


def _shift_and_pad(A: torch.Tensor):
    """(G0, sigma): G0 = sigma I - A on the n0 x n0 block of the power of
    two n, zero on the padding (A's padding diagonal at sigma)."""
    B, n0, _ = A.shape
    sigma = gershgorin_shift(A)
    n = next_pow2(n0)
    G0 = A.new_zeros((B, n, n))
    eye = torch.eye(n0, dtype=A.dtype, device=A.device)
    G0[:, :n0, :n0] = eye[None] * sigma[:, None, None] - A
    return G0, sigma


def sort_rank(e: torch.Tensor) -> torch.Tensor:
    """(B, n) int64: the position of each column once sorted, rank_j =
    #{k : e_k < e_j, or e_k = e_j and k < j}, NaN after everything (the
    order of torch.argsort(stable=True), formed as the kernel forms it)."""
    n = e.shape[-1]
    ek, ej = e[:, :, None], e[:, None, :]          # [b, k, j]
    idx = torch.arange(n, device=e.device)
    k_first = idx[:, None] < idx[None, :]
    nk, nj = torch.isnan(ek), torch.isnan(ej)
    before = torch.where(nk | nj, ~nk | (nj & k_first),
                         (ek < ej) | ((ek == ej) & k_first))
    return before.sum(dim=1)


def _sort(G, nrm, sigma, n0):
    """(e, v) ascending from the final columns, cut back to n0: column j
    goes to position sort_rank(e)_j."""
    e_raw = sigma[:, None] - nrm
    rank = sort_rank(e_raw)
    v_raw = G / torch.clamp(nrm, min=1.0e-20)[:, None, :]
    e = torch.empty_like(e_raw).scatter_(1, rank, e_raw)
    v = torch.empty_like(v_raw).scatter_(
        2, rank[:, None, :].expand_as(v_raw), v_raw)
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


def _launch(A, want_sweeps: bool):
    """The kernel on A: (e, v, resid, sweeps or None), one launch."""
    global launches
    lib = _load()
    B, n0, _ = A.shape
    e = torch.empty((B, n0), dtype=A.dtype, device=A.device)
    v = torch.empty_like(A)
    resid = torch.empty((B,), dtype=A.dtype, device=A.device)
    sweeps = (torch.empty((B,), dtype=torch.int32, device=A.device)
              if want_sweeps else None)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.eigh_jacobi_f32(
            A.data_ptr(), e.data_ptr(), v.data_ptr(), resid.data_ptr(),
            sweeps.data_ptr() if sweeps is not None else None, B, n0,
            float(OFF_TOL), float(OFF_TOL * 0.01), int(MAX_SWEEPS), stream)
    if rc != 0:
        raise RuntimeError(f"eigh kernel launch failed: CUDA error {rc}")
    launches += 1
    n = next_pow2(n0)
    launches_by_n[n] = launches_by_n.get(n, 0) + 1
    return e, v, resid, sweeps


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
    float32 contiguous, n <= 128 after padding to a power of two.  One
    launch of the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.

    ``with_resid`` appends the (B,) convergence residual, the last sweep's
    largest gamma^2 / (alpha beta): > OFF_TOL means that molecule stopped
    at MAX_SWEEPS unconverged.  ``return_sweeps`` appends each molecule's
    sweep count (int32)."""
    _check(A)
    if A.device.type == "cpu":
        return eigh_jacobi_reference(A, with_resid, return_sweeps)
    if A.device.type != "cuda":
        raise ValueError(f"eigh_jacobi runs on cuda or cpu, not {A.device}")
    e, v, resid, sweeps = _launch(A, return_sweeps)
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
        if tracing():
            # the kernel's own per-molecule sweep counts
            e, v, resid, sweeps = eigh_jacobi(A, with_resid=True,
                                              return_sweeps=True)
            count("eigh_sweeps", sweeps)
        else:
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
