"""SP2 purification kernel (CUDA, sm_90a) and its plain PyTorch version.

Replaces the TPU kernel ``pyseqm_tpu/ops/sp2_pallas.py::_sp2_kernel``
(entered through ``sp2_purify_tpu``): P = 2 * purify(a0) for a batch of
pre-scaled iterates a0 = (hN I - F) / (hN - h1).  Each iteration takes X^2
or 2X - X^2, whichever trace lands nearer nocc; a molecule stops when
e0 < eps and not e0 < e2 (eps floored at 1e-5); then one McWeeny step
3X^2 - 2X^3 runs and the result is 2X.

What bounds it on an H100, and what the design does about it: see the note
at the top of ``csrc/sp2.cu`` (FP32-FMA bound at the packed size n = 16).
Two variants, one launch per call: for n <= 32 a warp kernel, one molecule
per 16-lane half-warp (n <= 16) or per warp (n <= 32), lane j holding
column j of X in registers, the row operands of X^2 broadcast from the
group's own slice of shared memory, tr(X^2) a shuffle reduction, only
``__syncwarp``; for 32 < n <= 128 a block kernel, one block per molecule,
X and X^2 in shared memory.  Both leave each molecule's loop on its own
exit test.  The kernel sums in another order than the plain version, so
the two agree to tolerance (5e-5 on the card), not bit for bit.

The kernel builds at first use with nvcc into ``_build/`` next to this
package and is loaded with ctypes (``ops/cuda_build.py``).  ``sp2_purify``
launches it for CUDA tensors and raises if the build or the launch fails;
for CPU tensors it runs ``sp2_purify_reference``, which repeats the
kernel's algorithm step by step.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_ITER = 100
MAX_N = 128
EPS_FLOOR = 1.0e-5

SOURCE = "sp2"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_void_p]

# launches of the CUDA kernel (plain integer; reset by callers that count)
launches = 0


def _load():
    return cuda_build.load(SOURCE, "sp2_purify_f32", _ARGTYPES)


def _check(a0: torch.Tensor, nocc: torch.Tensor):
    if a0.dtype != torch.float32 or nocc.dtype != torch.float32:
        raise TypeError("sp2_purify takes float32 a0 and nocc, got "
                        f"{a0.dtype} and {nocc.dtype}")
    if a0.dim() != 3 or a0.shape[1] != a0.shape[2]:
        raise ValueError(f"a0 must be (B, n, n), got {tuple(a0.shape)}")
    B, n, _ = a0.shape
    if n > MAX_N:
        raise ValueError(f"sp2_purify supports n <= {MAX_N}, got n={n}")
    if nocc.shape != (B,):
        raise ValueError(f"nocc must be ({B},), got {tuple(nocc.shape)}")
    if nocc.device != a0.device:
        raise ValueError("a0 and nocc must be on the same device")
    if not (a0.is_contiguous() and nocc.is_contiguous()):
        raise ValueError("sp2_purify needs contiguous a0 and nocc")


def sp2_purify_reference(a0: torch.Tensor, nocc: torch.Tensor,
                         eps: float = 1.0e-4, return_iters: bool = False):
    """Plain-torch version of the kernel, step by step (any device)."""
    eps = float(max(eps, EPS_FLOOR))
    X = a0
    tr = torch.diagonal(X, dim1=-2, dim2=-1).sum(dim=-1)
    e0 = torch.abs(tr - nocc)
    e1, e2 = e0, e0
    notconv = torch.ones_like(nocc)
    iters = torch.zeros(nocc.shape, dtype=torch.int32, device=nocc.device)
    for _ in range(MAX_ITER):
        if not bool((notconv > 0.0).any()):
            break
        X2 = X @ X
        tr2 = (X * X).sum(dim=(-2, -1))
        take = (torch.abs(tr2 - nocc)
                < torch.abs(2.0 * tr - tr2 - nocc)).to(X.dtype)
        s = notconv * (2.0 * take - 1.0)
        X = X + s[:, None, None] * (X2 - X)
        tr_new = take * tr2 + (1.0 - take) * (2.0 * tr - tr2)
        tr = tr + notconv * (tr_new - tr)
        e0n = e0 + notconv * (torch.abs(tr - nocc) - e0)
        e1n = e1 + notconv * (e0 - e1)
        e2n = e2 + notconv * (e1 - e2)
        e0, e1, e2 = e0n, e1n, e2n
        iters = iters + (notconv > 0.0).to(torch.int32)
        lt_eps = (e0 < eps).to(X.dtype)
        lt_e2 = (e0 < e2).to(X.dtype)
        notconv = notconv * (1.0 - lt_eps * (1.0 - lt_e2))
    X2 = X @ X
    P = 2.0 * (3.0 * X2 - 2.0 * (X @ X2))
    return (P, iters) if return_iters else P


def sp2_purify(a0: torch.Tensor, nocc: torch.Tensor, eps: float = 1.0e-4,
               return_iters: bool = False):
    """P = 2 * purify(a0): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  a0 (B, n, n) float32, n <= 128; nocc (B,)
    float32.  ``return_iters`` also returns each molecule's iteration
    count (int32)."""
    _check(a0, nocc)
    if a0.device.type == "cpu":
        return sp2_purify_reference(a0, nocc, eps, return_iters)
    if a0.device.type != "cuda":
        raise ValueError(f"sp2_purify runs on cuda or cpu, not {a0.device}")
    global launches
    lib = _load()
    B, n, _ = a0.shape
    out = torch.empty_like(a0)
    iters = (torch.empty((B,), dtype=torch.int32, device=a0.device)
             if return_iters else None)
    with torch.cuda.device(a0.device):
        stream = torch.cuda.current_stream(a0.device).cuda_stream
        rc = lib.sp2_purify_f32(
            a0.data_ptr(), nocc.data_ptr(), out.data_ptr(),
            iters.data_ptr() if iters is not None else None,
            B, n, float(max(eps, EPS_FLOOR)), MAX_ITER, stream)
    if rc != 0:
        raise RuntimeError(f"sp2 kernel launch failed: CUDA error {rc}")
    launches += 1
    return (out, iters) if return_iters else out
