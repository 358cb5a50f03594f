"""Fused two-electron apply kernel K3 (CUDA, sm_90a), forward and backward,
and its plain PyTorch version.

Replaces the TPU kernels ``tools/wapply_pallas.py::_fwd_kernel`` and
``::_bwd_kernel`` (entered through the ``w_apply_fused`` custom_vjp).  On
every cell of a Fock build (one atom pair: local integrals ri (..., 22),
frame U (..., 4, 4), density block X (..., 4, 4)) it computes

    y = U . T_perm(ri)[U^T X U] . U^T

the two-electron tensor w = (U x U) T(ri) (U x U)^T applied to X without
materializing w, ``perm`` choosing which orbital pairs are free and which
are contracted: (1, 2, 3, 4) Coulomb on atom i, (3, 4, 1, 2) Coulomb on
atom j, (1, 3, 2, 4) exchange.  Its backward gives the three cotangents
in one pass (see the note at the top of ``csrc/wapply.cu``):

    dX = U . T_perm*(ri)[U^T Yb U] . U^T       (T_perm*: perm with its free
                                                and contracted pairs swapped)
    dri[r] = <U^T Yb U, T_r[U^T X U]>
    dU = Yb U B^T + Yb^T U B + X U C^T + X^T U C   (3 x 3 block)

with B = T_perm(ri)[U^T X U] and C = T_perm*(ri)[U^T Yb U].

The kernel assumes what ``tetci.frame_matrix`` builds: row 0 of U is e_0
and column 0 of rows 1-3 is 0 (tests/test_torch_wapply.py checks every
frame that reaches the apply).  It reads only U[1:4, 1:4] and returns dU
on that block, zeros elsewhere.

What bounds it on an H100, and what the design does about it: see
``csrc/wapply.cu`` (device-memory bound; tiles of consecutive cells
brought into shared memory by bulk asynchronous copies, one thread per
cell, the 72-entry contraction unrolled per perm with every per-cell
array in registers).  The kernels are instantiated for the three perms
the package uses (``PERM_IDS``); another perm on a CUDA tensor raises.

``w_apply`` launches the kernels for CUDA tensors, through ``WApply`` (an
autograd.Function whose backward is the K3 backward kernel) and raises if
the build or a launch fails; for CPU tensors it runs
``w_apply_reference``, the contraction as small matrix products, whose
derivatives are autograd through it.  Both kernels build at first use with
nvcc into ``_build/`` next to this package (``ops/cuda_build.py``).

Second derivatives (Hessians through a Fock build): under
``create_graph`` ``WApply.backward`` returns its cotangents through
``WApplyBwd``, whose forward is the K3 backward kernel (the first-order
values stay the kernel's) and whose backward gives the second-order terms.
The map X -> y is linear and its adjoint is the same contraction at the
adjoint perm (``adjoint_perm``), and y is linear in ri; so the terms in
the X and Yb directions are K3 forwards, and only the terms through U (the
ri-U, X-U, Yb-U and U-U cross terms) are plain torch on the 4x4 cells,
as the JAX package's plain ``_w_apply`` gets all of them from XLA.  A
third derivative raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import cuda_build

SOURCE = "wapply"
# the perms the kernels are instantiated for, by their C perm id:
# Coulomb on atom i, Coulomb on atom j, exchange (ops/tetci.py)
PERM_IDS = {(1, 2, 3, 4): 0, (3, 4, 1, 2): 1, (1, 3, 2, 4): 2}
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_void_p]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# launches of the forward and backward kernels (plain integers; reset by
# callers that count)
launches_fwd = 0
launches_bwd = 0


def _load(kind: str, dtype):
    """The typed C entry point wapply_<kind>_<f32|f64> (built if needed)."""
    fn = f"wapply_{kind}_{_SUFFIX[dtype]}"
    return getattr(cuda_build.load(
        SOURCE, fn, _FWD_ARGTYPES if kind == "fwd" else _BWD_ARGTYPES), fn)


def _load_all():
    """Build the library and type all four entry points."""
    for kind in ("fwd", "bwd"):
        for dtype in _SUFFIX:
            _load(kind, dtype)


@functools.lru_cache(maxsize=None)
def _expansion(perm: Tuple[int, int, int, int]) -> np.ndarray:
    """T (22, 4, 4, 4, 4) permuted to (r, free1, free2, con1, con2)."""
    from .tetci import _ri_expansion_table
    return _ri_expansion_table().transpose((0,) + tuple(perm))


@functools.lru_cache(maxsize=None)
def _t_contract(perm, dtype, device) -> torch.Tensor:
    """(16, 22*16) matrix C with y[f] = sum_r ri[r] (Xloc @ C)[r, f]: T_perm
    laid out as (con1*4+con2, r*16 + free1*4+free2).  Cached per device,
    so the host-to-device copy happens once."""
    T = _expansion(tuple(perm)).reshape(22, 16, 16)
    C = np.ascontiguousarray(T.transpose(2, 0, 1).reshape(16, 22 * 16))
    return torch.as_tensor(C, dtype=dtype, device=device)


def w_apply_reference(ri, U, X, perm):
    """Plain-torch K3: rotate X into the local frame (U^T X U), contract
    with T_perm and the 22 integrals as matrix products with the
    (16, 352) constant, rotate back (U y U^T).  Any device; broadcasts."""
    Xloc = U.transpose(-1, -2) @ X @ U
    batch = torch.broadcast_shapes(Xloc.shape[:-2], ri.shape[:-1])
    C = _t_contract(tuple(perm), X.dtype, X.device)
    Z = (Xloc.reshape(Xloc.shape[:-2] + (1, 16)) @ C)    # (..., 1, 352)
    Z = Z.reshape(Z.shape[:-2] + (22, 16))
    y = (ri[..., None, :] @ Z).reshape(batch + (4, 4))
    return U @ y @ U.transpose(-1, -2)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _perm_id(perm) -> int:
    """The kernels' id of ``perm``; raises for a perm they are not
    instantiated for."""
    pid = PERM_IDS.get(tuple(perm))
    if pid is None:
        raise ValueError(f"the K3 kernels take the perms "
                         f"{list(PERM_IDS)}, not {tuple(perm)}")
    return pid


def _launch_fwd(ri, U, X, perm):
    global launches_fwd
    pid = _perm_id(perm)
    fn = _load("fwd", ri.dtype)
    C = ri.shape[0]
    y = torch.empty_like(X)
    with torch.cuda.device(ri.device):
        rc = fn(ri.data_ptr(), U.data_ptr(), X.data_ptr(), y.data_ptr(),
                pid, C, _stream(ri.device))
    if rc != 0:
        raise RuntimeError(f"wapply forward kernel launch failed: CUDA "
                           f"error {rc}")
    launches_fwd += 1
    return y


def _launch_bwd(ri, U, X, Yb, perm, need):
    global launches_bwd
    pid = _perm_id(perm)
    fn = _load("bwd", ri.dtype)
    C = ri.shape[0]
    dri = torch.empty_like(ri) if need[0] else None
    dU = torch.empty_like(U) if need[1] else None
    dX = torch.empty_like(X) if need[2] else None
    with torch.cuda.device(ri.device):
        rc = fn(ri.data_ptr(), U.data_ptr(), X.data_ptr(), Yb.data_ptr(),
                _ptr(dri), _ptr(dU), _ptr(dX), pid, C, _stream(ri.device))
    if rc != 0:
        raise RuntimeError(f"wapply backward kernel launch failed: CUDA "
                           f"error {rc}")
    launches_bwd += 1
    return dri, dU, dX


# the kernels' view of U: row 0 is e_0 and column 0 of rows 1-3 is 0
# (frame_matrix's structure); only the 3x3 block is read
_BLOCK = np.zeros((4, 4))
_BLOCK[1:, 1:] = 1.0
_E00 = np.zeros((4, 4))
_E00[0, 0] = 1.0


def adjoint_perm(perm):
    """The perm of the adjoint contraction: free and contracted pairs
    swapped, (1, 2, 3, 4) <-> (3, 4, 1, 2); (1, 3, 2, 4) is its own
    adjoint, since w[ab, cd] is symmetric in a <-> b and c <-> d."""
    p = tuple(perm)
    if p == (1, 3, 2, 4):
        return p
    return (p[2], p[3], p[0], p[1])


def _frame(U):
    """U as the kernels read it: its 3x3 block inside the fixed frame."""
    blk = torch.as_tensor(_BLOCK, dtype=U.dtype, device=U.device)
    e00 = torch.as_tensor(_E00, dtype=U.dtype, device=U.device)
    return U * blk + e00


def _t_terms(Zl, perm):
    """(..., 22, 4, 4): T_r[Zl] for every integral r."""
    C = _t_contract(tuple(perm), Zl.dtype, Zl.device)
    return (Zl.reshape(Zl.shape[:-2] + (16,)) @ C).reshape(
        Zl.shape[:-2] + (22, 4, 4))


def _bwd_plain(ri, V, X, Yb, perm):
    """The K3 backward's formulas (module docstring) on the framed V:
    (dri, dU on the 3x3 block, dX)."""
    Vt = V.transpose(-1, -2)
    Xl, Yl = Vt @ X @ V, Vt @ Yb @ V
    TX = _t_terms(Xl, perm)
    dri = (TX * Yl[..., None, :, :]).sum(dim=(-1, -2))
    B = torch.einsum('...r,...rij->...ij', ri, TX)
    Cl = torch.einsum('...r,...rij->...ij', ri,
                      _t_terms(Yl, adjoint_perm(perm)))
    dU = (Yb @ V @ B.transpose(-1, -2) + Yb.transpose(-1, -2) @ V @ B
          + X @ V @ Cl.transpose(-1, -2) + X.transpose(-1, -2) @ V @ Cl)
    blk = torch.as_tensor(_BLOCK, dtype=V.dtype, device=V.device)
    return dri, dU * blk, V @ Cl @ Vt


def _fwd(ri, U, X, perm):
    """K3 forward on cells: the kernel for CUDA tensors, its plain version
    (on the framed U) for CPU tensors."""
    if ri.device.type == "cpu":
        return w_apply_reference(ri, _frame(U), X, perm)
    return _launch_fwd(ri.contiguous(), U.contiguous(), X.contiguous(), perm)


def _bwd(ri, U, X, Yb, perm, need=(True, True, True)):
    """K3 backward on cells, (dri, dU, dX) with None where ``need`` is
    false: the kernel for CUDA tensors, its plain version for CPU
    tensors."""
    if ri.device.type == "cpu":
        out = _bwd_plain(ri, _frame(U), X, Yb, perm)
        return tuple(o if n else None for o, n in zip(out, need))
    return _launch_bwd(ri, U, X, Yb.contiguous(), perm, need)


class WApply(torch.autograd.Function):
    """y = K3(ri, U, X) on cells (C, 22), (C, 4, 4), (C, 4, 4) of one
    device and type; the backward is the K3 backward kernel, returning
    only the cotangents asked for, and under create_graph the same kernel
    through ``WApplyBwd``, which carries the second derivative.  On CPU
    tensors both run their plain versions (the tests' route)."""

    @staticmethod
    def forward(ctx, ri, U, X, perm):
        ri, U, X = ri.contiguous(), U.contiguous(), X.contiguous()
        ctx.perm = perm
        ctx.save_for_backward(ri, U, X)
        return _fwd(ri, U, X, perm)

    @staticmethod
    def backward(ctx, yb):
        ri, U, X = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        if not any(need):
            return None, None, None, None
        if torch.is_grad_enabled():
            grads = WApplyBwd.apply(ri, U, X, yb.contiguous(), ctx.perm)
            return tuple(g if n else None for g, n in zip(grads, need)) + (
                None,)
        dri, dU, dX = _bwd(ri, U, X, yb, ctx.perm, need)
        return dri, dU, dX, None


class WApplyBwd(torch.autograd.Function):
    """(dri, dU, dX) = the K3 backward at (ri, U, X, Yb): one launch of the
    backward kernel.  Its backward, given the cotangents (a, W, Cx) of
    (dri, dU, dX), is the derivative of L = <Yb, y(ri, U, X)> along
    (a, W, Cx) differentiated once more:

        Yb: y(a, U, X) + y(ri, U, Cx) + D_U y[W]
        X:  y*(a, U, Yb) + d<W, dU>/dX
        ri: dri(U, Cx, Yb) + d<W, dU>/dri
        U:  dU(a, U, X, Yb) + dU(ri, U, Cx, Yb) + d<W, dU>/dU

    (y* the apply at the adjoint perm).  The three applies are K3
    forwards; the rest is autograd of the backward's plain formulas."""

    @staticmethod
    def forward(ctx, ri, U, X, Yb, perm):
        ctx.perm = perm
        ctx.save_for_backward(ri, U, X, Yb)
        return _bwd(ri, U, X, Yb, perm)

    @staticmethod
    @once_differentiable
    def backward(ctx, a, W, Cx):
        ri, U, X, Yb = ctx.saved_tensors
        perm = ctx.perm
        with torch.enable_grad():
            ri_, U_, X_, Yb_ = (t.detach().requires_grad_(True)
                                for t in (ri, U, X, Yb))
            V = _frame(U_)
            terms = []
            if W is not None:
                terms.append((W * _bwd_plain(ri_, V, X_, Yb_, perm)[1]).sum())
            Ybc = Yb_.detach()
            if a is not None:
                terms.append((Ybc * w_apply_reference(
                    a, V, X_.detach(), perm)).sum())
            if Cx is not None:
                terms.append((Ybc * w_apply_reference(ri_, V, Cx,
                                                      perm)).sum())
            d_ri, d_U, d_X, d_Yb = (
                g if g is not None else torch.zeros_like(t)
                for g, t in zip(torch.autograd.grad(
                    sum(terms), (ri_, U_, X_, Yb_), allow_unused=True),
                    (ri, U, X, Yb)))
        if a is not None:
            a = a.contiguous()
            d_X = d_X + _fwd(a, U, Yb, adjoint_perm(perm))
            d_Yb = d_Yb + _fwd(a, U, X, perm)
        if Cx is not None:
            d_Yb = d_Yb + _fwd(ri, U, Cx.contiguous(), perm)
        return d_ri, d_U, d_X, d_Yb, None


def w_apply(ri: torch.Tensor, U: torch.Tensor, X: torch.Tensor, perm):
    """y = U . T_perm(ri)[U^T X U] . U^T over broadcast leading dimensions:
    ri (..., 22), U (..., 4, 4), X (..., 4, 4).  K3 for CUDA tensors (the
    operands expanded to the common cells and made contiguous; X may be an
    expanded view, and its cotangent is reduced back by autograd), the
    plain version for CPU tensors (any perm; the kernels take the three
    of ``PERM_IDS``)."""
    if ri.dtype not in _SUFFIX or U.dtype != ri.dtype or X.dtype != ri.dtype:
        raise TypeError(f"w_apply takes float32 or float64 ri, U, X of one "
                        f"type, got {ri.dtype}, {U.dtype}, {X.dtype}")
    if (ri.shape[-1] != 22 or tuple(U.shape[-2:]) != (4, 4)
            or tuple(X.shape[-2:]) != (4, 4)):
        raise ValueError(f"w_apply takes ri (..., 22), U and X (..., 4, 4), "
                         f"got {tuple(ri.shape)}, {tuple(U.shape)}, "
                         f"{tuple(X.shape)}")
    if not (ri.device == U.device == X.device):
        raise ValueError("ri, U and X must be on one device")
    if X.device.type == "cpu":
        return w_apply_reference(ri, U, X, perm)
    if X.device.type != "cuda":
        raise ValueError(f"w_apply runs on cuda or cpu, not {X.device}")
    batch = torch.broadcast_shapes(ri.shape[:-1], U.shape[:-2], X.shape[:-2])
    cells = int(np.prod(batch)) if batch else 1
    ri = ri.expand(batch + (22,)).reshape(cells, 22)
    U = U.expand(batch + (4, 4)).reshape(cells, 4, 4)
    X = X.expand(batch + (4, 4)).reshape(cells, 4, 4)
    return WApply.apply(ri, U, X, tuple(perm)).reshape(batch + (4, 4))
