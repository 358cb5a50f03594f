"""Compensated (two-float) summation for float32 energy assembly.

PyTorch counterpart of ``pyseqm_tpu/ops/xsum.py``.  The heat of formation
is a ~2 eV difference of ~1000 eV quantities, so every large accumulation is
carried as an unevaluated (hi, lo) float32 pair:

* `two_sum` — Knuth's error-free transformation: hi + lo == a + b exactly.
* `two_prod` — Dekker's error-free product.
* `csum` — pairwise tree of two_sums, f64-quality sums in f32 ops.
* `TwoFloat` arithmetic for combining terms so cancellation happens between
  compensated pairs, not rounded scalars.

The error-free transforms rely on every operation rounding on its own:
eager PyTorch runs each op as its own kernel, so nothing contracts
``c - (c - a)`` into an FMA.  Keep them out of fused code.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class TwoFloat(NamedTuple):
    """Unevaluated hi + lo sum; |lo| <= ulp(hi)/2.

    Supports +, -, *, / against TwoFloat, tensors and Python scalars.
    """
    hi: torch.Tensor
    lo: torch.Tensor

    def value(self):
        return self.hi + self.lo

    def __add__(self, other):
        return tf_add(self, _as_tf(other, self.hi))

    __radd__ = __add__

    def __sub__(self, other):
        return tf_add(self, tf_neg(_as_tf(other, self.hi)))

    def __rsub__(self, other):
        return tf_add(_as_tf(other, self.hi), tf_neg(self))

    def __neg__(self):
        return tf_neg(self)

    def __mul__(self, other):
        return tf_mul(self, _as_tf(other, self.hi))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return tf_mul(self, tf_recip(_as_tf(other, self.hi)))

    def __rtruediv__(self, other):
        return tf_mul(_as_tf(other, self.hi), tf_recip(self))


def _as_tf(x, like: torch.Tensor) -> TwoFloat:
    if isinstance(x, TwoFloat):
        return x
    # pin scalars to the partner's dtype so a Python literal rounds once
    # (torch.full: a device fill, never a host-to-device copy)
    if not torch.is_tensor(x):
        x = torch.full((), x, dtype=like.dtype, device=like.device)
    return TwoFloat(x, torch.zeros((), dtype=x.dtype, device=x.device))


def tf_const(v: float, like: torch.Tensor) -> TwoFloat:
    """Two-float constant in ``like``'s dtype: hi = round(v), lo = round(v - hi)."""
    npdt = np.float32 if like.dtype == torch.float32 else np.float64
    hi = npdt(v)
    lo = npdt(v - float(hi))
    mk = lambda a: torch.full((), float(a), dtype=like.dtype,  # noqa: E731
                              device=like.device)
    return TwoFloat(mk(hi), mk(lo))


def two_sum(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-free transformation: returns (s, e) with s + e == a + b."""
    s = a + b
    z = s - a
    e = (a - (s - z)) + (b - z)
    return s, e


_SPLIT_F32 = 4097.0      # 2^12 + 1: Dekker split constant for float32
_SPLIT_F64 = 134217729.0  # 2^27 + 1: for float64


def _split(a):
    c = (_SPLIT_F32 if a.dtype == torch.float32 else _SPLIT_F64) * a
    ah = c - (c - a)
    return ah, a - ah


def two_prod(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-free product (Dekker): returns (p, e) with p + e == a * b."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def tf_prod(a, b) -> TwoFloat:
    """Exact product of two plain tensors as a TwoFloat."""
    return TwoFloat(*two_prod(a, b))


def tf_mul(x: TwoFloat, y: TwoFloat) -> TwoFloat:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    s, e2 = two_sum(p, e)
    return TwoFloat(s, e2)


def tf_recip(y: TwoFloat) -> TwoFloat:
    """1/y to ~eps^2 relative (one Newton step from the plain quotient)."""
    q = 1.0 / y.hi
    p, e = two_prod(y.hi, q)
    d = ((1.0 - p) - e) - y.lo * q
    s, e2 = two_sum(q, q * d)
    return TwoFloat(s, e2)


def tf_add(x: TwoFloat, y: TwoFloat) -> TwoFloat:
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    s, e2 = two_sum(s, e)
    return TwoFloat(s, e2)


def tf_neg(x: TwoFloat) -> TwoFloat:
    return TwoFloat(-x.hi, -x.lo)


def tf_scale(x: TwoFloat, c: float) -> TwoFloat:
    # exact for c a power of two (the only use here is 0.5)
    return TwoFloat(x.hi * c, x.lo * c)


def _csum_tree(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    err = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        s, e = two_sum(x[..., :half], x[..., half:2 * half])
        # stray element on odd lengths rides along to the next level
        if n % 2:
            s = torch.cat([s, x[..., -1:]], dim=-1)
        err = err + e.sum(dim=-1)
        x = s
    return x[..., 0], err


class _CSumLast(torch.autograd.Function):
    """(hi, lo) compensated sum over the last axis.

    hi + lo == sum(x) exactly, so d hi/dx_i = 1 and d lo/dx_i = 0: the
    backward is the plain sum's (a broadcast), never the two_sum tree's."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        hi, lo = _csum_tree(x)
        ctx.mark_non_differentiable(lo)
        return hi, lo

    @staticmethod
    def backward(ctx, g_hi, g_lo):
        return g_hi[..., None].expand(ctx.shape)


def csum(x: torch.Tensor, dim: int = -1) -> TwoFloat:
    """Compensated sum along ``dim``; returns a TwoFloat with it reduced."""
    return TwoFloat(*_CSumLast.apply(x.movedim(dim, -1).contiguous()))


def csum2(x: torch.Tensor) -> TwoFloat:
    """Compensated sum over the last two axes."""
    return csum(x.reshape(x.shape[:-2] + (-1,)))
