"""Accurate float32 exponentials for the integral path.

PyTorch counterpart of ``pyseqm_tpu/ops/accmath.py``.  `exp` is the
classical Cody-Waite + minimax construction in plain float32 ops, accurate
to ~1 ulp on every device, so the exp-dominated STO overlap A/B integrals
and core-core Gaussian terms do not inherit a vendor's hardware exp:

    n = round(x / ln2);  r = x - n*L1 - n*L2   (two-constant reduction)
    exp(x) = 2^n * P(r),  r in [-ln2/2, ln2/2]

with 2^n built exactly by integer bit assembly and P a degree-6 polynomial.
`exp_tf` carries the reduction and the low Horner steps in double-float.
Both are autograd Functions with d exp = exp dx, reusing the accurate value.
float64 inputs pass through to torch.exp.
"""
from __future__ import annotations

import numpy as np
import torch

from .xsum import TwoFloat, tf_const, two_prod, two_sum

_LN2 = 0.6931471805599453094172321215
_LN2_HI = 0.693359375            # exactly representable leading part
_LN2_MID = float(np.float32(_LN2 - _LN2_HI))
_LN2_LO = float(np.float32(_LN2 - _LN2_HI - _LN2_MID))
_LN2_MIDLO = float(np.float32(_LN2_MID + _LN2_LO))
_INV_LN2 = 1.4426950408889634
# true f32 exp range: max normal at x ~ 88.7228, smallest subnormal rounds
# to zero below x ~ -103.97
_EXP_HI = 88.7228
_EXP_LO = -103.97


def _scale_2n(p, n):
    """p * 2^n via two exact power-of-two scalings (each factor's exponent
    stays in the normal range for n in [-151, 129])."""
    n1 = n >> 1
    n2 = n - n1
    f1 = ((n1 + 127) << 23).view(torch.float32)
    f2 = ((n2 + 127) << 23).view(torch.float32)
    return (p * f1) * f2


def _saturate(x, y, hi_value):
    y = torch.where(x > _EXP_HI, torch.full_like(y, hi_value), y)
    return torch.where(x < _EXP_LO, torch.zeros_like(y), y)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    xc = torch.clamp(x, -104.0, 89.0)
    n = torch.round(xc * _INV_LN2)
    r = (xc - n * _LN2_HI) - n * _LN2_MIDLO
    # degree-6 polynomial, |r| <= 0.3466: rel err < 6e-9
    p = r * (1.0 / 720.0) + 1.0 / 120.0
    p = p * r + 1.0 / 24.0
    p = p * r + 1.0 / 6.0
    p = p * r + 0.5
    p = p * r + 1.0
    p = p * r + 1.0
    y = _scale_2n(p, n.to(torch.int32))
    return _saturate(x, y, float("inf"))


class _Exp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _exp_f32(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def exp(x: torch.Tensor) -> torch.Tensor:
    """~1 ulp float32 exp (float64 passes through to torch.exp)."""
    if x.dtype != torch.float32:
        return torch.exp(x)
    return _Exp.apply(x)


def _exp_tf_f32(x: torch.Tensor):
    xc = torch.clamp(x, -104.0, 89.0)
    n = torch.round(xc * _INV_LN2)
    r_hi = xc - n * _LN2_HI                      # exact (Cody-Waite)
    m, me = two_prod(n, torch.full((), _LN2_MID, dtype=x.dtype,
                                   device=x.device))
    s, se = two_sum(r_hi, -m)
    lo = (se - me) - n * _LN2_LO
    s, lo = two_sum(s, lo)
    r = TwoFloat(s, lo)                          # |r| <= ln2/2, ~1e-13 abs
    # tail in plain f32: its rounding enters scaled by r^5 <= 5e-3
    t = s * float(np.float32(1.0 / 362880.0)) + float(np.float32(1.0 / 40320.0))
    t = t * s + float(np.float32(1.0 / 5040.0))
    t = t * s + float(np.float32(1.0 / 720.0))
    t = t * s + float(np.float32(1.0 / 120.0))
    p = r * t + tf_const(1.0 / 24.0, x)
    p = p * r + tf_const(1.0 / 6.0, x)
    p = p * r + 0.5
    p = p * r + 1.0
    p = p * r + 1.0
    ni = n.to(torch.int32)
    hi = _saturate(x, _scale_2n(p.hi, ni), float("inf"))
    lo = _saturate(x, _scale_2n(p.lo, ni), 0.0)
    return hi, lo


class _ExpTF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        hi, lo = _exp_tf_f32(x)
        ctx.save_for_backward(hi, lo)
        return hi, lo

    @staticmethod
    def backward(ctx, g_hi, g_lo):
        hi, lo = ctx.saved_tensors
        # derivative at plain-f32 accuracy (forces don't need the lo bits)
        return g_hi * hi + g_lo * lo


def exp_tf(x: torch.Tensor) -> TwoFloat:
    """float32 exp to ~1e-11 relative, returned as a TwoFloat."""
    if x.dtype != torch.float32:
        y = torch.exp(x)
        return TwoFloat(y, torch.zeros_like(y))
    return TwoFloat(*_ExpTF.apply(x))
