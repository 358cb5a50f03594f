"""Multipole charge separations and Klopman additive terms.

PyTorch counterpart of ``pyseqm_tpu/ops/multipole.py`` (dd_qq /
additive_term_rho1 / additive_term_rho2 of the reference,
seqm/seqm_functions/cal_par.py:8-196).  rho1/rho2 are defined implicitly by
the hsp/hpp match conditions of the Klopman point-charge model and solved
with a fixed-iteration secant method; their gradients are the analytic
implicit-function derivatives (autograd Functions), so autograd never walks
the secant loop.  Those derivatives are once differentiable: a second
derivative raises, as it does through the JAX package's custom_vjp.  ``mask`` selects the atoms whose inputs are physical;
the rest are computed on sanitized values and zeroed.
"""
from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from ..constants import EV

_N_SECANT = 25


def _eps_for(dtype) -> float:
    return 1.0e-7 if dtype == torch.float32 else 1.0e-16


def dd_qq(qn, zs, zp):
    """Dipole (dd) and quadrupole (qq) charge separations from zeta_s/zeta_p
    (qn the principal quantum number as float; zs, zp > 0).  The float
    powers are expanded into integer powers and sqrt."""
    v = 4.0 * zs * zp
    w = zs + zp
    is1 = qn < 1.5
    is3 = qn > 2.5
    v_pow = torch.where(is1, v, torch.where(is3, v * v * v, v * v)) * torch.sqrt(v)
    w2 = w * w
    w_pow = torch.where(is1, w2 * w2,
                        torch.where(is3, w2 * w2 * w2 * w2, w2 * w2 * w2))
    dd = (2.0 * qn + 1.0) * v_pow / w_pow / math.sqrt(3.0)
    qq = torch.sqrt((4.0 * qn ** 2 + 6.0 * qn + 2.0) / 20.0) / zp
    return dd, qq


def _secant(h_of, target, x1, eps):
    """Fixed-iteration masked secant solve h_of(x) = target (each point's
    h evaluated once)."""
    x2 = x1 + 0.04
    h1 = h_of(x1)
    for _ in range(_N_SECANT):
        h2 = h_of(x2)
        denom = h2 - h1
        step_ok = torch.abs(denom) > eps
        safe_denom = torch.where(step_ok, denom, torch.ones_like(denom))
        x3 = torch.where(step_ok, x1 + (x2 - x1) * (target - h1) / safe_denom,
                         x2)
        x1, x2, h1 = x2, x3, h2
    return x2


class _Rho1(torch.autograd.Function):
    """rho1 = 1/(2*ad): solves hsp = d/2 - 1/(2 sqrt(4 D1^2 + 1/d^2)) (a.u.)."""

    @staticmethod
    def forward(ctx, hsp_ev, d1, mask):
        eps = _eps_for(hsp_ev.dtype)
        hsp = torch.where(mask, hsp_ev, torch.ones_like(hsp_ev)) / EV
        D1 = torch.where(mask, d1, torch.ones_like(d1))
        x0 = torch.sign(hsp) * (torch.abs(hsp) / D1 ** 2) ** (1.0 / 3.0)

        c = 4.0 * D1 ** 2

        def h_of(d):
            return 0.5 * d - 0.5 / torch.sqrt(c + 1.0 / d ** 2)

        d = _secant(h_of, hsp, x0, eps)
        rho1 = torch.where(mask, 0.5 / d, torch.zeros_like(d))
        ctx.save_for_backward(rho1, D1, mask)
        return rho1

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # implicit derivative (cf. cal_par.py:92-110):
        # hsp(a.u.) = 1/(4 rho1) - 1/(4 sqrt(D1^2 + rho1^2))
        rho1, D1, mask = ctx.saved_tensors
        r = torch.where(mask, rho1, torch.ones_like(rho1))
        t = D1 ** 2 + r ** 2
        tmp = t * torch.sqrt(t)
        g_hsp = 4.0 / (r / tmp - 1.0 / r ** 2) * g / EV
        g_d1 = g / (tmp / r ** 2 / D1 - r / D1)
        z = torch.zeros_like(g)
        return torch.where(mask, g_hsp, z), torch.where(mask, g_d1, z), None


class _Rho2(torch.autograd.Function):
    """rho2 = 1/(2*aq): solves hpp = q/4 - 1/(2 sqrt(4 D2^2 + 1/q^2))
    + 1/(4 sqrt(8 D2^2 + 1/q^2)) (a.u.)."""

    @staticmethod
    def forward(ctx, hpp_ev, d2, mask):
        eps = _eps_for(hpp_ev.dtype)
        hpp = torch.where(mask, hpp_ev, torch.ones_like(hpp_ev)) / EV
        D2 = torch.where(mask, d2, torch.ones_like(d2))
        x0 = torch.sign(hpp) * (torch.abs(hpp) / 3.0 / D2 ** 4) ** 0.2

        c4, c8 = 4.0 * D2 ** 2, 8.0 * D2 ** 2

        def h_of(q):
            iq2 = 1.0 / q ** 2
            return (0.25 * q - 0.5 / torch.sqrt(c4 + iq2)
                    + 0.25 / torch.sqrt(c8 + iq2))

        q = _secant(h_of, hpp, x0, eps)
        rho2 = torch.where(mask, 0.5 / q, torch.zeros_like(q))
        ctx.save_for_backward(rho2, D2, mask)
        return rho2

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # implicit derivative (cf. cal_par.py:175-196):
        # hpp(a.u.) = 1/(8 rho2) - 1/(4 sqrt(D2^2+rho2^2))
        #             + 1/(8 sqrt(2 D2^2+rho2^2))
        rho2, D2, mask = ctx.saved_tensors
        r = torch.where(mask, rho2, torch.ones_like(rho2))
        t1 = D2 ** 2 + r ** 2
        t2 = 2.0 * D2 ** 2 + r ** 2
        tmp1 = 1.0 / (t1 * torch.sqrt(t1))
        tmp2 = 1.0 / (t2 * torch.sqrt(t2))
        dhdr = -0.125 / r ** 2 + r * (tmp1 / 4.0 - tmp2 / 8.0)
        g_hpp = g / dhdr / EV
        g_d2 = -(D2 / 4.0 * (tmp1 - tmp2)) * g / dhdr
        z = torch.zeros_like(g)
        return torch.where(mask, g_hpp, z), torch.where(mask, g_d2, z), None


# The additive terms are solved and differentiated in float64 whatever the
# inputs' precision (one value per atom).  Where hsp or hpp nears 0, as a
# learned one can (the trained HIP-NN's oxygen h_sp lies about 0), rho
# grows without bound; at float32 the implicit derivatives' denominators
# then cancel (r / (D^2 + r^2)^1.5 against 1 / r^2 once D^2 / r^2 nears the
# float32 epsilon) and the secant can land on d = 0, and the force goes NaN.


def rho1_additive(hsp_ev, d1, mask):
    return _Rho1.apply(hsp_ev.double(), d1.double(), mask).to(hsp_ev.dtype)


def rho2_additive(hpp_ev, d2, mask):
    return _Rho2.apply(hpp_ev.double(), d2.double(), mask).to(hpp_ev.dtype)
