"""Diatomic STO overlap integrals (s/p valence shells, rows 1-3).

PyTorch counterpart of ``pyseqm_tpu/ops/overlap.py`` (a branch-free rebuild
of the reference ``diatom_overlap_matrix``, seqm/seqm_functions/
diat_overlap.py:3-246): every principal-quantum-number class is computed
densely and selected with masks, and the frame rotation collapses
analytically with the bond unit vector v:

    S[0,0] = S_ss,  S[p,0] = S_sigma_s v_p,  S[0,p] = -S_s_sigma v_p,
    S[p,q] = -S_sigma_sigma v_p v_q + S_pi_pi (delta_pq - v_p v_q).

Precision: the reference evaluates the A/B auxiliary integrals and their
alternating-sign combinations in float64.  ``precise=True`` (float32 inputs
only) evaluates the chain in double-float (hi, lo) arithmetic on plain f32
ops; on CUDA tensors one kernel launch per pair segment evaluates it
instead (ops/overlap_kernel.py, within one float32 ulp of the chain); its
gradient is the plain-f32 chain's (see _STf).

``row3`` adds the (3,1), (3,2) and (3,3) classes (Na..Cl) from the
generated coefficients of ops/overlap_general.py, evaluated on each class's
own cells only (index lists from host copies of the principal quantum
numbers) and scattered over the hand-coded classes' values.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.timing import count
from . import overlap_kernel
from .accmath import exp as _exp
from .accmath import exp_tf as _exp_tf
from .xsum import TwoFloat, tf_const, tf_prod, tf_recip, two_sum

SQRT3 = 1.7320508075688772


def _p15(x):
    """x**1.5 as x*sqrt(x); the tiny clamp keeps the gradient finite at 0."""
    xc = torch.clamp(x, min=torch.finfo(x.dtype).tiny)
    return torch.where(x > 0.0, xc * torch.sqrt(xc), torch.zeros_like(x))


def _p25(x):
    """x**2.5 (same zero-gradient guard as _p15)."""
    xc = torch.clamp(x, min=torch.finfo(x.dtype).tiny)
    return torch.where(x > 0.0, xc * xc * torch.sqrt(xc), torch.zeros_like(x))


def a_integrals(x0):
    """A_k(x) = int_1^inf t^k exp(-x t) dt, k=0..4; x0 == 0 maps to 0."""
    x = torch.where(x0 != 0.0, x0, torch.full_like(x0, float("inf")))
    a1 = _exp(-x) / x
    a2 = a1 + a1 / x
    a3 = a1 + 2.0 * a2 / x
    a4 = a1 + 3.0 * a3 / x
    a5 = a1 + 4.0 * a4 / x
    return [a1, a2, a3, a4, a5]


def b_integrals(x0):
    """B_k(x) = int_{-1}^{1} t^k exp(-x t) dt, k=0..4, in three regimes:
    |x| > 0.5 exact recursion, 1e-6 < |x| <= 0.5 Taylor series, smaller
    |x| limiting values.  Each branch sees a sanitized copy of x so the
    unselected branch never produces NaN gradients."""
    absx = torch.abs(x0)
    exact = absx > 0.5
    taylor = (absx <= 0.5) & (absx > 1.0e-6)

    xs = torch.clamp(torch.where(exact, x0, torch.ones_like(x0)), -85.0, 85.0)
    tx = _exp(xs) / xs
    tmx = -_exp(-xs) / xs
    e1 = tx + tmx
    e2 = -tx + tmx + e1 / xs
    e3 = tx + tmx + 2.0 * e2 / xs
    e4 = -tx + tmx + 3.0 * e3 / xs
    e5 = tx + tmx + 4.0 * e4 / xs

    xt = torch.where(taylor, x0, torch.zeros_like(x0))
    x2 = xt * xt
    t1 = 2.0 + x2 / 3.0 + x2 * x2 / 60.0 + x2 * x2 * x2 / 2520.0
    t3 = 2.0 / 3.0 + x2 / 5.0 + x2 * x2 / 84.0 + x2 * x2 * x2 / 3240.0
    t5 = 2.0 / 5.0 + x2 / 7.0 + x2 * x2 / 108.0 + x2 * x2 * x2 / 3960.0
    t2 = -2.0 / 3.0 * xt - xt * x2 / 15.0 - xt * x2 * x2 / 420.0
    t4 = -2.0 / 5.0 * xt - xt * x2 / 21.0 - xt * x2 * x2 / 540.0

    zero = torch.zeros_like(x0)
    sel = lambda e, t, lim: torch.where(  # noqa: E731
        exact, e, torch.where(taylor, t, lim))
    return [sel(e1, t1, zero + 2.0), sel(e2, t2, zero),
            sel(e3, t3, zero + 2.0 / 3.0), sel(e4, t4, zero),
            sel(e5, t5, zero + 2.0 / 5.0)]


# ---------------------------------------------------------------------------
# double-float (hi, lo) evaluation of the same A/B chain — pure f32 ops
# ---------------------------------------------------------------------------

def _exp_tf2(x: TwoFloat) -> TwoFloat:
    """exp of a TwoFloat argument: exp_tf(hi) * (1 + lo + lo^2/2)."""
    e = _exp_tf(x.hi)
    corr = x.lo * (1.0 + 0.5 * x.lo)
    return e + e.hi * corr


def _where_tf(m, a: TwoFloat, b: TwoFloat) -> TwoFloat:
    return TwoFloat(torch.where(m, a.hi, b.hi), torch.where(m, a.lo, b.lo))


def a_integrals_tf(x0: TwoFloat):
    """A_k(x) in double-float, factored as exp(-x) * poly(1/x)."""
    mask = x0.hi != 0.0
    # big-x stand-in for padding: exp_tf saturates it to exact 0
    x = TwoFloat(torch.where(mask, x0.hi, torch.full_like(x0.hi, 1.0e4)),
                 torch.where(mask, x0.lo, torch.zeros_like(x0.lo)))
    u = tf_recip(x)
    e = _exp_tf2(-x)
    a1 = e * u
    a2 = a1 + a1 * u
    a3 = a1 + 2.0 * (a2 * u)
    a4 = a1 + 3.0 * (a3 * u)
    a5 = a1 + 4.0 * (a4 * u)
    return [a1, a2, a3, a4, a5]


def b_integrals_tf(x0: TwoFloat):
    """B_k(x) in double-float, same three regimes as b_integrals."""
    hi0 = x0.hi
    absx = torch.abs(hi0)
    exact = absx > 0.5
    taylor = (absx <= 0.5) & (absx > 1.0e-6)
    zero_t = torch.zeros_like(hi0)

    xs_hi = torch.clamp(torch.where(exact, hi0, torch.ones_like(hi0)),
                        -85.0, 85.0)
    xs_lo = torch.where(exact & (absx <= 85.0), x0.lo, zero_t)
    xe = TwoFloat(xs_hi, xs_lo)
    u = tf_recip(xe)
    ep = _exp_tf2(xe)
    em = tf_recip(ep)
    tx = ep * u
    tmx = -(em * u)
    e1 = tx + tmx
    e2 = -tx + tmx + e1 * u
    e3 = tx + tmx + 2.0 * (e2 * u)
    e4 = -tx + tmx + 3.0 * (e3 * u)
    e5 = tx + tmx + 4.0 * (e4 * u)

    xt = TwoFloat(torch.where(taylor, hi0, zero_t),
                  torch.where(taylor, x0.lo, zero_t))
    x2 = xt * xt
    c = lambda v: tf_const(v, hi0)  # noqa: E731
    t1 = ((x2 * c(1.0 / 2520.0) + c(1.0 / 60.0)) * x2 + c(1.0 / 3.0)) * x2 + 2.0
    t3 = ((x2 * c(1.0 / 3240.0) + c(1.0 / 84.0)) * x2 + c(1.0 / 5.0)) * x2 + c(2.0 / 3.0)
    t5 = ((x2 * c(1.0 / 3960.0) + c(1.0 / 108.0)) * x2 + c(1.0 / 7.0)) * x2 + c(2.0 / 5.0)
    t2 = -(xt * (((x2 * c(1.0 / 420.0) + c(1.0 / 15.0)) * x2) + c(2.0 / 3.0)))
    t4 = -(xt * (((x2 * c(1.0 / 540.0) + c(1.0 / 21.0)) * x2) + c(2.0 / 5.0)))

    zero = TwoFloat(zero_t, zero_t)
    l1 = zero + 2.0
    l3 = zero + c(2.0 / 3.0)
    l5 = zero + c(2.0 / 5.0)

    b1 = _where_tf(exact, e1, _where_tf(taylor, t1, l1))
    b2 = _where_tf(exact, e2, _where_tf(taylor, t2, zero))
    b3 = _where_tf(exact, e3, _where_tf(taylor, t3, l3))
    b4 = _where_tf(exact, e4, _where_tf(taylor, t4, zero))
    b5 = _where_tf(exact, e5, _where_tf(taylor, t5, l5))
    return [b1, b2, b3, b4, b5]


def _arg_tf(rij, z1, z2, sign) -> TwoFloat:
    """0.5 * rij * (z1 + sign*z2) carried exactly as a TwoFloat."""
    s, e = two_sum(z1, sign * z2)
    p = tf_prod(rij, s) + e * rij
    return TwoFloat(0.5 * p.hi, 0.5 * p.lo)


def _ab_plain(rij, z1, z2):
    return (a_integrals(0.5 * rij * (z1 + z2)),
            b_integrals(0.5 * rij * (z1 - z2)))


def _ab_tf(rij, z1, z2):
    return (a_integrals_tf(_arg_tf(rij, z1, z2, 1.0)),
            b_integrals_tf(_arg_tf(rij, z1, z2, -1.0)))


def _s_combinations(rij, zsi, zpi, zsj, zpj, jcall2, jcall3, jcall4,
                    precise, mode=4):
    """The five sigma/pi overlap combinations (S111, S211, S121, S221, S222)
    for ss, ps-s, s-ps, pp-sigma, pp-pi (cf. diat_overlap.py:253-365).

    ``mode`` is the highest jcall class present: 4 general, 3 the lighter
    atom s-only (X-H: no jcall4 combinations), 2 both s-only (H-H: the ss
    combination alone).  Skipped combinations return zeros."""
    if precise:
        ab = lambda z1, z2: _ab_tf(rij, z1, z2)           # noqa: E731
        val = lambda t: t.value()                          # noqa: E731
    else:
        ab = lambda z1, z2: _ab_plain(rij, z1, z2)         # noqa: E731
        val = lambda t: t                                  # noqa: E731

    r2 = rij * rij
    r4 = r2 * r2
    r5 = r4 * rij
    zero = torch.zeros_like(rij)
    # skipped combinations: distinct zero tensors (autograd.Function
    # outputs must not alias each other)
    zeros = lambda k: [torch.zeros_like(rij) for _ in range(k)]  # noqa: E731

    A, B = ab(zsi, zsj)
    s111_2 = (_p15(zsi * zsj * r2) / 4.0) * val(A[2] * B[0] - B[2] * A[0])
    if mode == 2:
        return (torch.where(jcall2, s111_2, zero), *zeros(4))
    s111_3 = (_p15(zsj) * _p25(zsi) * r4 / (SQRT3 * 8.0)
              * val(A[3] * B[0] - B[3] * A[0] + A[2] * B[1] - B[2] * A[1]))
    if mode >= 4:
        s111_4 = (_p25(zsj * zsi) * r5 / 48.0
                  * val(A[4] * B[0] + B[4] * A[0] - 2.0 * (A[2] * B[2])))
        S111 = torch.where(jcall2, s111_2, torch.where(
            jcall3, s111_3, torch.where(jcall4, s111_4, zero)))
    else:
        S111 = torch.where(jcall2, s111_2, torch.where(jcall3, s111_3, zero))

    A, B = ab(zpi, zsj)
    s211_3 = (_p15(zsj) * _p25(zpi) * r4 / 8.0
              * val(A[2] * B[0] - B[2] * A[0] + A[3] * B[1] - B[3] * A[1]))
    if mode == 3:
        return (S111, torch.where(jcall3, s211_3, zero), *zeros(3))
    s211_4 = (_p25(zsj * zpi) * r5 / (16.0 * SQRT3)
              * val(A[3] * (B[0] - B[2]) - A[1] * (B[2] - B[4])
                    + B[3] * (A[0] - A[2]) - B[1] * (A[2] - A[4])))
    S211 = torch.where(jcall3, s211_3, torch.where(jcall4, s211_4, zero))

    A, B = ab(zsi, zpj)
    s121_4 = (_p25(zpj * zsi) * r5 / (16.0 * SQRT3)
              * val(A[3] * (B[0] - B[2]) - A[1] * (B[2] - B[4])
                    - B[3] * (A[0] - A[2]) + B[1] * (A[2] - A[4])))
    S121 = torch.where(jcall4, s121_4, zero)

    A, B = ab(zpi, zpj)
    wf = _p25(zpj * zpi) * r5 / 16.0
    s221_4 = -wf * val(B[2] * (A[4] + A[0]) - A[2] * (B[4] + B[0]))
    s222_4 = 0.5 * wf * val(A[4] * (B[0] - B[2]) - B[4] * (A[0] - A[2])
                            - A[2] * B[0] + B[2] * A[0])
    S221 = torch.where(jcall4, s221_4, zero)
    S222 = torch.where(jcall4, s222_4, zero)
    return S111, S211, S121, S221, S222


class _STf(torch.autograd.Function):
    """Double-float primal, plain-f32 gradient (counterpart of the JAX
    package's custom_jvp ``_make_s_combinations_tf``).

    The primal of float32 CUDA tensors is one launch of the overlap
    kernel (ops/overlap_kernel.py), that of any other tensor the
    double-float chain; each call counts its cells as
    ``overlap.kernel_cells`` or ``overlap.plain_cells`` in the open span.

    Only the value of S needs the extended precision (it feeds the
    alternating-sign Hf cancellation); its derivative feeds forces, whose
    f32 noise floor is orders above the ~1e-7 relative gap between the
    plain and double-float derivatives, and autograd through every
    two_sum/two_prod would dominate the Hcore backward.

    The gradient is the plain chain's.  Under ``create_graph`` (grad mode
    on in ``backward``) it is taken on the saved inputs with their graph,
    so it carries the plain chain's second derivative, as the JAX
    custom_jvp's tangent does under forward-over-reverse; otherwise on
    detached copies, so a force step records nothing more."""

    @staticmethod
    def forward(ctx, mode, rij, zsi, zpi, zsj, zpj, j2, j3, j4):
        ctx.mode = mode
        ctx.save_for_backward(rij, zsi, zpi, zsj, zpj, j2, j3, j4)
        ins = (rij, zsi, zpi, zsj, zpj, j2, j3, j4)
        cells = math.prod(torch.broadcast_shapes(*(t.shape for t in ins)))
        if overlap_kernel.supported(rij.device, rij.dtype):
            count("overlap.kernel_cells", cells)
            return overlap_kernel.s_combinations(mode, *ins)
        count("overlap.plain_cells", cells)
        return _s_combinations(*ins, True, mode)

    @staticmethod
    def backward(ctx, *gs):
        rij, zsi, zpi, zsj, zpj, j2, j3, j4 = ctx.saved_tensors
        higher = torch.is_grad_enabled()
        need = ctx.needs_input_grad[1:6]
        if higher:
            ins = list((rij, zsi, zpi, zsj, zpj))
        else:
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip((rij, zsi, zpi, zsj, zpj), need)]
        grads = [None] * 5
        with torch.enable_grad():
            outs = _s_combinations(*ins, j2, j3, j4, False, ctx.mode)
            pairs = [(o, g) for o, g in zip(outs, gs)
                     if o.requires_grad and g is not None]
            want = [t for t, n in zip(ins, need) if n]
            if pairs and want:
                got = torch.autograd.grad([o for o, _ in pairs],
                                          want, [g for _, g in pairs],
                                          allow_unused=True,
                                          create_graph=higher)
                it = iter(got)
                grads = [next(it) if n else None for n in need]
        return (None, *grads, None, None, None)


def _s_combinations_tf(rij, zsi, zpi, zsj, zpj, jcall2, jcall3, jcall4,
                       mode=4):
    return _STf.apply(mode, rij, zsi, zpi, zsj, zpj, jcall2, jcall3, jcall4)


def _reg_v(xij):
    """Bond direction with the reference's near-axis regularization
    (diat_overlap.py:24-45): below xy < 1e-10 snap to +-z."""
    xy = torch.sqrt(xij[..., 0] ** 2 + xij[..., 1] ** 2)
    zsign = torch.sign(xij[..., 2])
    zero = torch.zeros_like(zsign)
    return torch.where((xy >= 1.0e-10)[..., None], xij,
                       torch.stack([zero, zero, zsign], dim=-1))


def _combinations(rij, zsi, zpi, zsj, zpj, jcall2, jcall3, jcall4, precise,
                  mode):
    if precise and rij.dtype == torch.float32:
        return _s_combinations_tf(rij, zsi, zpi, zsj, zpj, jcall2, jcall3,
                                  jcall4, mode=mode)
    return _s_combinations(rij, zsi, zpi, zsj, zpj, jcall2, jcall3, jcall4,
                           False, mode)


ROW3_CLASSES = ((3, 1), (3, 2), (3, 3))


def _row3_classes(combos, rij, zsi, zpi, zsj, zpj, precise, qni, qnj,
                  qn_host, classes):
    """``combos`` (the five combinations on every cell) with the cells of
    each row-3 class replaced by the generated-coefficient values.

    The cells of a class are listed on the host from ``qn_host`` = (qn_i,
    qn_j), numpy arrays broadcastable to rij's shape; without it they are
    copied from qni/qnj (a device sync).  Each class runs on its own cells
    only, and none runs when its class is absent."""
    from .overlap_general import (s_combinations_general,
                                  s_combinations_general_tf)
    if qn_host is None:
        qn_host = (qni.cpu().numpy(), qnj.cpu().numpy())
    shape = rij.shape
    qi, qj = (np.broadcast_to(q, shape).reshape(-1) for q in qn_host)
    gen = (s_combinations_general_tf
           if precise and rij.dtype == torch.float32 else
           s_combinations_general)
    out = [c.reshape(-1) for c in combos]
    for na, nb in classes:
        sel = np.flatnonzero((qi == na) & (qj == nb))
        if sel.size == 0:
            continue
        idx = torch.as_tensor(sel, device=rij.device)
        # nb == 1 (X-H): the lighter atom is s-only, S121..S222 stay zero
        g = gen(na, nb, *[t.expand(shape).reshape(-1)[idx]
                          for t in (rij, zsi, zpi, zsj, zpj)],
                n=5 if nb > 1 else 2)
        for k, gk in enumerate(g):
            out[k] = out[k].scatter(0, idx, gk)
    return [o.reshape(shape) for o in out]


def diatom_overlap_xh(qni, qnj, xij, rij, zeta_i, zsj, precise=False,
                      row3=False, qn_host=None):
    """Overlap column (AOs on i | s AO on j) for the X-H pair segment:
    S[0] = S_ss, S[1+p] = S_sigma_s v_p (cf. the reference's jcall==3
    branch, diat_overlap.py:253-298).  ``row3`` adds the (3,1) class
    (``qn_host`` as in diatom_overlap).  Returns (..., 4)."""
    jcall2 = (qni == 1) & (qnj == 1)
    jcall3 = (qni == 2) & (qnj == 1)
    one = torch.ones_like(rij)
    # a hydrogen in the packed layout's heavy block is s-only: a 1 stands
    # in for its zeta_p, as in diatom_overlap (a learned one near 0 turns
    # the unread combinations' float32 cotangents NaN)
    zsi = zeta_i[..., 0]
    zpi = torch.where(qni > 1, zeta_i[..., 1], one)
    S = _combinations(rij, zsi, zpi, zsj, one, jcall2, jcall3,
                      torch.zeros_like(jcall3), precise, 3)
    if row3:
        S = _row3_classes(S, rij, zsi, zpi, zsj, one, precise, qni, qnj,
                          qn_host, ROW3_CLASSES[:1])
    v = _reg_v(xij)
    return torch.cat([S[0][..., None], S[1][..., None] * v], dim=-1)


def diatom_overlap_hh(qni, qnj, rij, zsi, zsj, precise=False):
    """Scalar s-s overlap for the H-H pair segment (jcall==2 branch)."""
    jcall2 = (qni == 1) & (qnj == 1)
    one = torch.ones_like(rij)
    never = torch.zeros_like(jcall2)
    S111, _, _, _, _ = _combinations(rij, zsi, one, zsj, one, jcall2,
                                     never, never, precise, 2)
    return S111


def diatom_overlap(qni, qnj, xij, rij, zeta_i, zeta_j, precise=False,
                   row3=False, qn_host=None):
    """Overlap 4x4 block between the AOs of an (i, j) pair.

    Args:
      qni, qnj: (...,) valence principal quantum numbers (qni >= qnj).
      xij: (..., 3) unit vector i->j.
      rij: (...,) distance in Bohr.
      zeta_i, zeta_j: (..., 2) [zeta_s, zeta_p] orbital exponents.
      precise: double-float A/B chain (float32 inputs only; with row3 the
        row-3 classes' chain too).
      row3: add the (3,1)/(3,2)/(3,3) classes (ops/overlap_general.py),
        beyond the reference, which raises for any row-3 pair.
      qn_host: (qn_i, qn_j) as host numpy arrays broadcastable to rij's
        shape, the row-3 classes' cell lists without a device sync.

    Returns: (..., 4, 4) overlap in the molecular frame (rows: AOs on i).
    """
    jcall2 = (qni == 1) & (qnj == 1)
    jcall3 = (qni == 2) & (qnj == 1)
    jcall4 = (qni == 2) & (qnj == 2)
    # an s-only atom (qn 1) has no p exponent and no class reads one: a
    # harmless 1 stands in for whatever its zeta_p holds, as in
    # diatom_overlap_xh.  A learned hydrogen zeta_p near 0 overflows the
    # unread combinations at float32, and their zero cotangents turn NaN
    one = torch.ones_like(rij)
    zs = (zeta_i[..., 0], torch.where(qni > 1, zeta_i[..., 1], one),
          zeta_j[..., 0], torch.where(qnj > 1, zeta_j[..., 1], one))
    S = _combinations(rij, *zs, jcall2, jcall3, jcall4, precise, 4)
    if row3:
        S = _row3_classes(S, rij, *zs, precise, qni, qnj, qn_host,
                          ROW3_CLASSES)
    S111, S211, S121, S221, S222 = S

    v = _reg_v(xij)
    eye3 = torch.eye(3, dtype=rij.dtype, device=rij.device)
    vv = v[..., :, None] * v[..., None, :]            # (..., 3, 3)
    pp = -S221[..., None, None] * vv + S222[..., None, None] * (eye3 - vv)
    top = torch.cat([S111[..., None], -S121[..., None] * v], dim=-1)
    low = torch.cat([(S211[..., None] * v)[..., None], pp], dim=-1)
    return torch.cat([top[..., None, :], low], dim=-2)
