"""General STO diatomic overlap for arbitrary (na, nb) s/p shells (row 3).

PyTorch counterpart of ``pyseqm_tpu/ops/overlap_general.py``.  The
hand-coded chains of ops/overlap.py cover the principal-quantum-number
classes of rows 1-2; the reference raises for any row-3 pair
(seqm_functions/diat_overlap.py:65-72) although its parameter tables ship
Na..Cl.  This module builds the Mulliken prolate-spheroidal expansion
coefficients programmatically:

    S = pref(R, za, zb) * sum_{k,l} c[k,l] A_k(p) B_l(pt),
    p = R (za + zb)/2,  pt = R (za - zb)/2,

where c[k,l] comes from exact polynomial algebra in (xi, eta): binomial
expansions of r_a^{na-1} r_b^{nb-1}, the cos/sin angular factors and the
volume element.  For the row 1-2 classes the generated coefficients
reproduce the hand-coded combinations, which pins the machinery that the
row-3 classes use.

Conventions match ops/overlap.py's local frame; the combinations are
(S111, S211, S121, S221, S222) = (s-s, psigma-s, s-psigma, psigma-psigma,
ppi-ppi).  On float32 the double-float chain (``s_combinations_general_tf``)
carries the value: the binomial cancellation at high k loses ~4.5e-3 in
plain float32.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .accmath import exp as _exp
from .overlap import _arg_tf, _exp_tf2, _where_tf
from .xsum import TwoFloat, tf_recip


# --- polynomial algebra in (xi, eta) ----------------------------------------
def _pmul(p1, p2):
    out = {}
    for (i1, j1), c1 in p1.items():
        for (i2, j2), c2 in p2.items():
            k = (i1 + i2, j1 + j2)
            out[k] = out.get(k, 0.0) + c1 * c2
    return out


def _ppow(p, n):
    out = {(0, 0): 1.0}
    for _ in range(n):
        out = _pmul(out, p)
    return out


_XI_P_ETA = {(1, 0): 1.0, (0, 1): 1.0}      # (xi + eta)
_XI_M_ETA = {(1, 0): 1.0, (0, 1): -1.0}     # (xi - eta)


@functools.lru_cache(maxsize=None)
def overlap_coeffs(na: int, la: int, nb: int, lb: int, pi: bool):
    """Coefficient matrix c[k, l] (numpy, (kmax+1, lmax+1)) such that the
    xi/eta integral equals sum c[k,l] A_k(p) B_l(pt)."""
    P = {(0, 0): 1.0}
    P = _pmul(P, _ppow(_XI_P_ETA, na - 1))          # r_a^{na-1} (xi part)
    P = _pmul(P, _ppow(_XI_M_ETA, nb - 1))          # r_b^{nb-1}
    dp = dm = 0
    if pi:
        # sin(theta_a) sin(theta_b) = sqrt((xi^2-1)(1-eta^2)) / (xi+eta)
        #                           * sqrt((xi^2-1)(1-eta^2)) / (xi-eta)
        P = _pmul(P, _pmul({(2, 0): 1.0, (0, 0): -1.0},
                           {(0, 0): 1.0, (0, 2): -1.0}))
        dp += 1
        dm += 1
    else:
        if la == 1:                                  # cos(theta_a)
            P = _pmul(P, {(1, 1): 1.0, (0, 0): 1.0})  # (1 + xi eta)/(xi+eta)
            dp += 1
        if lb == 1:                                  # cos(theta_b), +z toward b
            P = _pmul(P, {(1, 1): 1.0, (0, 0): -1.0})  # (xi eta - 1)/(xi-eta)
            dm += 1
    # volume element (xi^2 - eta^2) = (xi+eta)(xi-eta); factors not consumed
    # by angular denominators multiply in
    if dp == 0:
        P = _pmul(P, _XI_P_ETA)
    if dm == 0:
        P = _pmul(P, _XI_M_ETA)
    kmax = max(k for (k, _) in P)
    lmax = max(l for (_, l) in P)
    c = np.zeros((kmax + 1, lmax + 1))
    for (k, l), v in P.items():
        c[k, l] = v
    return c


def _ipow(x, n):
    out = torch.ones_like(x)
    for _ in range(n):
        out = out * x
    return out


def _prefactor(na, la, nb, lb, pi, za, zb, rij):
    """N_a N_b AngNorm Phi (R/2)^{na+nb+1}, pow-free."""
    # (2 za)^{2na+1} (2 zb)^{2nb+1} / ((2na)! (2nb)!), then sqrt
    t = (_ipow(2.0 * za, 2 * na + 1) * _ipow(2.0 * zb, 2 * nb + 1)
         / (math.factorial(2 * na) * math.factorial(2 * nb)))
    tc = torch.clamp(t, min=torch.finfo(t.dtype).tiny)
    norm = torch.where(t > 0.0, torch.sqrt(tc), torch.zeros_like(t))
    ang = 1.0 / (4.0 * math.pi)
    if pi:
        ang *= 3.0
        phi = math.pi
    else:
        ang *= math.sqrt(3.0) ** (int(la == 1) + int(lb == 1))
        phi = 2.0 * math.pi
    return norm * (ang * phi) * _ipow(0.5 * rij, na + nb + 1)


def a_integrals_n(x0, kmax: int):
    """A_k(x) = int_1^inf t^k e^{-xt} dt, k = 0..kmax (cf. a_integrals)."""
    x = torch.where(x0 != 0.0, x0, torch.full_like(x0, float("inf")))
    a = [_exp(-x) / x]
    for k in range(1, kmax + 1):
        a.append(a[0] + k * a[-1] / x)
    return a


def _taylor_coefs(k: int, terms: int):
    """(j, coefficient) of B_k's Taylor series sum_j (-x)^j/j! 2/(k+j+1)
    over even k + j."""
    return [(j, ((-1.0) ** j) / math.factorial(j) * 2.0 / (k + j + 1))
            for j in range(terms + 1) if (k + j) % 2 == 0]


def b_integrals_n(x0, kmax: int, taylor_terms: int = 16):
    """B_k(x) = int_{-1}^{1} t^k e^{-xt} dt, k = 0..kmax.

    Two regimes: |x| > 0.5 exact recursion, else the Taylor series with 16
    terms (the next term at |x| = 0.5 is ~1e-16 relative)."""
    exact = torch.abs(x0) > 0.5

    xs = torch.clamp(torch.where(exact, x0, torch.ones_like(x0)), -85.0, 85.0)
    tx = _exp(xs) / xs
    tmx = -_exp(-xs) / xs
    be = [tx + tmx]
    for k in range(1, kmax + 1):
        sgn = 1.0 if k % 2 == 0 else -1.0
        be.append(sgn * tx + tmx + k * be[-1] / xs)

    xt = torch.where(exact, torch.zeros_like(x0), x0)
    powers = [torch.ones_like(xt)]
    for _ in range(taylor_terms):
        powers.append(powers[-1] * xt)
    bt = []
    for k in range(kmax + 1):
        s = torch.zeros_like(xt)
        for j, coef in _taylor_coefs(k, taylor_terms):
            s = s + coef * powers[j]
        bt.append(s)

    return [torch.where(exact, be[k], bt[k]) for k in range(kmax + 1)]


# the five combinations: (la, lb, pi, exponent pair, sign); S211/S121
# carry the p orbital pointing along +bond on their center (the caller
# applies the +v/-v rotation signs)
_COMBOS = ((0, 0, False, "ss", 1.0), (1, 0, False, "ps", 1.0),
           (0, 1, False, "sp", -1.0), (1, 1, False, "pp", -1.0),
           (1, 1, True, "pp", 1.0))


def _class_combinations(na, nb, rij, zsi, zpi, zsj, zpj, n, ab_fn, sum_fn):
    """The first ``n`` of (S111, S211, S121, S221, S222) for class (na,
    nb): one A_k/B_k evaluation for all the exponent pairs they use, up to
    the largest k any of them needs (stacked on a leading pair axis), then
    each combination's coefficient sum."""
    combos = _COMBOS[:n]
    zeta = {"s": (zsi, zsj), "p": (zpi, zpj)}
    pairs = list(dict.fromkeys(pair for *_, pair, _ in combos))
    km = max(max(overlap_coeffs(na, la, nb, lb, pi).shape) - 1
             for la, lb, pi, _, _ in combos)
    za = torch.stack([zeta[p[0]][0] for p in pairs])
    zb = torch.stack([zeta[p[1]][1] for p in pairs])
    A, B = ab_fn(rij.expand_as(za), za, zb, km)           # (K, pairs, ...)
    out = []
    for la, lb, pi, pair, sign in combos:
        i = pairs.index(pair)
        v = (_prefactor(na, la, nb, lb, pi, za[i], zb[i], rij)
             * sum_fn(overlap_coeffs(na, la, nb, lb, pi), A[:, i], B[:, i]))
        out.append(-v if sign < 0 else v)
    return tuple(out)


def _ab_plain(rij, za, zb, km):
    return (torch.stack(a_integrals_n(0.5 * rij * (za + zb), km)),
            torch.stack(b_integrals_n(0.5 * rij * (za - zb), km)))


def _sum_plain(c, A, B):
    s = torch.zeros_like(A[0])
    for k in range(c.shape[0]):
        for l in range(c.shape[1]):
            if c[k, l] != 0.0:
                s = s + float(c[k, l]) * (A[k] * B[l])
    return s


def s_combinations_general(na: int, nb: int, rij, zsi, zpi, zsj, zpj,
                           n: int = 5):
    """(S111, S211, S121, S221, S222) for one (na, nb) class, the
    contract of overlap._s_combinations, via the generated coefficients;
    ``n`` < 5 returns the first n (an s-only lighter atom needs 2)."""
    return _class_combinations(na, nb, rij, zsi, zpi, zsj, zpj, n,
                               _ab_plain, _sum_plain)


# ---------------------------------------------------------------------------
# double-float (hi, lo) evaluation: the float32 production chain
# ---------------------------------------------------------------------------

def _a_integrals_n_tf(x0: TwoFloat, kmax: int):
    """A_k in double-float (cf. overlap.a_integrals_tf, any k)."""
    mask = x0.hi != 0.0
    x = TwoFloat(torch.where(mask, x0.hi, torch.full_like(x0.hi, 1.0e4)),
                 torch.where(mask, x0.lo, torch.zeros_like(x0.lo)))
    u = tf_recip(x)
    e = _exp_tf2(-x)
    a = [e * u]
    for k in range(1, kmax + 1):
        a.append(a[0] + float(k) * (a[-1] * u))
    return a


@functools.lru_cache(maxsize=None)
def _taylor_table(kmax: int, terms: int):
    """B_k's Taylor coefficients for k = 0..kmax in Horner order (highest
    power of x^2 first), shorter series padded with leading zeros, and
    which series are odd in x."""
    rows = [[c for _, c in _taylor_coefs(k, terms)] for k in range(kmax + 1)]
    width = max(len(r) for r in rows)
    tab = np.zeros((kmax + 1, width))
    for k, r in enumerate(rows):
        tab[k, width - len(r):] = r[::-1]
    return tab, np.array([k % 2 == 1 for k in range(kmax + 1)])


def _tf_column(v: np.ndarray, like: torch.Tensor) -> TwoFloat:
    """(K,) constants as a TwoFloat in like's dtype (hi = round(v), lo =
    round(v - hi)) that broadcasts along like's dimensions: (K, 1, ...)."""
    npdt = np.float32 if like.dtype == torch.float32 else np.float64
    hi = v.astype(npdt)
    lo = (v - hi.astype(np.float64)).astype(npdt)
    shape = (len(v),) + (1,) * like.dim()
    return TwoFloat(*(torch.as_tensor(a, device=like.device).reshape(shape)
                      for a in (hi, lo)))


def _b_integrals_n_tf(x0: TwoFloat, kmax: int, taylor_terms: int = 16):
    """B_k in double-float: the exact recursion for |x| > 0.5, the 16-term
    Taylor series otherwise, every k's Horner scheme in x^2 at once
    (cf. overlap.b_integrals_tf).  Returns (K, ...) TwoFloat stacks."""
    hi0 = x0.hi
    absx = torch.abs(hi0)
    exact = absx > 0.5
    zero = torch.zeros_like(hi0)

    xs_hi = torch.clamp(torch.where(exact, hi0, torch.ones_like(hi0)),
                        -85.0, 85.0)
    xs_lo = torch.where(exact & (absx <= 85.0), x0.lo, zero)
    xe = TwoFloat(xs_hi, xs_lo)
    u = tf_recip(xe)
    ep = _exp_tf2(xe)
    em = tf_recip(ep)
    tx = ep * u
    tmx = -(em * u)
    be = [tx + tmx]
    for k in range(1, kmax + 1):
        sgn = tx if k % 2 == 0 else -tx
        be.append(sgn + tmx + float(k) * (be[-1] * u))

    xt = TwoFloat(torch.where(exact, zero, hi0), torch.where(exact, zero,
                                                             x0.lo))
    x2 = xt * xt
    tab, odd = _taylor_table(kmax, taylor_terms)
    acc = _tf_column(tab[:, 0], hi0) + zero
    for j in range(1, tab.shape[1]):
        acc = acc * x2 + _tf_column(tab[:, j], hi0)
    odd = torch.as_tensor(odd, device=hi0.device).reshape(
        (-1,) + (1,) * hi0.dim())
    acc = acc * TwoFloat(torch.where(odd, xt.hi, torch.ones_like(xt.hi)),
                         torch.where(odd, xt.lo, torch.zeros_like(xt.lo)))
    return _Stack(*_where_tf(exact, _stack_tf(be), acc))


def _stack_tf(xs):
    return _Stack(torch.stack([x.hi for x in xs]),
                  torch.stack([x.lo for x in xs]))


def _ab_tf(rij, za, zb, km):
    A = _a_integrals_n_tf(_arg_tf(rij, za, zb, 1.0), km)
    return _stack_tf(A), _b_integrals_n_tf(_arg_tf(rij, za, zb, -1.0), km)


class _Stack(TwoFloat):
    """A (K, ...) TwoFloat stack; [:, i] slices both parts."""

    def __getitem__(self, idx):
        return _Stack(self.hi[idx], self.lo[idx])


def _sum_tf(c, A, B):
    """sum c[k,l] A_k B_l in double-float, the products of every nonzero
    coefficient at once, the sum in (k, l) order."""
    kk, ll = np.nonzero(c)
    t = (TwoFloat(A.hi[kk], A.lo[kk]) * TwoFloat(B.hi[ll], B.lo[ll])
         * _tf_column(c[kk, ll], A.hi[0]))
    s = TwoFloat(t.hi[0], t.lo[0])
    for i in range(1, len(kk)):
        s = s + TwoFloat(t.hi[i], t.lo[i])
    return s.value()


class _SGeneralTf(torch.autograd.Function):
    """Double-float primal, plain-chain gradient (counterpart of the JAX
    package's custom_jvp ``_make_s_combinations_general_tf``; the policy
    of overlap._STf).  Under ``create_graph`` the gradient is taken on the
    saved inputs with their graph, so it carries the plain chain's second
    derivative; otherwise on detached copies."""

    @staticmethod
    def forward(ctx, na, nb, n, rij, zsi, zpi, zsj, zpj):
        ctx.cls = (na, nb)
        ctx.n = n
        ctx.save_for_backward(rij, zsi, zpi, zsj, zpj)
        return _class_combinations(na, nb, rij, zsi, zpi, zsj, zpj, n,
                                   _ab_tf, _sum_tf)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        higher = torch.is_grad_enabled()
        need = ctx.needs_input_grad[3:8]
        ins = (list(saved) if higher else
               [t.detach().requires_grad_(n) for t, n in zip(saved, need)])
        grads = [None] * 5
        with torch.enable_grad():
            outs = s_combinations_general(*ctx.cls, *ins, n=ctx.n)
            pairs = [(o, g) for o, g in zip(outs, gs)
                     if o.requires_grad and g is not None]
            want = [t for t, n in zip(ins, need) if n]
            if pairs and want:
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], want, [g for _, g in pairs],
                    allow_unused=True, create_graph=higher))
                grads = [next(got) if n else None for n in need]
        return (None, None, None, *grads)


def s_combinations_general_tf(na: int, nb: int, rij, zsi, zpi, zsj, zpj,
                              n: int = 5):
    """s_combinations_general with the A/B chain and the coefficient sums
    in double-float (float32 inputs); its gradient is the plain chain's."""
    return _SGeneralTf.apply(na, nb, n, rij, zsi, zpi, zsj, zpj)
