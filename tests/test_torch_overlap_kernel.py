"""The overlap kernel's route and surroundings on the CPU: which tensors
take the kernel (``overlap_kernel.supported``), that a CPU float32 call
runs the double-float chain and counts its cells as
``overlap.plain_cells``, the strides the wrapper hands the kernel for
broadcast and expanded inputs, and the kernel's arithmetic (FP64 A/B
brackets, float32 prefactors, one rounding) emulated in torch against the
double-float chain, within one float32 ulp where that chain is itself
within one.  The kernel itself runs in
tests/test_torch_cuda.py."""
import math

import numpy as np
import pytest
import torch
from torch.profiler import profile

from pyseqm_tpu_torch.ops import overlap as tov
from pyseqm_tpu_torch.ops import overlap_kernel
from pyseqm_tpu_torch.utils import timing

torch.set_num_threads(1)
SQRT3 = tov.SQRT3


@pytest.mark.parametrize("device,dtype,kernel", [
    ("cpu", torch.float32, False),
    ("cpu", torch.float64, False),
    ("cuda", torch.float64, False),
    ("cuda", torch.float32, True),
    ("cuda:1", torch.float32, True),
])
def test_route(device, dtype, kernel):
    assert overlap_kernel.supported(torch.device(device), dtype) is kernel


def _segment_cells(mode, nmol=6, K=2, AH=5, seed=0):
    """Overlap inputs shaped as hcore_dense_split's call sites pass them
    for segment ``mode`` (4 the heavy block, 3 the X-H block with expanded
    per-atom exponents, 2 the H-H block), masked cells at rij = 1."""
    rng = np.random.RandomState(seed)
    A = K + AH
    zeta = torch.from_numpy(rng.uniform(0.8, 3.0, (nmol, A, 2))).float()
    qn = torch.from_numpy(np.concatenate(
        [rng.choice([1, 2], (nmol, K)), np.ones((nmol, AH), int)], 1))
    r = torch.from_numpy(rng.uniform(1.2, 9.0, (nmol, A, A))).float()
    r = torch.where(torch.from_numpy(rng.rand(nmol, A, A) < 0.2),
                    torch.ones_like(r), r)
    sH, sL = slice(0, K), slice(K, A)
    if mode == 4:
        qni = qn[:, sH, None].expand(nmol, K, K)
        qnj = qn[:, None, sH].expand(nmol, K, K)
        one = torch.ones_like(r[:, sH, sH])
        zs = (zeta[:, sH, None, 0].expand(nmol, K, K),
              torch.where(qni > 1, zeta[:, sH, None, 1], one),
              zeta[:, None, sH, 0].expand(nmol, K, K),
              torch.where(qnj > 1, zeta[:, None, sH, 1], one))
        return (r[:, sH, sH], *zs, (qni == 1) & (qnj == 1),
                (qni == 2) & (qnj == 1), (qni == 2) & (qnj == 2))
    if mode == 3:
        qni = qn[:, sH, None].expand(nmol, K, AH)
        qnj = qn[:, None, sL].expand(nmol, K, AH)
        zi = zeta[:, sH, None, :].expand(nmol, K, AH, 2)
        j3 = (qni == 2) & (qnj == 1)
        return (r[:, sH, sL], zi[..., 0], zi[..., 1],
                zeta[:, None, sL, 0].expand(nmol, K, AH),
                torch.ones_like(r[:, sH, sL]), (qni == 1) & (qnj == 1), j3,
                torch.zeros_like(j3))
    qni = qn[:, sL, None].expand(nmol, AH, AH)
    never = torch.zeros_like(qni, dtype=torch.bool)
    one = torch.ones_like(r[:, sL, sL])
    return (r[:, sL, sL], zeta[:, sL, None, 0].expand(nmol, AH, AH), one,
            zeta[:, None, sL, 0].expand(nmol, AH, AH), one,
            (qni == 1) & (qn[:, None, sL] == 1), never, never)


@pytest.mark.parametrize("mode", [2, 3, 4])
def test_cpu_float32_takes_plain_chain_and_counts(mode):
    ins = _segment_cells(mode)
    n = math.prod(torch.broadcast_shapes(*(t.shape for t in ins)))
    launches = overlap_kernel.launches
    timing.reset()
    with profile():
        with timing.span("integrals"):
            got = tov._s_combinations_tf(*ins, mode=mode)
    rec, = [r for r in timing.spans() if r.name == "integrals"]
    timing.reset()
    assert rec.counts == {"overlap.plain_cells": n}
    assert overlap_kernel.launches == launches
    want = tov._s_combinations(*ins, True, mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["flat", "xx", "xh", "hh", "lower_rank",
                                  "five_dims"])
def test_layout_strides_reach_every_cell(case):
    """Each input seen through the sizes and strides the wrapper hands
    the kernel (row-major over the merged dimensions, offsets from the
    input's own storage offset) holds its broadcast values, cell for
    cell; contiguous inputs merge into one dimension, expanded ones keep
    their stride-0 dimensions."""
    if case in ("xx", "xh", "hh"):
        ins = list(_segment_cells({"xx": 4, "xh": 3, "hh": 2}[case]))
    elif case == "flat":
        ins = [torch.rand(5, 28) for _ in range(5)] + [
            torch.rand(5, 28) > 0.5 for _ in range(3)]
    elif case == "lower_rank":
        base = torch.rand(3, 7, 9)
        ins = [base[:, 2:6, 1:], torch.rand(8), torch.rand(4, 1),
               torch.rand(3, 4, 8), torch.rand(1, 4, 8),
               torch.rand(3, 4, 8) > 0.5, torch.rand(8) > 0.5,
               torch.ones((), dtype=torch.bool)]
    else:
        ins = [torch.rand(2, 3, 1, 3, 5)[..., ::2]] + [
            torch.rand(2, 1, 2, 3, 3) for _ in range(4)] + [
            torch.rand(2, 3, 2, 3, 3) > 0.5 for _ in range(3)]
    shape, sizes, strides = overlap_kernel.layout(ins)
    if case == "five_dims":
        # more than the kernel takes: the wrapper raises before a launch
        assert len(sizes) > overlap_kernel.MAX_DIM
        with pytest.raises(ValueError, match="dimensions"):
            overlap_kernel.s_combinations(4, *ins)
        return
    assert len(sizes) <= overlap_kernel.MAX_DIM
    assert math.prod(sizes) == math.prod(shape)
    if case == "flat":
        assert sizes == [140]
    for t, st, v in zip(ins, strides, torch.broadcast_tensors(*ins)):
        seen = t.as_strided(sizes, st)
        assert torch.equal(seen.reshape(-1), v.reshape(-1))


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated: FP64 brackets, float32 prefactors,
# each output rounded once (csrc/overlap.cu)
# ---------------------------------------------------------------------------

def _a_f64(x):
    xh = x.float()
    dead = (xh == 0.0) | (xh > 103.97)
    x = torch.where(dead, torch.ones_like(x), x)
    u = 1.0 / x
    a1 = torch.exp(-x) * u
    a2 = a1 + a1 * u
    a3 = a1 + 2.0 * (a2 * u)
    a4 = a1 + 3.0 * (a3 * u)
    a5 = a1 + 4.0 * (a4 * u)
    return [torch.where(dead, torch.zeros_like(a), a)
            for a in (a1, a2, a3, a4, a5)]


def _b_f64(x):
    ah = x.float().abs()
    exact, taylor = ah > 0.5, (ah <= 0.5) & (ah > 1.0e-6)
    xs = torch.where(ah > 85.0, torch.sign(x) * 85.0, x)
    xs = torch.where(exact, xs, torch.ones_like(x))
    u = 1.0 / xs
    ep = torch.exp(xs)
    tx, tmx = ep * u, -(u / ep)
    e1 = tx + tmx
    e2 = -tx + tmx + e1 * u
    e3 = tx + tmx + 2.0 * (e2 * u)
    e4 = -tx + tmx + 3.0 * (e3 * u)
    e5 = tx + tmx + 4.0 * (e4 * u)
    x2 = x * x
    t1 = ((x2 / 2520.0 + 1.0 / 60.0) * x2 + 1.0 / 3.0) * x2 + 2.0
    t2 = -(x * ((x2 / 420.0 + 1.0 / 15.0) * x2 + 2.0 / 3.0))
    t3 = ((x2 / 3240.0 + 1.0 / 84.0) * x2 + 1.0 / 5.0) * x2 + 2.0 / 3.0
    t4 = -(x * ((x2 / 540.0 + 1.0 / 21.0) * x2 + 2.0 / 5.0))
    t5 = ((x2 / 3960.0 + 1.0 / 108.0) * x2 + 1.0 / 7.0) * x2 + 2.0 / 5.0
    lim = (2.0, 0.0, 2.0 / 3.0, 0.0, 2.0 / 5.0)
    return [torch.where(exact, e, torch.where(taylor, t, torch.full_like(
        x, c))) for e, t, c in zip((e1, e2, e3, e4, e5),
                                    (t1, t2, t3, t4, t5), lim)]


def _ab_f64(rij, z1, z2):
    r = 0.5 * rij.double()
    a, b = z1.double(), z2.double()
    return _a_f64(r * (a + b)), _b_f64(r * (a - b))


def _emulate(mode, rij, zsi, zpi, zsj, zpj, j2, j3, j4):
    """The kernel's outputs, with the chain's division by a Python number
    as the CPU chain computes it (the kernel multiplies by the float32
    reciprocal, as the chain does on the card)."""
    p15, p25 = tov._p15, tov._p25
    once = lambda w, v: (w.double() * v).float()          # noqa: E731
    r2 = rij * rij
    r4 = r2 * r2
    r5 = r4 * rij
    zero = torch.zeros_like(rij)
    j3 = j3 & (mode >= 3)
    j4 = j4 & (mode >= 4)
    A, B = _ab_f64(rij, zsi, zsj)
    s2 = once(p15(zsi * zsj * r2) / 4.0, A[2] * B[0] - B[2] * A[0])
    s3 = once(p15(zsj) * p25(zsi) * r4 / (SQRT3 * 8.0),
              A[3] * B[0] - B[3] * A[0] + A[2] * B[1] - B[2] * A[1])
    s4 = once(p25(zsj * zsi) * r5 / 48.0,
              A[4] * B[0] + B[4] * A[0] - 2.0 * (A[2] * B[2]))
    S111 = torch.where(j2, s2, torch.where(j3, s3, torch.where(j4, s4, zero)))
    A, B = _ab_f64(rij, zpi, zsj)
    s3 = once(p15(zsj) * p25(zpi) * r4 / 8.0,
              A[2] * B[0] - B[2] * A[0] + A[3] * B[1] - B[3] * A[1])
    s4 = once(p25(zsj * zpi) * r5 / (16.0 * SQRT3),
              A[3] * (B[0] - B[2]) - A[1] * (B[2] - B[4])
              + B[3] * (A[0] - A[2]) - B[1] * (A[2] - A[4]))
    S211 = torch.where(j3, s3, torch.where(j4, s4, zero))
    A, B = _ab_f64(rij, zsi, zpj)
    s4 = once(p25(zpj * zsi) * r5 / (16.0 * SQRT3),
              A[3] * (B[0] - B[2]) - A[1] * (B[2] - B[4])
              - B[3] * (A[0] - A[2]) + B[1] * (A[2] - A[4]))
    S121 = torch.where(j4, s4, zero)
    A, B = _ab_f64(rij, zpi, zpj)
    wf = p25(zpj * zpi) * r5 / 16.0
    S221 = torch.where(j4, once(-wf, B[2] * (A[4] + A[0])
                                - A[2] * (B[4] + B[0])), zero)
    S222 = torch.where(j4, once(0.5 * wf, A[4] * (B[0] - B[2])
                                - B[4] * (A[0] - A[2]) - A[2] * B[0]
                                + B[2] * A[0]), zero)
    return S111, S211, S121, S221, S222


def ulps(a, b):
    """Distance in float32 units in the last place (+0 and -0 alike)."""
    def ordered(x):
        i = x.detach().float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _random_cells(n=4000, seed=3):
    """Every class at random distances and exponents, with padding cells
    (rij = 1), zero exponents (a zero A argument) and equal exponents (the
    B limit) among them."""
    rng = np.random.RandomState(seed)
    qni = rng.choice([1, 2], n)
    qnj = np.minimum(qni, rng.choice([1, 2], n))
    r = rng.uniform(0.8, 12.0, n)
    z = rng.uniform(0.5, 3.5, (4, n))
    r[:200] = 1.0
    z[:, 200:300] = 0.0
    z[2, 300:400] = z[0, 300:400]
    z[3, 300:400] = z[1, 300:400]
    t = lambda v: torch.from_numpy(v).float()            # noqa: E731
    q = lambda v: torch.from_numpy(v)                     # noqa: E731
    return (t(r), *map(t, z), q((qni == 1) & (qnj == 1)),
            q((qni == 2) & (qnj == 1)), q((qni == 2) & (qnj == 2)))


@pytest.mark.parametrize("mode", [2, 3, 4])
def test_emulated_kernel_within_one_ulp_of_chain(mode):
    ins = _random_cells()
    chain = tov._s_combinations(*ins, True, mode)
    exact = tov._s_combinations(*[t.double() if t.is_floating_point() else t
                                  for t in ins], False, mode)
    got = _emulate(mode, *ins)
    for k, (g, c, e) in enumerate(zip(got, chain, exact)):
        # within 1 ulp of the chain, or, where the chain's own error
        # passes an ulp, within 1 ulp of float64 and nearer than the chain
        near = ulps(g, c) <= 1
        nearer = (((g.double() - e).abs() <= (c.double() - e).abs())
                  & (ulps(g, e.float()) <= 1))
        assert bool((near | nearer).all()), k
        assert int((~near).sum()) <= g.numel() // 1000, k
        assert torch.equal(g == 0, c == 0), k
        assert bool(torch.isfinite(g).all())
        # the bar of test_torch_integrals' f32 values against float64
        assert float((g.double() - e).abs().max()) <= 3.0e-7, k
