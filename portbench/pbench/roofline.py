"""The least time of the port's three hand-written kernels on one NVIDIA
H100 (SXM, 700 W), from the operations and bytes their inputs need.

A frozen copy of the arithmetic of ``chip_smoke.py`` (``K3_IO``, the K1
bound of phase 5, the K2 bound of ``k2_timing``): each input byte read
once, each output byte written once, the operations the algorithm needs
for these inputs (SP2 iterations, Jacobi sweeps), against the published
peaks.  The least time is the larger of the two.
"""
from __future__ import annotations

# NVIDIA's H100 SXM data sheet: FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67.0e12
PEAK_BYTES = 3.35e12

# K3 per cell: floats read, floats written, floating-point operations
# (csrc/wapply.cu: rotations 240, table 144 forward; 2 rotations in, the
# table passes 432, dX 120, dU 468 backward).  U moves whole in the
# kernels; the values the function needs are what counts here.
K3_IO = {"fwd": (47, 16, 384), "bwd": (63, 47, 1260)}


def least(flops: float, nbytes: float):
    """(seconds, 'operations' or 'bytes')."""
    t_flop, t_byte = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (t_flop, "operations") if t_flop >= t_byte else (t_byte, "bytes")


def k1_least(iterations, n: int, itemsize: int = 4):
    """K1 (SP2 purification) of one launch over a batch: ``iterations``
    one count per molecule.  Per iteration X^2 (2n^3) + ||X||^2 (2n^2) +
    the update (3n^2); McWeeny two products (4n^3) + 3n^2; bytes a0 and
    nocc read, P and the iteration counts written."""
    its = [float(i) for i in iterations]
    B = len(its)
    flops = (sum(its) * (2 * n ** 3 + 5 * n ** 2)
             + B * (4 * n ** 3 + 3 * n ** 2))
    nbytes = 2 * B * n * n * itemsize + 2 * B * 4
    return least(flops, nbytes)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def k2_least(sweeps, n0: int, itemsize: int = 4):
    """K2 (one-sided Jacobi) of one launch over a batch: ``sweeps`` one
    count per molecule.  Per sweep (n - 1) rounds of n/2 pairs; a pair
    needs gamma (2n), both alphas (4n), both column updates (6n) and one
    rotation (~20); around the sweeps the shift, the column norms, e, the
    rank and the normalisation.  Bytes: A read, e, v and resid written."""
    sw = [float(s) for s in sweeps]
    B = len(sw)
    n = next_pow2(n0)
    flops = (sum(sw) * (n - 1) * (n // 2) * (12 * n + 20)
             + B * (n0 * n0 + 8 * n0 + 3 * n * n + 2 * n + n0 * n0))
    nbytes = itemsize * B * (2 * n0 * n0 + n0 + 1)
    return least(flops, nbytes)


def k3_least(kind: str, cells: int, itemsize: int = 4):
    """K3 (the fused two-electron apply), forward or backward, over
    ``cells`` 4x4 cells."""
    nin, nout, flops = K3_IO[kind]
    return least(cells * flops, cells * (nin + nout) * itemsize)
