"""The double-float STO overlap chain as one CUDA kernel launch per pair
segment (sm_90a), float32.

Replaces no TPU kernel.  The JAX package leaves the chain of
``ops/overlap.py`` (``_s_combinations(..., precise=True)``: the A/B
auxiliary integrals and their alternating-sign combinations in
double-float (hi, lo) float32 arithmetic) to XLA, which fuses it; eager
PyTorch launches each of its operations on its own, 2,300 to 10,200 per
segment.  The kernel (``csrc/overlap.cu``) evaluates the same five
combinations, one thread per cell, with the A/B chain and its brackets in
FP64 registers and the float32 prefactors as the chain computes them on
the card, each output rounded to float32 once: within one float32 ulp of
the chain.  The segment's mode (2, 3 or 4) is a template parameter, and
each cell evaluates only the class and the B regime it selects.

Inputs may be broadcast against each other and may be views with any
strides (the X-H and H-H call sites pass expanded per-atom exponents): the
wrapper hands the kernel each input's strides over the broadcast shape,
after merging the dimensions every input walks contiguously, and copies
no input; more than four dimensions left after the merge raise.  The
five outputs are distinct contiguous float32 tensors of the broadcast
shape.

``s_combinations`` launches the kernel for float32 CUDA tensors and raises
if the build or the launch fails; ``supported`` says which tensors it
takes.  ``ops/overlap.py::_STf`` routes by ``supported``: every other
tensor takes the plain chain ``_s_combinations``, which stays the
kernel's plain version.  The kernel builds at first use with nvcc into
``_build/`` next to this package (``ops/cuda_build.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import torch

from . import cuda_build

SOURCE = "overlap"
MAX_DIM = 4
_ARGTYPES = ([ctypes.c_void_p] * 13
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p])
_NARROW = 2 ** 31

# launches of the CUDA kernel (plain integer; reset by callers that count)
launches = 0


def _load():
    return cuda_build.load(SOURCE, "overlap_f32", _ARGTYPES)


def supported(device, dtype) -> bool:
    """True where the kernel computes the double-float overlap: float32
    tensors on a CUDA device."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


def layout(tensors: Sequence[torch.Tensor]
           ) -> Tuple[Tuple[int, ...], List[int], List[List[int]]]:
    """(broadcast shape, sizes, strides per tensor) of tensors broadcast
    against each other, in elements, with size-1 dimensions dropped and
    neighbouring dimensions merged where every tensor walks them as one
    (its outer stride equals its inner stride times the inner size)."""
    shape = tuple(torch.broadcast_shapes(*(t.shape for t in tensors)))
    views = torch.broadcast_tensors(*tensors)
    dims = [(shape[d], [v.stride(d) for v in views])
            for d in range(len(shape)) if shape[d] != 1]
    merged: List[Tuple[int, List[int]]] = []
    for size, strides in dims:
        if merged and all(so == si * size for so, si
                          in zip(merged[-1][1], strides)):
            merged[-1] = (merged[-1][0] * size, strides)
        else:
            merged.append((size, strides))
    if not merged:
        merged = [(1, [0] * len(tensors))]
    return (shape, [s for s, _ in merged],
            [[st[k] for _, st in merged] for k in range(len(tensors))])


def s_combinations(mode: int, rij, zsi, zpi, zsj, zpj, jcall2, jcall3,
                   jcall4) -> Tuple[torch.Tensor, ...]:
    """(S111, S211, S121, S221, S222) of ``overlap._s_combinations(...,
    precise=True, mode)`` by one kernel launch: float32 CUDA tensors
    (exponents, distances in Bohr) and bool masks, broadcast against each
    other."""
    global launches
    floats = (rij, zsi, zpi, zsj, zpj)
    masks = (jcall2, jcall3, jcall4)
    if mode not in (2, 3, 4):
        raise ValueError(f"overlap kernel: mode 2, 3 or 4, got {mode}")
    tensors = floats + masks
    shape, sizes, strides = layout(tensors)
    if len(sizes) > MAX_DIM:
        raise ValueError(f"overlap kernel: at most {MAX_DIM} dimensions "
                         f"after merging, got sizes {sizes}")
    if not all(supported(t.device, t.dtype) for t in floats):
        raise TypeError("the overlap kernel takes float32 CUDA tensors, "
                        f"got {[(t.dtype, str(t.device)) for t in floats]}")
    if any(m.dtype != torch.bool for m in masks):
        raise TypeError("the overlap kernel takes bool jcall masks, got "
                        f"{[m.dtype for m in masks]}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("overlap kernel: tensors on "
                         f"{sorted(map(str, devices))}")
    n = math.prod(shape)
    outs = tuple(torch.empty(shape, dtype=torch.float32, device=rij.device)
                 for _ in range(5))
    if n == 0:
        return outs
    # the largest element offset any input reaches
    reach = max(sum(st * (sz - 1) for st, sz in zip(strides_k, sizes))
                for strides_k in strides)
    wide = int(n >= _NARROW or reach >= _NARROW)
    ndim = len(sizes)
    c_sizes = (ctypes.c_longlong * ndim)(*sizes)
    c_strides = (ctypes.c_longlong * (len(tensors) * ndim))(
        *[s for st in strides for s in st])
    fn = _load().overlap_f32
    with torch.cuda.device(rij.device):
        rc = fn(*[t.data_ptr() for t in tensors],
                *[o.data_ptr() for o in outs], mode, n, ndim,
                ctypes.addressof(c_sizes), ctypes.addressof(c_strides), wide,
                torch.cuda.current_stream(rij.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"overlap kernel launch failed: CUDA error {rc}")
    launches += 1
    return outs
