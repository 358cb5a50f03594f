"""Numerical sanitizers: NaN/Inf detection on values and gradients.

PyTorch counterpart of ``pyseqm_tpu/utils/check.py`` (cf. the reference
seqm/seqm_functions/check.py:5-42): ``check`` raises on the host when a
tensor holds non-finite values, ``stats`` prints its statistics,
``check_gradient`` is an identity whose backward checks the cotangent (the
reference's register_hook), and ``save`` dumps a tensor for offline
inspection.  ``check`` and ``check_gradient`` read the tensor on the host:
one device sync each.
"""
from __future__ import annotations

import numpy as np
import torch


def check(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Raise FloatingPointError, with the count of non-finite elements, if
    ``x`` holds NaN or Inf; returns ``x``."""
    bad = int((~torch.isfinite(x.detach())).sum())
    if bad:
        raise FloatingPointError(f"{name}: {bad} non-finite elements")
    return x


def stats(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Print min, max, mean and std of ``x`` (cf. check_dist); returns
    ``x``."""
    v = x.detach().double()
    print(f"{name}: min={v.min().item()} max={v.max().item()} "
          f"mean={v.mean().item()} std={v.std(unbiased=False).item()}")
    return x


class _CheckedIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return check(x, name).view_as(x)

    @staticmethod
    def backward(ctx, g):
        return check(g, f"grad({ctx.name})"), None


def check_gradient(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Identity that checks ``x`` now and its cotangent in the backward
    (the functional analogue of check.py's register_hook)."""
    return _CheckedIdentity.apply(x, name)


def save(fn: str, x):
    """Dump a tensor to .npy for offline inspection (cf. check.py save)."""
    np.save(fn, x.detach().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x))
