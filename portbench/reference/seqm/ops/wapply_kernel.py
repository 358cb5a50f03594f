"""The two-electron apply in plain torch (the port's
``w_apply_reference``): y = U . T_perm(ri)[U^T X U] . U^T over broadcast
leading dimensions, any perm, any device, differentiable by autograd."""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _expansion(perm: Tuple[int, int, int, int]) -> np.ndarray:
    """T (22, 4, 4, 4, 4) permuted to (r, free1, free2, con1, con2)."""
    from .tetci import _ri_expansion_table
    return _ri_expansion_table().transpose((0,) + tuple(perm))


@functools.lru_cache(maxsize=None)
def _t_contract(perm, dtype, device) -> torch.Tensor:
    """(16, 22*16) matrix C with y[f] = sum_r ri[r] (Xloc @ C)[r, f]."""
    T = _expansion(tuple(perm)).reshape(22, 16, 16)
    C = np.ascontiguousarray(T.transpose(2, 0, 1).reshape(16, 22 * 16))
    return torch.as_tensor(C, dtype=dtype, device=device)


def w_apply(ri, U, X, perm):
    Xloc = U.transpose(-1, -2) @ X @ U
    batch = torch.broadcast_shapes(Xloc.shape[:-2], ri.shape[:-1])
    C = _t_contract(tuple(perm), X.dtype, X.device)
    Z = (Xloc.reshape(Xloc.shape[:-2] + (1, 16)) @ C)    # (..., 1, 352)
    Z = Z.reshape(Z.shape[:-2] + (22, 16))
    y = (ri[..., None, :] @ Z).reshape(batch + (4, 4))
    return U @ y @ U.transpose(-1, -2)
