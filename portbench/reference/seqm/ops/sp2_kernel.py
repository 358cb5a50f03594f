"""SP2 purification in plain torch: the algorithm of the port's purifier
kernel (``sp2_purify_reference`` there), step by step, at any dtype.

P = 2 * purify(a0) for a batch of pre-scaled iterates a0 = (hN I - F) /
(hN - h1).  Each iteration takes X^2 or 2X - X^2, whichever trace lands
nearer nocc; a molecule stops when e0 < eps and not e0 < e2 (eps floored
at 1e-5); then one McWeeny step 3X^2 - 2X^3 runs and the result is 2X.
"""
from __future__ import annotations

import torch

MAX_ITER = 100
MAX_N = 128
EPS_FLOOR = 1.0e-5


def sp2_purify(a0: torch.Tensor, nocc: torch.Tensor, eps: float = 1.0e-4,
               return_iters: bool = False):
    eps = float(max(eps, EPS_FLOOR))
    X = a0
    tr = torch.diagonal(X, dim1=-2, dim2=-1).sum(dim=-1)
    e0 = torch.abs(tr - nocc)
    e1, e2 = e0, e0
    notconv = torch.ones_like(nocc)
    iters = torch.zeros(nocc.shape, dtype=torch.int32, device=nocc.device)
    for _ in range(MAX_ITER):
        if not bool((notconv > 0.0).any()):
            break
        X2 = X @ X
        tr2 = (X * X).sum(dim=(-2, -1))
        take = (torch.abs(tr2 - nocc)
                < torch.abs(2.0 * tr - tr2 - nocc)).to(X.dtype)
        s = notconv * (2.0 * take - 1.0)
        X = X + s[:, None, None] * (X2 - X)
        tr_new = take * tr2 + (1.0 - take) * (2.0 * tr - tr2)
        tr = tr + notconv * (tr_new - tr)
        e0n = e0 + notconv * (torch.abs(tr - nocc) - e0)
        e1n = e1 + notconv * (e0 - e1)
        e2n = e2 + notconv * (e1 - e2)
        e0, e1, e2 = e0n, e1n, e2n
        iters = iters + (notconv > 0.0).to(torch.int32)
        lt_eps = (e0 < eps).to(X.dtype)
        lt_e2 = (e0 < e2).to(X.dtype)
        notconv = notconv * (1.0 - lt_eps * (1.0 - lt_e2))
    X2 = X @ X
    P = 2.0 * (3.0 * X2 - 2.0 * (X @ X2))
    return (P, iters) if return_iters else P
