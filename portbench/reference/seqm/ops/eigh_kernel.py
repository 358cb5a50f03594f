"""The reference solves every Fock matrix with torch.linalg.eigh: no
Jacobi semantics (``supported`` is always False), so ``sym_eig`` takes its
exact branch at any size and dtype."""
from __future__ import annotations

OFF_TOL = 1.0e-12


def supported(n: int, dtype) -> bool:
    return False


def eigh_batched_checked(A):
    raise RuntimeError("the reference solves with torch.linalg.eigh")
