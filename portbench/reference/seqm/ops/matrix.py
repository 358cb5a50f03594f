"""Block-matrix layout helpers.

PyTorch counterpart of ``pyseqm_tpu/ops/matrix.py``.  Matrices live in the
atom-block grid (nmol, A, A, 4, 4), the dense orbital matrix (nmol, 4A, 4A),
or the static packed matrix (nmol, n_st, n_st) of ops/density.py; every
block is stored fully symmetric.
"""
from __future__ import annotations

import torch
import torch.nn.functional as nnf


def grid_to_mat(g):
    nmol, A = g.shape[0], g.shape[1]
    return g.transpose(2, 3).reshape(nmol, 4 * A, 4 * A)


def mat_to_grid(m, A):
    nmol = m.shape[0]
    return m.reshape(nmol, A, 4, A, 4).transpose(2, 3)


def block00(s):
    """(..., 4, 4) blocks holding the scalars s (...) at [0, 0]."""
    return nnf.pad(s[..., None, None], (0, 3, 0, 3))


def col0_block(c):
    """(..., 4, 4) blocks holding the columns c (..., 4) at [:, 0]."""
    return nnf.pad(c[..., None], (0, 3))


def diag_blocks(m, A):
    """(nmol, 4A, 4A) -> (nmol, A, 4, 4) diagonal atom blocks."""
    return torch.diagonal(mat_to_grid(m, A), dim1=1, dim2=2).permute(
        0, 3, 1, 2)


def pair_blocks(m, A, iu, ju):
    """(nmol, 4A, 4A) -> (nmol, NP, 4, 4) upper-triangle atom blocks."""
    return mat_to_grid(m, A)[:, iu, ju]


def assemble_packed_mat(xx_grid, xh_col, hh, hh_diag, n_st):
    """Symmetric matrix in the static packed layout from its class blocks.

    Rows [0, 4K) hold the heavy-atom 4-orbital blocks, rows [4K, 4K+AH) the
    hydrogen s orbitals, so the XH and HH blocks are contiguous and assembly
    is block concatenation.

    xx_grid: (nmol, K, K, 4, 4) heavy-block cells, diagonal cells filled;
    xh_col:  (nmol, K, AH, 4) s-column of each (heavy, H) cell
             (value [i, j, a] lands at [4i+a, 4K+j] and its mirror);
    hh:      (nmol, AH, AH) s-s block (off-diagonal);
    hh_diag: (nmol, AH) its diagonal;
    returns (nmol, n_st, n_st), zero-padded.
    """
    nmol, K, AH = xh_col.shape[0], xh_col.shape[1], xh_col.shape[2]
    xx = xx_grid.transpose(2, 3).reshape(nmol, 4 * K, 4 * K)
    xh = xh_col.transpose(2, 3).reshape(nmol, 4 * K, AH)
    hh = torch.diagonal_scatter(hh, hh_diag, dim1=1, dim2=2)
    top = torch.cat([xx, xh], dim=2)
    bot = torch.cat([xh.transpose(1, 2), hh], dim=2)
    Mp = torch.cat([top, bot], dim=1)
    pad = n_st - (4 * K + AH)
    if pad:
        Mp = nnf.pad(Mp, (0, pad, 0, pad))
    return Mp
