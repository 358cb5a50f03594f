"""Semiempirical parameter tables (MNDO / AM1 / PM3).

PyTorch counterpart of ``pyseqm_tpu/parameters.py``.  The published MOPAC
tables ship as .npz files under ``pyseqm_tpu_torch/params`` (the port's own
copy) and load into element-indexed tensors; per-atom parameter sets are
gathered from them, with user/ML-supplied ("learned") overrides merged in
(cf. the reference Pack_Parameters, seqm/basics.py:120-154).
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .constants import resolve_device

_PARAM_DIR = os.path.join(os.path.dirname(__file__), "params")

# Per-method parameter name lists (cf. reference basics.py:14-29).
PARAMETER_LIST = {
    "MNDO": [
        "U_ss", "U_pp", "zeta_s", "zeta_p", "beta_s", "beta_p",
        "g_ss", "g_sp", "g_pp", "g_p2", "h_sp", "alpha",
    ],
    "AM1": [
        "U_ss", "U_pp", "zeta_s", "zeta_p", "beta_s", "beta_p",
        "g_ss", "g_sp", "g_pp", "g_p2", "h_sp", "alpha",
        "Gaussian1_K", "Gaussian2_K", "Gaussian3_K", "Gaussian4_K",
        "Gaussian1_L", "Gaussian2_L", "Gaussian3_L", "Gaussian4_L",
        "Gaussian1_M", "Gaussian2_M", "Gaussian3_M", "Gaussian4_M",
    ],
    "PM3": [
        "U_ss", "U_pp", "zeta_s", "zeta_p", "beta_s", "beta_p",
        "g_ss", "g_sp", "g_pp", "g_p2", "h_sp", "alpha",
        "Gaussian1_K", "Gaussian2_K",
        "Gaussian1_L", "Gaussian2_L",
        "Gaussian1_M", "Gaussian2_M",
    ],
}


def tables_from_numpy(tables: Mapping[str, np.ndarray], device="cuda",
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Element tables from numpy arrays (e.g. the JAX package's tables)."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in tables.items()}


def load_element_tables(method: str = "AM1", device="cuda",
                        dtype=torch.float32,
                        param_dir: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
    """Element-indexed parameter tables: name -> (108,) tensor indexed by Z."""
    method = method.upper()
    if method not in PARAMETER_LIST:
        raise ValueError(f"method must be one of {list(PARAMETER_LIST)}, got {method}")
    with np.load(os.path.join(param_dir or _PARAM_DIR,
                              f"{method.lower()}.npz")) as d:
        arrays = {k: d[k] for k in PARAMETER_LIST[method]}
    return tables_from_numpy(arrays, device, dtype)


def gather_atom_parameters(
    tables: Mapping[str, torch.Tensor],
    method: str,
    Z: torch.Tensor,
    learned: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Per-atom parameter dict for atomic numbers ``Z`` (any shape).

    ``learned`` entries (same shape as Z, or broadcastable) override the
    table values; names not in the method's parameter list (e.g. "Kbeta",
    "g_ss_nuc") pass through untouched so ML hooks can add them.
    """
    learned = dict(learned or {})
    out: Dict[str, torch.Tensor] = {}
    for name in PARAMETER_LIST[method.upper()]:
        if name in learned:
            out[name] = learned.pop(name)
        else:
            out[name] = tables[name][Z]
    out.update(learned)  # pass-through extras (Kbeta, g_ss_nuc, ...)
    return out
