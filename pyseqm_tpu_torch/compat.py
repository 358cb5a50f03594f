"""Migration shim for reference-PYSEQM users.

PyTorch counterpart of ``pyseqm_tpu/compat.py``: converts the reference's
``seqm_parameters`` dict (doc/documentation.md:35-51 and the module-level
globals of scf_loop.py:16-27) into the typed :class:`SEQMConfig`, so
existing configurations port one to one:

    cfg = from_seqm_parameters({
        'method': 'AM1', 'scf_eps': 1e-6, 'scf_converger': [2],
        'sp2': [True, 1e-5], 'elements': [0,1,6,8], 'learned': [],
        'pair_outer_cutoff': 1e10, 'eig': True, 'scf_backward': 1,
    })

A key the shim does not know raises ValueError: a misspelt or unsupported
setting would otherwise run with the default unnoticed (the JAX package's
shim drops such keys).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .constants import MAX_Z
from .models.energy import SEQMConfig
from .parameters import PARAMETER_LIST
from .scf import SCFConfig

_HOOKS = ("Kbeta", "g_ss_nuc")
KNOWN_KEYS = frozenset((
    "method", "scf_eps", "scf_converger", "sp2", "scf_backward",
    "scf_backward_eps", "Hf_flag", "pair_outer_cutoff", "eig",
    # accepted and checked, with nothing to set: the tables cover every
    # element, and learned parameters come with each call (``learned=``)
    "elements", "learned",
))


def from_seqm_parameters(sp: Mapping) -> SEQMConfig:
    unknown = sorted(set(sp) - KNOWN_KEYS)
    if unknown:
        raise ValueError(f"unknown seqm_parameters keys {unknown}; known: "
                         f"{sorted(KNOWN_KEYS)}")
    method = sp.get("method", "AM1")
    elements = np.asarray(sp.get("elements", [0]))
    if ((elements < 0) | (elements > MAX_Z)).any():
        raise ValueError(f"elements {elements.tolist()} outside 0..{MAX_Z}")
    names = set(PARAMETER_LIST.get(str(method).upper(), ())) | set(_HOOKS)
    bad = sorted(set(sp.get("learned", [])) - names)
    if bad:
        raise ValueError(f"learned parameters {bad} are not {method} "
                         "parameters or learned hooks")
    converger = tuple(sp.get("scf_converger", [2]))
    sp2 = sp.get("sp2", [False])
    scf = SCFConfig(
        eps=float(sp.get("scf_eps", 1.0e-4)),
        converger=converger,
        use_sp2=bool(sp2[0]),
        sp2_eps=float(sp2[1]) if len(sp2) > 1 else 1.0e-4,
        backward=int(sp.get("scf_backward", 0)),
        backward_eps=float(sp.get("scf_backward_eps", 1.0e-2)),
    )
    return SEQMConfig(
        method=method,
        scf=scf,
        hf_flag=bool(sp.get("Hf_flag", True)),
        pair_outer_cutoff=float(sp.get("pair_outer_cutoff", 1.0e10)),
        eig=bool(sp.get("eig", False)),
    )
