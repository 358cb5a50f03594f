"""Physical and element constants for NDDO semiempirical methods.

PyTorch counterpart of ``pyseqm_tpu/constants.py``: the published MOPAC7
constant tables (cf. the reference seqm/seqm_functions/constants.py:1-141)
held as element-indexed tensors on one device.

Units inside the library: Bohr for lengths (inputs in Angstrom are converted
with 1/A0), eV for energies, fs for time, Kelvin for temperature.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

# MOPAC7 values (intentionally not the CODATA ones, for parity with MOPAC).
EV = 27.21  # 1 hartree in eV
A0 = 0.529167  # Bohr radius in Angstrom
EV_KCALPMOL = 23.061  # 1 eV in kcal/mol
LENGTH_CONVERSION_FACTOR = 1.0 / A0  # Angstrom -> Bohr

# Pair overlap is neglected beyond this distance (Bohr);
# cf. reference constants.py:16
OVERLAP_CUTOFF = 40.0

# element symbols by atomic number (xyz input and trajectory dumps)
ELEMENT_LABELS = [
    "0",
    "H", "He",
    "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
]

MAX_Z = 18  # element tables below cover H..Ar (rows 1-3)

# fmt: off
# valence-shell core charge per element
_TORE = [0.0,
         1.0,                                     0.0,
         1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0,      0.0,
         1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0,      0.0]
# principal quantum number of the valence shell
_QN = [0,
       1,                         0,
       2, 2, 2, 2, 2, 2, 2,       0,
       3, 3, 3, 3, 3, 3, 3,       0]
# occupation coefficients of the isolated-atom ground state used for Eiso
# (cf. MOPAC block.f / reference constants.py:69-105)
_USSC = [0.0,
         1.0,                                     0.0,
         1.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0,      0.0,
         1.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0,      0.0]
_UPPC = [0.0,
         0.0,                                     0.0,
         0.0, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0,      6.0,
         0.0, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0,      6.0]
_GSSC = [0.0,
         0.0,                                     0.0,
         0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,      0.0,
         0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,      0.0]
_GSPC = [0.0,
         0.0,                                     0.0,
         0.0, 0.0, 2.0, 4.0, 6.0, 8.0, 10.0,     0.0,
         0.0, 0.0, 2.0, 4.0, 6.0, 8.0, 10.0,     0.0]
_HSPC = [0.0,
         0.0,                                     0.0,
         0.0, 0.0, -1.0, -2.0, -3.0, -4.0, -5.0, 0.0,
         0.0, 0.0, -1.0, -2.0, -3.0, -4.0, -5.0, 0.0]
_GP2C = [0.0,
         0.0,                                     0.0,
         0.0, 0.0, 0.0, 1.5, 4.5, 6.5, 10.0,     0.0,
         0.0, 0.0, 0.0, 1.5, 4.5, 6.5, 10.0,     0.0]
_GPPC = [0.0,
         0.0,                                     0.0,
         0.0, 0.0, 0.0, -0.5, -1.5, -0.5, 0.0,   0.0,
         0.0, 0.0, 0.0, -0.5, -1.5, -0.5, 0.0,   0.0]
# experimental heats of formation of the isolated atoms, kcal/mol
_EHEAT_KCAL = [0.000,
               52.102,                                                    0.0,
               38.410, 76.960, 135.700, 170.890, 113.000, 59.559, 18.890, 0.0,
               25.850, 35.000, 79.490, 108.390, 75.570, 66.400, 28.990,  0.0]
# atomic masses, g/mol
_MASS = [0.00000,
         1.00790,                                                         4.00260,
         6.94000, 9.01218, 10.81000, 12.01100, 14.00670, 15.99940, 18.99840, 20.17900,
         22.98977, 24.30500, 26.98154, 28.08550, 30.97376, 32.06000, 35.45300, 39.94800]
# fmt: on


def resolve_device(device) -> torch.device:
    """The device a port entry point runs on.  "cuda" (the default of every
    entry point) raises when no GPU is present: nothing falls back to the
    CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyseqm_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return device


def disable_tf32() -> None:
    """Full-f32 products on the card.  TF32's 10-bit mantissa breaks the
    SCF the way the TPU's bf16 default did (NaNs, 0.5 eV errors), and SP2
    doubles dot noise on every linear-phase iteration."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Constants:
    """Element-indexed constant tables; index with atomic numbers:
    ``const.tore[Z]``."""

    tore: torch.Tensor
    qn: torch.Tensor
    qn_int: torch.Tensor
    ussc: torch.Tensor
    uppc: torch.Tensor
    gssc: torch.Tensor
    gspc: torch.Tensor
    hspc: torch.Tensor
    gp2c: torch.Tensor
    gppc: torch.Tensor
    eheat: torch.Tensor  # eV
    mass: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.tore.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tore.dtype


def constants_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda",
                         dtype=torch.float32) -> Constants:
    """Constants from numpy arrays keyed by field name (e.g. the JAX
    package's Constants fields as numpy); ``qn_int`` becomes int64."""
    device = resolve_device(device)
    out = {}
    for f in dataclasses.fields(Constants):
        a = np.array(arrays[f.name])
        dt = torch.long if f.name == "qn_int" else dtype
        out[f.name] = torch.as_tensor(a, dtype=dt, device=device)
    return Constants(**out)


def make_constants(dtype=torch.float32, device="cuda") -> Constants:
    return constants_from_numpy({
        "tore": _TORE, "qn": _QN, "qn_int": _QN, "ussc": _USSC,
        "uppc": _UPPC, "gssc": _GSSC, "gspc": _GSPC, "hspc": _HSPC,
        "gp2c": _GP2C, "gppc": _GPPC,
        "eheat": np.array(_EHEAT_KCAL) / EV_KCALPMOL, "mass": _MASS,
    }, device=device, dtype=dtype)
