"""Trajectory and structure I/O: the extended-xyz dump and xyz reading.

PyTorch counterpart of ``pyseqm_tpu/utils/io.py``: the reference's dump
format (MolecularDynamics.py:300-320) and the xyz input of its scale test
(tests/test10/test10.py).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..constants import ELEMENT_LABELS

_SYMBOL_TO_Z = {s.strip(): z for z, s in enumerate(ELEMENT_LABELS)}


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def read_xyz(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a single-frame xyz file: (species (N,), coordinates (N, 3))."""
    with open(path) as f:
        n = int(f.readline().split()[0])
        f.readline()
        species = np.zeros(n, dtype=np.int64)
        coords = np.zeros((n, 3))
        for i in range(n):
            parts = f.readline().split()
            sym = parts[0]
            species[i] = (int(sym) if sym.isdigit()
                          else _SYMBOL_TO_Z.get(sym, 0))
            coords[i] = [float(x) for x in parts[1:4]]
    return species, coords


def dump_frame(prefix: str, species, state, obs, molids: Sequence[int] = (0,),
               forces=None):
    """Append one extended-xyz frame per selected molecule to
    ``{prefix}.{mol}.xyz``: coordinates, velocities, forces (zeros when
    not given) and the Mulliken charge of every atom, the reference's
    full column set (MolecularDynamics.py:300-320).  ``state`` carries
    coordinates, velocities and step; ``obs`` T, Ek, Epot and charges."""
    species = _host(species)
    x = _host(state.coordinates)
    v = _host(state.velocities)
    q = _host(obs.charges)
    T, Ek, Ep = _host(obs.T), _host(obs.Ek), _host(obs.Epot)
    fz = np.zeros_like(x) if forces is None else _host(forces)
    for mol in molids:
        natom = int((species[mol] > 0).sum())
        with open(f"{prefix}.{mol}.xyz", "a+") as f:
            f.write(f"{natom}\n")
            f.write(f"step: {int(state.step)}, T={float(T[mol]):.3f}K, "
                    f"Ek={float(Ek[mol]):.16e}, Ep={float(Ep[mol]):.16e}\n")
            for a in range(species.shape[1]):
                z = species[mol, a]
                if z > 0:
                    f.write("%2s % .10e % .10e % .10e % .10e % .10e % .10e"
                            " % .10e % .10e % .10e % .6f\n"
                            % (ELEMENT_LABELS[z].strip(),
                               x[mol, a, 0], x[mol, a, 1], x[mol, a, 2],
                               v[mol, a, 0], v[mol, a, 1], v[mol, a, 2],
                               fz[mol, a, 0], fz[mol, a, 1], fz[mol, a, 2],
                               q[mol, a]))
