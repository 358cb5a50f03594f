"""Frozen input generators: the benchmark's own copies of the port's test
molecules (``utils/molecules.py``: ``MOLECULES``, ``make_alkane`` and the
round-robin of ``make_batch``), so a later change to the port cannot move
the yardstick.

Geometries and velocities are drawn from a ``torch.Generator`` on the
device the cell runs on, seeded from ``--seed``: the same seed on the same
device gives the same arrays, and the reference regenerates a request's
geometry by the same call.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# (species, coords in Angstrom), species sorted by descending Z
MOLECULES = {
    "CH2O": (
        [8, 6, 1, 1],
        [[0.0, 0.0, 0.0], [1.2273, 0.0, 0.0],
         [1.8195, 0.9394, 0.0], [1.8193, -0.9395, 0.0]],
    ),
    "H2O": (
        [8, 1, 1],
        [[0.0, 0.0, 0.1173], [0.0, 0.7572, -0.4692], [0.0, -0.7572, -0.4692]],
    ),
    "CH4": (
        [6, 1, 1, 1, 1],
        [[0.0, 0.0, 0.0], [0.6276, 0.6276, 0.6276],
         [-0.6276, -0.6276, 0.6276], [-0.6276, 0.6276, -0.6276],
         [0.6276, -0.6276, -0.6276]],
    ),
    "NH3": (
        [7, 1, 1, 1],
        [[0.0, 0.0, 0.1173], [0.0, 0.9377, -0.2737],
         [0.8121, -0.4689, -0.2737], [-0.8121, -0.4689, -0.2737]],
    ),
    "CH3OH": (
        [8, 6, 1, 1, 1, 1],
        [[0.7079, 0.0, 0.0], [-0.7079, 0.0, 0.0],
         [1.0232, -0.8537, 0.3], [-1.0731, -0.8937, 0.5159],
         [-1.0731, 0.1021, -1.0371], [-1.1295, 0.8654, 0.5265]],
    ),
    "C2H6": (
        [6, 6, 1, 1, 1, 1, 1, 1],
        [[0.0, 0.0, 0.7680], [0.0, 0.0, -0.7680],
         [1.0192, 0.0, 1.1573], [-0.5096, 0.8826, 1.1573],
         [-0.5096, -0.8826, 1.1573], [-1.0192, 0.0, -1.1573],
         [0.5096, -0.8826, -1.1573], [0.5096, 0.8826, -1.1573]],
    ),
}

# standard atomic weights (g/mol) of the elements the configurations use
MASS = {1: 1.00790, 6: 12.01100, 7: 14.00670, 8: 15.99940}
# sqrt(Kelvin / (g/mol)) in Angstrom/fs
VEL_SCALE = 0.9118367323190634e-3


def make_alkane(n_carbons: int) -> Tuple[np.ndarray, np.ndarray]:
    """All-anti n-alkane C_k H_{2k+2}, heavy atoms first."""
    cc, ch = 1.54, 1.09
    theta = np.deg2rad(111.0)
    dz = cc * np.sin(theta / 2.0)
    a = 0.5 * cc * np.cos(theta / 2.0)
    carbons = np.array([[a * (1 if i % 2 == 0 else -1), 0.0, dz * i]
                        for i in range(n_carbons)])
    cg, sg = np.cos(np.deg2rad(54.75)), np.sin(np.deg2rad(54.75))
    hydros = []
    for i, c in enumerate(carbons):
        s = 1.0 if i % 2 == 0 else -1.0
        hydros.append(c + ch * np.array([s * cg, sg, 0.0]))
        hydros.append(c + ch * np.array([s * cg, -sg, 0.0]))
        if i == 0 or i == n_carbons - 1:
            zdir = -1.0 if i == 0 else 1.0
            d = np.array([-s * np.sin(np.deg2rad(35.0)), 0.0,
                          zdir * np.cos(np.deg2rad(35.0))])
            hydros.append(c + ch * d)
    species = np.concatenate([np.full(n_carbons, 6), np.full(len(hydros), 1)])
    coords = np.concatenate([carbons, np.asarray(hydros)])
    return species.astype(np.int64), coords


def templates(config: dict) -> Sequence[Tuple[np.ndarray, np.ndarray]]:
    """The configuration's molecules as (species, coords) pairs: the named
    small organics, or the alkanes of ``alkane_carbons``."""
    if "molecules" in config:
        return [(np.asarray(MOLECULES[n][0], np.int64),
                 np.asarray(MOLECULES[n][1], np.float64))
                for n in config["molecules"]]
    return [make_alkane(int(k)) for k in config["alkane_carbons"]]


def base_batch(config: dict, nmol: int) -> Tuple[np.ndarray, np.ndarray]:
    """(species (nmol, A) int64, coords (nmol, A, 3) float64): the
    templates round-robin, zero padded to the configuration's ``molsize``
    (``make_batch`` without the jitter)."""
    mols = templates(config)
    A = int(config["molsize"])
    species = np.zeros((len(mols), A), np.int64)
    coords = np.zeros((len(mols), A, 3))
    for i, (z, x) in enumerate(mols):
        if len(z) > A:
            raise ValueError(f"a molecule of {len(z)} atoms exceeds molsize "
                             f"{A}")
        species[i, :len(z)] = z
        coords[i, :len(z)] = x
    pick = np.arange(nmol) % len(mols)
    return species[pick], coords[pick]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of one run: the
    seed and the stream are mixed, so streams of one seed differ and no
    two runs' seeds collide within a 63-bit range."""
    mixed = (int(seed) * 1_000_003 + int(stream) * 7_919) % (2 ** 63 - 1)
    return torch.Generator(device=torch.device(device)).manual_seed(mixed)


def jittered(species: torch.Tensor, base: torch.Tensor, jitter: float,
             gen: torch.Generator) -> torch.Tensor:
    """base + jitter * N(0, 1) on every real atom (padding stays at 0), in
    base's dtype, drawn in one call on base's device."""
    noise = torch.randn(base.shape, generator=gen, dtype=torch.float64,
                        device=base.device)
    x = base.double() + jitter * noise
    return torch.where((species > 0)[..., None], x,
                       torch.zeros_like(x)).to(base.dtype)


def velocities(species: torch.Tensor, temperature: float, dtype,
               gen: torch.Generator) -> torch.Tensor:
    """Maxwell-Boltzmann velocities (Angstrom/fs) at ``temperature`` K,
    zero on padding atoms, drawn in one call on species' device."""
    table = torch.zeros(max(MASS) + 1, dtype=torch.float64,
                        device=species.device)
    for z, m in MASS.items():
        table[z] = m
    m = table[species]
    scale = torch.sqrt(temperature / torch.where(species > 0, m,
                                                 torch.ones_like(m)))
    v = torch.randn(species.shape + (3,), generator=gen, dtype=torch.float64,
                    device=species.device) * (scale * VEL_SCALE)[..., None]
    return torch.where((species > 0)[..., None], v,
                       torch.zeros_like(v)).to(dtype)
