"""Frozen input generators: the benchmark's own copies of the port's test
molecules (``utils/molecules.py``: ``MOLECULES``, ``make_alkane`` and the
round-robin of ``make_batch``), so a later change to the port cannot move
the yardstick, and the molecule sets that configurations bring as files
(``molecules/<g>.json``).

Geometries and velocities are drawn from a ``torch.Generator`` on the
device the cell runs on, seeded from ``--seed``: the same seed on the same
device gives the same arrays, and the reference regenerates a request's
geometry by the same call.
"""
from __future__ import annotations

import json
import os
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from reference.seqm.constants import _MASS

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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

# standard atomic weights (g/mol), the reference's table: H..Ar
MASS = {z: m for z, m in enumerate(_MASS) if m > 0.0}
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


def geometries(name: str, bench_dir: str = BENCH
               ) -> Sequence[Tuple[np.ndarray, np.ndarray]]:
    """The molecules of ``molecules/<name>.json``: ``{"molecules": [{"name",
    "species", "coordinates" (Angstrom)}, ...]}``, species sorted by
    descending Z as in ``MOLECULES`` (heavy atoms first)."""
    with open(os.path.join(bench_dir, "molecules", name + ".json")) as fh:
        mols = json.load(fh)["molecules"]
    out = []
    for m in mols:
        z = np.asarray(m["species"], np.int64)
        x = np.asarray(m["coordinates"], np.float64)
        if z.ndim != 1 or x.shape != (len(z), 3):
            raise ValueError(f"molecules/{name}.json: {m['name']} needs one "
                             "(x, y, z) per atom")
        if (z < 1).any() or (np.diff(z) > 0).any():
            raise ValueError(f"molecules/{name}.json: {m['name']} needs its "
                             "atomic numbers, all 1 or more, in descending "
                             "order")
        out.append((z, x))
    return out


def templates(config: dict, bench_dir: str = BENCH
              ) -> Sequence[Tuple[np.ndarray, np.ndarray]]:
    """The configuration's molecules as (species, coords) pairs: the named
    small organics, the alkanes of ``alkane_carbons``, or the file named
    by ``geometries``."""
    given = [k for k in ("molecules", "alkane_carbons", "geometries")
             if k in config]
    if len(given) != 1:
        raise ValueError("a configuration names exactly one of molecules, "
                         f"alkane_carbons and geometries, not {given}")
    if "molecules" in config:
        return [(np.asarray(MOLECULES[n][0], np.int64),
                 np.asarray(MOLECULES[n][1], np.float64))
                for n in config["molecules"]]
    if "geometries" in config:
        return geometries(config["geometries"], bench_dir)
    return [make_alkane(int(k)) for k in config["alkane_carbons"]]


def check_elements(species: np.ndarray, covered: Mapping[str, Sequence[int]]):
    """Raise ValueError naming each element of ``species`` (padding 0
    aside) that a table of ``covered`` (its name -> the atomic numbers it
    covers) lacks."""
    present = {int(z) for z in np.unique(species) if z > 0}
    for what, zs in covered.items():
        missing = sorted(present - {int(z) for z in zs})
        if missing:
            raise ValueError(f"the molecules hold Z={missing}, which "
                             f"{what} does not cover")


def base_batch(config: dict, nmol: int, bench_dir: str = BENCH
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(species (nmol, A) int64, coords (nmol, A, 3) float64): the
    templates round-robin, zero padded to the configuration's ``molsize``
    (``make_batch`` without the jitter)."""
    mols = templates(config, bench_dir)
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
