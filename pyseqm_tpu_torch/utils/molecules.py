"""Small-organic geometries for tests & benchmarks (Angstrom, species
sorted by descending Z as the framework requires)."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# (species, coords) — approximate gas-phase geometries
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
    # row-3 set (SEQMConfig.row3 — beyond the reference's coverage)
    "H2S": (
        [16, 1, 1],
        [[0.0, 0.0, 0.0], [1.2903, 0.0, 0.0], [-0.079, 1.288, 0.0]],
    ),
    "CH3SH": (
        [16, 6, 1, 1, 1, 1],
        [[0.0, 0.0, 0.0], [1.81, 0.0, 0.0], [-0.45, 1.24, 0.0],
         [2.16, 0.51, 0.89], [2.16, 0.51, -0.89], [2.16, -1.03, 0.0]],
    ),
}

DEFAULT_NAMES = ("CH2O", "H2O", "CH4", "NH3", "CH3OH", "C2H6")
ROW3_NAMES = DEFAULT_NAMES + ("H2S", "CH3SH")


def make_alkane(n_carbons: int) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic all-anti n-alkane C_k H_{2k+2} (sorted heavy-first).

    Scale-test workload standing in for the reference's 884-atom nanostar
    (tests/test10): n_carbons=294 gives 884 atoms / 3536 orbitals.
    """
    cc, ch = 1.54, 1.09
    theta = np.deg2rad(111.0)
    dz = cc * np.sin(theta / 2.0)
    a = 0.5 * cc * np.cos(theta / 2.0)
    # zigzag backbone in the xz-plane
    carbons = np.array([[a * (1 if i % 2 == 0 else -1), 0.0, dz * i]
                        for i in range(n_carbons)])
    # CH2 hydrogens: in the xy-plane through C, bisecting away from the
    # backbone, +-54.75 deg off the bisector (tetrahedral H-C-H)
    cg, sg = np.cos(np.deg2rad(54.75)), np.sin(np.deg2rad(54.75))
    hydros = []
    for i, c in enumerate(carbons):
        s = 1.0 if i % 2 == 0 else -1.0   # bisector points along +s x
        hydros.append(c + ch * np.array([s * cg, sg, 0.0]))
        hydros.append(c + ch * np.array([s * cg, -sg, 0.0]))
        if i == 0 or i == n_carbons - 1:
            zdir = -1.0 if i == 0 else 1.0
            d = np.array([-s * np.sin(np.deg2rad(35.0)), 0.0,
                          zdir * np.cos(np.deg2rad(35.0))])
            hydros.append(c + ch * d)
    species = np.concatenate([np.full(n_carbons, 6), np.full(len(hydros), 1)])
    coords = np.concatenate([carbons, np.asarray(hydros)])
    return species.astype(np.int32), coords


def make_batch(nmol: int, molsize: int = 8, names: Sequence[str] = None,
               jitter: float = 0.0, seed: int = 0, sort: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Round-robin batch of small organics padded to ``molsize``.

    ``sort=True`` groups identical species contiguously (stable order,
    same molecule multiset): per-molecule results are unchanged, but
    batched while_loops (SP2 kernel programs, SCF) run each block only to
    its own slowest member instead of every block running to the global
    max — a construction-time batching choice, zero runtime cost."""
    # default set pinned to the original six: benches and goldens are
    # built on it, and the row-3 entries need SEQMConfig.row3
    names = [n for n in (names or DEFAULT_NAMES)
             if len(MOLECULES[n][0]) <= molsize]
    rng = np.random.RandomState(seed)
    species = np.zeros((nmol, molsize), dtype=np.int32)
    coords = np.zeros((nmol, molsize, 3))
    for i in range(nmol):
        z, x = MOLECULES[names[i % len(names)]]
        n = len(z)
        species[i, :n] = z
        xi = np.asarray(x)
        if jitter:
            xi = xi + jitter * rng.randn(*xi.shape)
        coords[i, :n] = xi
    if sort:
        order = np.argsort(np.arange(nmol) % len(names), kind="stable")
        species, coords = species[order], coords[order]
    return species, coords
