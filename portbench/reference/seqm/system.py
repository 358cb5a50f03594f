"""Molecular system representation and geometry preprocessing.

PyTorch counterpart of ``pyseqm_tpu/system.py`` (a redesign of the
reference ``Parser``, seqm/basics.py:31-118).  Every tensor keeps the static
batch layout ``(nmol, A)`` for atoms and ``(nmol, NP)`` for pairs, where
``NP = A*(A-1)/2`` enumerates the upper triangle of the atom grid with static
index arrays; invalid entries (padding atoms, pairs beyond the cutoff) are
masked, not removed.

Convention (same as the reference): atoms within a molecule sorted by
descending atomic number, zero padding at the end, so Z_i >= Z_j for every
(i<j) pair.  Use :func:`sort_species` to canonicalize host-side inputs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .constants import _QN, _TORE, LENGTH_CONVERSION_FACTOR, MAX_Z, Constants


@functools.lru_cache(maxsize=None)
def pair_index(A: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static upper-triangle pair indices (i<j) for an A-atom molecule."""
    iu, ju = np.triu_indices(A, k=1)
    return iu.astype(np.int64), ju.astype(np.int64)


@functools.lru_cache(maxsize=None)
def pair_index_packed(A: int, K: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-segmented upper-triangle pair indices for heavy count K.

    With atoms sorted by descending Z and K the batch-wide max heavy count,
    every atom slot >= K holds a hydrogen or padding in every molecule, so
    the triangle splits into three contiguous segments with static
    boundaries: XX (i < j < K), XH (i < K <= j) and HH (K <= i < j).
    """
    K = max(0, min(K, A))
    seg_i, seg_j = [], []
    for i in range(K):
        for j in range(i + 1, K):
            seg_i.append(i)
            seg_j.append(j)
    for i in range(K):
        for j in range(K, A):
            seg_i.append(i)
            seg_j.append(j)
    for i in range(K, A):
        for j in range(i + 1, A):
            seg_i.append(i)
            seg_j.append(j)
    return np.asarray(seg_i, np.int64), np.asarray(seg_j, np.int64)


@functools.lru_cache(maxsize=None)
def pair_packed_from_canonical(A: int, K: int) -> np.ndarray:
    """Canonical-triu index of each packed pair position (reorders per-pair
    user arrays given in ``pair_index(A)`` order to the packed order)."""
    iu, ju = pair_index_packed(A, K)
    canon = iu * (2 * A - iu - 1) // 2 + (ju - iu - 1)
    return canon.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _pair_index_tensors(A: int, heavy_count: Optional[int], device):
    """pair_index / pair_index_packed as device tensors, copied once."""
    iu, ju = (pair_index(A) if heavy_count is None
              else pair_index_packed(A, int(heavy_count)))
    return torch.as_tensor(iu, device=device), torch.as_tensor(ju, device=device)


def pair_segment_sizes(A: int, K: int) -> Tuple[int, int, int]:
    """Static (n_xx, n_xh, n_hh) segment lengths of pair_index_packed."""
    K = max(0, min(K, A))
    n_xx = K * (K - 1) // 2
    n_xh = K * (A - K)
    n_hh = (A - K) * (A - K - 1) // 2
    return n_xx, n_xh, n_hh


@dataclasses.dataclass(frozen=True)
class System:
    """Batched molecular system with derived pair geometry.

    Shapes: nmol = batch, A = molsize (padded), NP = A*(A-1)/2.
    ``rij``/``xij`` stay differentiable with respect to ``coordinates``.
    """

    species: torch.Tensor        # (nmol, A) int64, 0 = padding
    coordinates: torch.Tensor    # (nmol, A, 3) Angstrom
    charges: torch.Tensor        # (nmol,) net molecular charge

    atom_mask: torch.Tensor      # (nmol, A) bool: real atom
    heavy_mask: torch.Tensor     # (nmol, A) bool: Z > 1
    nheavy: torch.Tensor         # (nmol,) int64
    nhydro: torch.Tensor         # (nmol,) int64
    nocc: torch.Tensor           # (nmol,) int64 occupied MOs
    norb: torch.Tensor           # (nmol,) int64 = 4*nheavy + nhydro

    pair_i: torch.Tensor         # (NP,) static atom index i
    pair_j: torch.Tensor         # (NP,) static atom index j
    zi: torch.Tensor             # (nmol, NP) atomic number of atom i
    zj: torch.Tensor             # (nmol, NP)
    pair_mask: torch.Tensor      # (nmol, NP) bool: both real & inside cutoff
    rij: torch.Tensor            # (nmol, NP) distance in Bohr (1 where masked)
    xij: torch.Tensor            # (nmol, NP, 3) unit vector i->j

    # host copies, for index lists built without a device sync (the row-3
    # overlap classes): the species when they came from the host, and the
    # static pair list
    species_host: Optional[np.ndarray] = None
    pair_host: Optional[Tuple[np.ndarray, np.ndarray]] = None

    @property
    def nmol(self) -> int:
        return self.species.shape[0]

    @property
    def molsize(self) -> int:
        return self.species.shape[1]

    @property
    def npairs(self) -> int:
        return self.pair_i.shape[0]


def sort_species(species: np.ndarray, coordinates: np.ndarray):
    """Host-side helper: sort atoms of each molecule by descending Z
    (stable, so equal-Z atoms keep their input order).  Returns numpy."""
    species = np.asarray(species)
    coordinates = np.asarray(coordinates)
    order = np.argsort(-species, axis=1, kind="stable")
    s = np.take_along_axis(species, order, axis=1)
    c = np.take_along_axis(coordinates, order[..., None], axis=1)
    return s, c


def validate(species: np.ndarray, charges: Optional[np.ndarray] = None,
             tore: Optional[np.ndarray] = None, allow_row3: bool = False,
             check_parity: bool = True):
    """Host-side checks mirroring the reference's runtime assertions:
    element range, no argon, row 3 only when allowed, descending-Z sort,
    and (``check_parity``) a closed shell."""
    species = np.asarray(species)
    if (species < 0).any() or (species > MAX_Z).any():
        raise ValueError("unsupported element: atomic numbers must be in [0, 18]")
    if (species == 18).any():
        raise ValueError("argon (Z=18) has no NDDO parameters")
    row3 = np.asarray(_QN)[species] > 2
    if row3.any() and not allow_row3:
        bad = sorted(set(int(z) for z in species[row3]))
        raise ValueError(
            f"row-3 elements {bad} require SEQMConfig.row3=True "
            "(pass allow_row3=True to validate); the reference always "
            "raises here (diat_overlap.py:71-72)")
    if not (np.diff(species, axis=1) <= 0).all():
        raise ValueError("atoms must be sorted by descending atomic number "
                         "(use pyseqm_tpu_torch.system.sort_species)")
    if not check_parity:
        return
    tore = np.asarray(_TORE) if tore is None else np.asarray(tore)
    n_charge = tore[species].sum(axis=1).astype(np.int64)
    if charges is not None:
        n_charge = n_charge - np.asarray(charges).astype(np.int64)
    if (n_charge % 2 == 1).any():
        raise ValueError("only closed-shell systems (even electron count) are supported")


def make_system(
    const: Constants,
    species,
    coordinates: torch.Tensor,
    charges=None,
    pair_outer_cutoff: float = 1.0e10,
    heavy_count: Optional[int] = None,
    species_host: Optional[np.ndarray] = None,
) -> System:
    """Build a :class:`System` (differentiable with respect to coordinates).

    ``pair_outer_cutoff`` is in the units of ``coordinates`` (Angstrom).
    ``heavy_count`` (= packed_heavy_count(species)) orders the pair list
    class-segmented (see :func:`pair_index_packed`).  ``species_host``: a
    host copy of the species (taken from ``species`` when that is not a
    tensor).
    """
    device, dtype = coordinates.device, coordinates.dtype
    if species_host is None and not torch.is_tensor(species):
        species_host = np.asarray(species)
    species = torch.as_tensor(species, dtype=torch.long, device=device)
    nmol, A = species.shape
    if charges is None:
        charges = torch.zeros((nmol,), dtype=torch.long, device=device)
    charges = torch.as_tensor(charges, dtype=torch.long, device=device)

    atom_mask = species > 0
    heavy_mask = species > 1
    nheavy = heavy_mask.sum(dim=1)
    nhydro = (species == 1).sum(dim=1)
    norb = 4 * nheavy + nhydro
    n_charge = const.tore[species].sum(dim=1).long() - charges
    nocc = torch.div(n_charge, 2, rounding_mode="floor")

    iu, ju = _pair_index_tensors(A, heavy_count, device)
    zi = species[:, iu]
    zj = species[:, ju]

    dvec = coordinates[:, ju, :] - coordinates[:, iu, :]  # i -> j
    dist2 = (dvec * dvec).sum(dim=-1)
    # guard duplicated-atom / padding zero distances (reference basics.py:93)
    dist2 = torch.where(dist2 == 0.0, torch.full_like(dist2, 1.0e-4), dist2)
    dist = torch.sqrt(dist2)
    pair_mask = (zi > 0) & (zj > 0) & (dist < pair_outer_cutoff)

    rij = dist * LENGTH_CONVERSION_FACTOR
    # keep masked rij finite & away from 0 so integral formulas stay safe
    rij = torch.where(pair_mask, rij, torch.ones_like(rij))
    xij = dvec / dist[..., None]
    ez = torch.eye(3, dtype=dtype, device=device)[2]
    xij = torch.where(pair_mask[..., None], xij, ez)

    return System(
        species=species, coordinates=coordinates, charges=charges,
        atom_mask=atom_mask, heavy_mask=heavy_mask,
        nheavy=nheavy, nhydro=nhydro, nocc=nocc, norb=norb,
        pair_i=iu, pair_j=ju, zi=zi, zj=zj,
        pair_mask=pair_mask, rij=rij, xij=xij,
        species_host=species_host,
        pair_host=(pair_index(A) if heavy_count is None
                   else pair_index_packed(A, int(heavy_count))),
    )
