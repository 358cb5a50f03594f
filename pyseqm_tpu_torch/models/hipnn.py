"""The reference's shipped trained HIP-NN parameter model.

PyTorch counterpart of ``pyseqm_tpu/models/hipnn.py``.  The reference's
production learned-Hamiltonian workflow drives PYSEQM with per-atom PM3
parameters predicted by a trained HIP-NN network (reference
examples/test.py:26-41, examples/model/model.pt); its trained weights and
hyperparameters ship as ``params/hipnn_pm3.npz`` (the port's own copy of
the JAX package's fixture), which this module evaluates.

Architecture (HIP-NN, Lubbers, Smith & Barros, J. Chem. Phys. 148,
241715 (2018)):

  one-hot(Z in [1, 6, 7, 8])                               (nmol, A, 4)
  2 x [ interaction layer (20 inverse-distance sensitivities, cos^2
        cutoff at 6 A) in a ResNet wrapper, then 3 atom-wise ResNet
        layers ]  with nf = 80, softplus activations
  hierarchical head: one linear per feature level (input, block 1,
        block 2), summed                                    (nmol, A, 9)
  per-atom PM3 parameter k of an atom of element Z:
        p_base[Z, k] + unit_weight[k] * head[a, k]
  learned names: U_ss U_pp zeta_s zeta_p beta_p g_sp g_pp g_p2 h_sp

The sensitivity is s_v(r) = exp(-sigma_v^2 (1/r - 1/mu_v)^2 / 2)
* cos^2(pi r / (2 r_hard)).  The pair field is the dense (nmol, A, A)
grid, as in the JAX package, contracted with the features by two einsums
(sensitivities with the neighbours' features first, then the interaction
weights).  Plain torch: the network has no hand kernel.  With TF32 off
(``constants.disable_tf32``) every float32 product here is full float32,
so there is no matmul-precision argument.

The base table ``seqm_p`` has a row per Z = 0..8 only; an atom of any
element outside ``meta["elements"]`` raises ValueError, checked on the
host (the JAX package's gather clamps such an atom onto row 8, oxygen).
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import resolve_device

_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "..", "params",
                             "hipnn_pm3.npz")


def load_hipnn(path: Optional[str] = None, dtype=torch.float32,
               device="cuda") -> Tuple[Dict[str, torch.Tensor], dict]:
    """(weights, meta) from an extracted HIP-NN fixture, on ``device``
    (CUDA by default; raises without a GPU unless device="cpu")."""
    device = resolve_device(device)
    with np.load(path or _DEFAULT_PATH) as d:
        meta = json.loads(bytes(d["__meta__"]).decode())
        w = {k: torch.as_tensor(np.array(d[k]), dtype=dtype, device=device)
             for k in d.files if k != "__meta__"}
    return w, meta


def check_species(meta: dict, species) -> None:
    """Raise ValueError if ``species`` (host array or tensor; one host
    copy for a device tensor) holds an element the model has no base
    parameters for."""
    sp = np.asarray(species.cpu() if torch.is_tensor(species) else species)
    bad = np.setdiff1d(np.unique(sp), np.asarray(meta["elements"]))
    if bad.size:
        raise ValueError(
            f"the HIP-NN model covers elements {meta['elements']}; the "
            f"batch holds Z={sorted(int(z) for z in bad)}")


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _resnet(x, y, res_w, res_b, adjust_w=None):
    """hippynn ResNetWrapper with y = base_layer(x): res(softplus(y)) +
    skip."""
    z = _softplus(y) @ res_w.T + res_b
    skip = x if adjust_w is None else x @ adjust_w.T
    return z + skip


def hipnn_features(w: Dict[str, torch.Tensor], meta: dict, species,
                   coordinates: torch.Tensor) -> List[torch.Tensor]:
    """Per-atom feature levels [one-hot, block 0, block 1]."""
    dtype, dev = coordinates.dtype, coordinates.device
    A = species.shape[1]
    order = torch.as_tensor(meta["species_order"], device=dev)
    feat = (species[..., None] == order).to(dtype)

    amask = species > 0
    dvec = coordinates[:, :, None, :] - coordinates[:, None, :, :]
    r2 = (dvec * dvec).sum(dim=-1)
    eye = torch.eye(A, dtype=torch.bool, device=dev)
    pair_ok = amask[:, :, None] & amask[:, None, :] & ~eye
    rhard = meta["dist_hard_max"]
    r = torch.sqrt(torch.where(pair_ok, r2,
                               torch.full_like(r2, 4.0 * rhard * rhard)))
    pair_ok = pair_ok & (r < rhard)
    inv_r = 1.0 / r
    cut = torch.where(
        pair_ok, torch.cos(0.5 * math.pi * torch.clamp(r, max=rhard)
                           / rhard) ** 2, torch.zeros_like(r))

    levels = [feat]
    for bi in range(meta["n_blocks"]):
        p = f"b{bi}_"
        z = (inv_r[..., None] - 1.0 / w[p + "mu"]) * w[p + "sigma"]
        sens = torch.exp(-0.5 * z * z) * cut[..., None]   # (nmol, A, A, S)
        env = torch.einsum("nijs,njf->nisf", sens, feat)
        y = torch.einsum("nisf,sof->nio", env, w[p + "int_weights"])
        y = y + feat @ w[p + "self_w"].T + w[p + "self_b"]
        feat = _resnet(feat, y, w[p + "ires_w"], w[p + "ires_b"],
                       w.get(p + "adjust_w"))
        for ai in range(meta["n_atom_layers"]):
            ap = f"{p}a{ai}_"
            y = feat @ w[ap + "base_w"].T + w[ap + "base_b"]
            feat = _resnet(feat, y, w[ap + "res_w"], w[ap + "res_b"])
        levels.append(feat)
    return levels


def predict_seqm_parameters(w: Dict[str, torch.Tensor], meta: dict, species,
                            coordinates: torch.Tensor,
                            species_host: Optional[np.ndarray] = None
                            ) -> Dict[str, torch.Tensor]:
    """{PM3 parameter name: (nmol, A) per-atom values} from the trained
    network.  The species are checked against ``meta["elements"]`` on the
    host: ``species_host`` when given, else a host copy of ``species``."""
    check_species(meta, species if species_host is None else species_host)
    levels = hipnn_features(w, meta, species, coordinates)
    pred = None
    for li, x in enumerate(levels):
        h = x @ w[f"head{li}_w"].T + w[f"head{li}_b"]
        pred = h if pred is None else pred + h            # hierarchical sum
    par = w["seqm_p"][species] + pred * w["seqm_weight"]  # (nmol, A, 9)
    par = torch.where((species > 0)[..., None], par, torch.zeros_like(par))
    return {name: par[..., i] for i, name in enumerate(meta["learned"])}


class HipnnCallable:
    """The ``learned`` callable f(species, coordinates) -> {name: (nmol,
    A)} for energy/force and every driver, evaluating the shipped model.
    Each new species tensor is checked on the host once (one copy); the
    same tensor passed again, as the drivers do every step, is not copied
    again."""

    def __init__(self, w: Dict[str, torch.Tensor], meta: dict):
        self.w = w
        self.meta = meta
        self._species = None          # (the tensor, its version, host copy)

    def __call__(self, species, coordinates):
        seen = self._species
        if not (seen is not None and seen[0] is species
                and seen[1] == species._version):
            host = np.asarray(species.cpu())
            check_species(self.meta, host)
            self._species = seen = (species, species._version, host)
        return predict_seqm_parameters(self.w, self.meta, species,
                                       coordinates, species_host=seen[2])


def make_hipnn_callable(path: Optional[str] = None, dtype=torch.float32,
                        device="cuda") -> HipnnCallable:
    """The learned-parameters callable of the reference's trained model
    (contract of basics.py:279-283), on ``device`` (CUDA by default)."""
    return HipnnCallable(*load_hipnn(path, dtype, device))
