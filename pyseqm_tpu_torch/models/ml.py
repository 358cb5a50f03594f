"""Learned-Hamiltonian parameter models (the HIPNN-interface analogue).

PyTorch counterpart of ``pyseqm_tpu/models/ml.py``.  The reference's
production ML workflow predicts per-atom NDDO parameters with a network
and feeds them to Energy/Force through the ``learned_parameters``
callable (seqm/basics.py:279-283, examples/test.py:26-41).  This module is
a self-contained network with that contract, a geometry-dependent
message-free descriptor network

    f(species, coordinates) -> {param_name: (nmol, A) per-atom values}

built from radial-basis atomic environments and per-element MLP heads.
It exercises every piece of the production ML path: the per-step
callable, the parameter gather and merge, and gradient flow into the
network weights.  The trained HIP-NN model is ``models/hipnn.py``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..constants import resolve_device

DEFAULT_PARAM_NAMES = ("U_ss", "U_pp", "zeta_s", "zeta_p",
                       "beta_s", "beta_p", "alpha")


def init_param_model(
    tables: Mapping[str, torch.Tensor],
    generator: torch.Generator,
    param_names: Sequence[str] = DEFAULT_PARAM_NAMES,
    n_rbf: int = 16,
    hidden: int = 32,
    r_cut: float = 5.0,
    scale: float = 0.01,
) -> Dict[str, torch.Tensor]:
    """Random-init weights for :func:`predict_parameters`, drawn from
    ``generator`` with the JAX package's shapes and scalings (its values,
    drawn by its own generator, differ), on the device of ``tables``.

    ``scale`` bounds the relative deviation from the table values (the
    network predicts multiplicative corrections p = table * (1 + scale *
    tanh(head))), so an untrained model still yields physical, SCF-stable
    Hamiltonians: the analogue of HIPNN's initialization around the
    published parameter set (cf. PNAS 119, e2120333119).
    """
    ref = tables[param_names[0]]
    dtype, dev = ref.dtype, ref.device
    max_z = ref.shape[0] - 1
    nparam = len(param_names)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device).to(dev)

    n_in = n_rbf + max_z + 1
    w1 = normal(n_in, hidden) / math.sqrt(n_in)
    w2 = normal(hidden, hidden) / math.sqrt(hidden)
    w3 = normal(hidden, nparam) / math.sqrt(hidden)
    scalar = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
    return {
        "w1": w1, "b1": torch.zeros(hidden, dtype=dtype, device=dev),
        "w2": w2, "b2": torch.zeros(hidden, dtype=dtype, device=dev),
        "w3": w3,
        "centers": torch.as_tensor(np.linspace(0.5, r_cut, n_rbf),
                                   dtype=dtype, device=dev),
        "gamma": scalar(4.0), "r_cut": scalar(r_cut), "scale": scalar(scale),
    }


def weights_from_numpy(weights: Mapping[str, np.ndarray], device="cuda",
                       dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Network weights from numpy arrays (e.g. the JAX package's
    ``init_param_model`` output), on ``device``."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in weights.items()}


def _descriptors(weights, species, coordinates):
    """Per-atom radial-basis environment + one-hot element identity."""
    dtype = coordinates.dtype
    amask = species > 0
    dvec = coordinates[:, :, None, :] - coordinates[:, None, :, :]
    r2 = (dvec * dvec).sum(dim=-1)
    A = species.shape[1]
    eye = torch.eye(A, dtype=torch.bool, device=species.device)
    pair_ok = amask[:, :, None] & amask[:, None, :] & ~eye
    r = torch.sqrt(torch.where(pair_ok, r2, torch.ones_like(r2)))
    # smooth cosine cutoff envelope
    rc = weights["r_cut"]
    zero = torch.zeros_like(r)
    env = torch.where(r < rc, 0.5 * (1.0 + torch.cos(math.pi * r / rc)), zero)
    env = torch.where(pair_ok, env, zero)
    rbf = torch.exp(-weights["gamma"]
                    * (r[..., None] - weights["centers"]) ** 2)
    feat = (env[..., None] * rbf).sum(dim=2)              # (nmol, A, n_rbf)
    nz = weights["w1"].shape[0] - weights["centers"].shape[0]
    onehot = torch.nn.functional.one_hot(species, nz).to(dtype)
    return torch.cat([feat, onehot], dim=-1)


def predict_parameters(
    weights,
    tables: Mapping[str, torch.Tensor],
    species: torch.Tensor,
    coordinates: torch.Tensor,
    param_names: Sequence[str] = DEFAULT_PARAM_NAMES,
) -> Dict[str, torch.Tensor]:
    """Per-atom parameter dict: table value x (1 + scale * tanh(head))."""
    x = _descriptors(weights, species, coordinates)
    h = torch.tanh(x @ weights["w1"] + weights["b1"])
    h = torch.tanh(h @ weights["w2"] + weights["b2"])
    heads = torch.tanh(h @ weights["w3"])                 # (nmol, A, nparam)
    return {name: tables[name][species] * (1.0 + weights["scale"]
                                           * heads[..., i])
            for i, name in enumerate(param_names)}


def make_learned_callable(weights, tables,
                          param_names: Sequence[str] = DEFAULT_PARAM_NAMES):
    """The ``learned_parameters``-style callable consumed by energy/force
    and the drivers (cf. basics.py:279-283): f(species, coordinates) ->
    dict."""

    def f(species, coordinates):
        return predict_parameters(weights, tables, species, coordinates,
                                  param_names)

    return f
