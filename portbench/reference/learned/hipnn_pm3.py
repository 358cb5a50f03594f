"""The trained HIP-NN parameter model, the plain side: written from the
published equations in plain torch, importing nothing of the port, and
reading its own copy of the trained weights (``hipnn_pm3.npz`` beside this
file, byte for byte the port's ``params/hipnn_pm3.npz``, which was
extracted from the hippynn model that PYSEQM ships, examples/model/model.pt).

HIP-NN (Lubbers, Smith & Barros, J. Chem. Phys. 148, 241715 (2018)) as it
drives PYSEQM (Zhou et al., PNAS 119, e2120333119 (2022)).  For each
molecule, with x^0 the one-hot encoding of Z over (1, 6, 7, 8):

- sensitivities of a pair at distance r < R = 6 A:
  s_v(r) = exp(-sigma_v^2 (1/r - 1/mu_v)^2 / 2) * cos^2(pi r / (2 R)),
  v = 1..20;
- an interaction layer: z_i = sum_v sum_j s_v(r_ij) W_v x_j + S x_i + b;
- three atom layers after it, each z = B x + c;
- each layer's output passes softplus(t) = log(1 + e^t) and one more
  linear map, added to the layer's input (the trained model's residual
  form, below);
- the hierarchical head: the sum over the levels x^0, x^1, x^2 of one
  linear map each, 9 outputs per atom;
- PM3 parameter k of an atom of element Z: p[Z, k] + w[k] * head_k, for
  U_ss, U_pp, zeta_s, zeta_p, beta_p, g_sp, g_pp, g_p2, h_sp; zero on
  padding atoms.

Departures from the 2018 paper, each as the trained model has it:

- the pairs are the dense (nmol, A, A) grid of each padded molecule,
  masked to real atoms i != j within R, where the paper sums over a
  neighbour list; the same sum;
- every layer is wrapped as a residual unit (hippynn's ResNetWrapper):
  x' = V softplus(z) + d + x (the interaction layer of the first block,
  4 features in and 80 out, adds U x instead of x), where the paper
  applies the activation alone;
- the output is nine PM3 parameters per atom, not an energy
  (Zhou et al. 2022);
- ``dist_soft_min`` and ``dist_soft_max`` of the weights' meta only set
  the initial mu_v in training and take no part here.

Every product is a plain torch contraction, one sensitivity at a time.
Float64 for the reference; the control calls it at float32 inside its
TF32 context.
"""
import json
import math
import os

import numpy as np
import torch

ELEMENTS = (1, 6, 7, 8)
WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "hipnn_pm3.npz")


def _softplus(t):
    return torch.clamp(t, min=0.0) + torch.log1p(torch.exp(-t.abs()))


def _linear(x, w, b=None):
    """x @ w.T (+ b) over the last axis."""
    y = torch.matmul(x, w.transpose(0, 1))
    return y if b is None else y + b


class HipnnPM3:
    """f(species, coordinates) -> {PM3 parameter name: (nmol, A)}."""

    def __init__(self, device, dtype):
        with np.load(WEIGHTS) as d:
            self.meta = json.loads(bytes(d["__meta__"]).decode())
            self.w = {k: torch.as_tensor(np.array(d[k]), dtype=dtype,
                                         device=device)
                      for k in d.files if k != "__meta__"}
        m = self.meta
        if tuple(m["species_order"]) != ELEMENTS:
            raise ValueError(f"weights for {m['species_order']}, not "
                             f"{ELEMENTS}")
        self.R = float(m["dist_hard_max"])
        self.n_blocks = int(m["n_blocks"])
        self.n_atom_layers = int(m["n_atom_layers"])
        self.names = list(m["learned"])

    def sensitivities(self, coordinates, real, block):
        """(s_v (nmol, A, A) for each v): zero off the real pairs i != j
        within R."""
        A = coordinates.shape[1]
        d = coordinates.unsqueeze(2) - coordinates.unsqueeze(1)
        r2 = (d ** 2).sum(-1)
        eye = torch.eye(A, dtype=torch.bool, device=coordinates.device)
        pair = real.unsqueeze(2) & real.unsqueeze(1) & ~eye
        # 1 where no pair, so that the root and its derivative stay finite
        r = torch.sqrt(torch.where(pair, r2, torch.ones_like(r2)))
        pair = pair & (r < self.R)
        cut = torch.cos(math.pi * r / (2.0 * self.R)) ** 2
        mu, sigma = self.w[f"b{block}_mu"], self.w[f"b{block}_sigma"]
        out = []
        for v in range(mu.shape[0]):
            s = torch.exp(-0.5 * (sigma[v] * (1.0 / r - 1.0 / mu[v])) ** 2)
            out.append(torch.where(pair, s * cut, torch.zeros_like(r)))
        return out

    def block(self, x, sens, b):
        w = self.w
        p = f"b{b}_"
        W = w[p + "int_weights"]                      # (v, out, in)
        z = _linear(x, w[p + "self_w"], w[p + "self_b"])
        for v, s in enumerate(sens):
            z = z + _linear(torch.bmm(s, x), W[v])     # sum_j s_v(r_ij) x_j
        skip = x if p + "adjust_w" not in w else _linear(x, w[p + "adjust_w"])
        x = _linear(_softplus(z), w[p + "ires_w"], w[p + "ires_b"]) + skip
        for a in range(self.n_atom_layers):
            q = f"{p}a{a}_"
            z = _linear(x, w[q + "base_w"], w[q + "base_b"])
            x = _linear(_softplus(z), w[q + "res_w"], w[q + "res_b"]) + x
        return x

    def __call__(self, species, coordinates):
        w = self.w
        real = species > 0
        nmol, A = species.shape
        x = torch.zeros(nmol, A, len(ELEMENTS), dtype=coordinates.dtype,
                        device=coordinates.device)
        for k, z in enumerate(ELEMENTS):
            x[..., k] = (species == z).to(coordinates.dtype)
        levels = [x]
        for b in range(self.n_blocks):
            x = self.block(x, self.sensitivities(coordinates, real, b), b)
            levels.append(x)
        head = sum(_linear(h, w[f"head{i}_w"], w[f"head{i}_b"])
                   for i, h in enumerate(levels))
        par = w["seqm_p"][species] + w["seqm_weight"] * head
        par = torch.where(real.unsqueeze(-1), par, torch.zeros_like(par))
        return {name: par[..., k] for k, name in enumerate(self.names)}


def reference(device, dtype):
    return HipnnPM3(device, dtype)
