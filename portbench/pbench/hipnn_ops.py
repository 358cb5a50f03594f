"""The floating-point operations of one forward of the HIP-NN parameter
model (configuration ``pm3-hipnn-small-organics``, whose ``network``
block gives the widths), counted from its published widths (Lubbers, Smith & Barros, J. Chem. Phys. 148, 241715
(2018); the trained model's meta) and the counts of the program's
``learned`` span, never from the program's kernels.

Per atom slot of a molecule padded to A slots, in multiply-adds, for each
interaction block of f_in features in and F out (f_in = 4, the one-hot,
in the first block; F after it):

- the pair sums sum_j s_v(r_ij) x_j over the dense grid: A * S * f_in;
- the interaction weights on them: S * f_in * F;
- the self term S x_i, the residual map and, where f_in != F, the
  input's adjustment: f_in * F + F * F (+ f_in * F);
- the atom layers, each a layer map and a residual map: 2 * F * F;

and the hierarchical head: (f_in of the input + blocks * F) * outputs.
Two operations per multiply-add.  The sensitivities, the cutoff, the
softplus and the additions of biases and skips are elementwise and left
out (under 2% of the total at A = 8), so a share of the peak read from
this count is a lower bound."""
from __future__ import annotations

import json
import os

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "pm3-hipnn-small-organics.json")


def _widths() -> dict:
    """The configuration's ``network`` block: the one-hot's width (its
    elements) and the published widths."""
    with open(CONFIG) as f:
        net = json.load(f)["network"]
    w = {k: int(net[k]) for k in ("n_features", "n_sensitivities",
                                  "n_blocks", "n_atom_layers", "n_outputs")}
    w["n_in"] = len(net["elements"])
    return w


WIDTHS = _widths()


def macs_per_atom(A: int, widths: dict = WIDTHS) -> int:
    F, S = widths["n_features"], widths["n_sensitivities"]
    f_in, total = widths["n_in"], 0
    for _ in range(widths["n_blocks"]):
        total += A * S * f_in + S * f_in * F
        total += f_in * F + F * F + (f_in * F if f_in != F else 0)
        total += widths["n_atom_layers"] * 2 * F * F
        f_in = F
    total += (widths["n_in"] + widths["n_blocks"] * F) * \
        widths["n_outputs"]
    return total


def forward_flops(molecules: int, atoms: int,
                  widths: dict = WIDTHS) -> float:
    """Operations of one forward over ``molecules`` molecules of
    ``atoms`` atom slots in all (padding included)."""
    if molecules <= 0:
        return 0.0
    A = atoms // molecules
    return 2.0 * atoms * macs_per_atom(A, widths)
