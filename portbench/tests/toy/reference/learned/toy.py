"""The toy parameter model's plain side: the same function from the
reference's own AM1 tables."""
import torch

from reference.seqm.parameters import load_element_tables

ELEMENTS = (1, 6, 7, 8, 16)
SCALE = 0.03


def reference(device, dtype):
    zeta_s = load_element_tables("AM1", device=device, dtype=dtype)["zeta_s"]

    def learned(species, coordinates):
        s = 1.0 + SCALE * torch.sin(coordinates).sum(-1)
        return {"zeta_s": zeta_s[species] * s}
    return learned
