"""A toy parameter model, the port's side: AM1's zeta_s of each atom
scaled by a smooth function of its coordinates, so the force carries
dE/dzeta_s . dzeta_s/dx."""
import torch

SCALE = 0.03


def program(device, dtype):
    import pyseqm_tpu_torch as pt
    zeta_s = pt.load_element_tables("AM1", device=device, dtype=dtype)[
        "zeta_s"]

    def learned(species, coordinates):
        s = 1.0 + SCALE * torch.sin(coordinates).sum(-1)
        return {"zeta_s": zeta_s[species] * s}
    return learned
