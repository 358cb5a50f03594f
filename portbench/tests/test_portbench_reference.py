"""The reference that decides ``correct`` is held to an independent
implementation of the same physics: the repo's JAX package, whose float64
outputs on each configuration's molecules are kept in
``reference/golden/<config>.npz`` (the reference imports no JAX, so the
comparison reads them from there).

Each file holds molecules drawn by the frozen generators (12 small
organics, 2 nonanes; jitter and 300 K velocities from one seed), the JAX
package's float64 single point (force, Hf, density) at the traffic's
``reference_scf``, and one JAX XL-BOMD step (k = 5, dt = 0.4 fs, NVE)
from the state after its bootstrap and two steps, with SP2 run to its
float64 floor (eps 1e-7, where the cells' 1e-4 would compare two stopping
rules instead of the physics).  The JAX package runs the small molecules'
electronic chain on the full 4A x 4A layout and the reference on the
static packed one, so the packing is checked too.

Bounds: the single point to rounding; the XL step's density and energy to
the JAX SP2's stopping point (trace error under 1e-7), everything else to
rounding.  Each is at least 1,000x below the cells' limits.
"""
import json
import os

import numpy as np
import pytest
import torch

from _harness import BENCH
from reference.check import ACC_SCALE, Reference

CASES = {"am1-small-organics": "xlbomd-nve-655360",
         "am1-nonane": "xlbomd-nve-40960"}
TIGHT_SP2 = {"eps": 1.0e-10, "sp2_eps": 1.0e-7, "max_iter": 1000}


def _load(kind, name):
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def _golden(config):
    path = os.path.join(BENCH, "reference", "golden", config + ".npz")
    return {k: torch.as_tensor(v) for k, v in np.load(path).items()}


def _max(a, b, mask=None):
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = torch.where(mask, d, torch.zeros_like(d))
    return float(d.max())


@pytest.mark.parametrize("config", sorted(CASES))
def test_single_point_matches_jax_package(config):
    torch.set_num_threads(2)
    g = _golden(config)
    scf = _load("traffic", CASES[config])["reference_scf"]
    sp = g["species"]
    ref = Reference("AM1", torch.float64, "cpu", int(g["K"]), scf)
    r = ref.single_point(sp, g["x0"])
    assert not bool(r["nc"].any())
    assert _max(r["f"], g["sp_f"], (sp > 0)[..., None]) < 1e-9
    assert _max(r["Hf"], g["sp_Hf"]) < 1e-9
    assert _max(r["P"], g["sp_P"]) < 1e-10


@pytest.mark.parametrize("config", sorted(CASES))
def test_xl_step_matches_jax_package(config):
    torch.set_num_threads(2)
    g = _golden(config)
    traffic = _load("traffic", CASES[config])
    sp = g["species"]
    ref = Reference("AM1", torch.float64, "cpu", int(g["K"]),
                    dict(traffic["scf"], **TIGHT_SP2))
    st = {"x": g["s_coordinates"], "v": g["s_velocities"],
          "acc": g["s_acc"], "D": g["s_D"], "Pt": g["s_Pt"]}
    r = ref.xl_step(sp, st, int(g["s_step"]), int(traffic["k"]),
                    float(traffic["dt_fs"]))
    acc = r["f"] / ref.masses(sp) * ACC_SCALE
    assert _max(r["x"], g["n_coordinates"]) < 1e-12
    assert _max(r["P"], g["n_P"]) < 1e-12
    assert _max(r["v"], g["n_velocities"]) < 1e-9
    assert _max(acc, g["n_acc"], (sp > 0)[..., None]) < 1e-8
    assert _max(r["D"], g["n_D"]) < 1e-7
    assert _max(r["Hf"], g["n_Epot"]) < 1e-6


def test_golden_inputs_are_the_frozen_generators():
    """The golden molecules are the configurations' own templates."""
    from pbench import inputs
    for config in CASES:
        g = _golden(config)
        sp, base = inputs.base_batch(_load("configs", config),
                                     g["species"].shape[0])
        assert torch.equal(g["species"], torch.as_tensor(sp))
        real = (g["species"] > 0)[..., None]
        assert _max(g["x0"], torch.as_tensor(base), real) < 0.2
