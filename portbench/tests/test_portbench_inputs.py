"""The frozen generators: the same seed gives the same arrays, another
seed other arrays, and the templates are the port's test molecules."""
import numpy as np
import torch

from _harness import SEED
from pbench import inputs


def _draw(seed, config):
    sp, base = inputs.base_batch(config, 30)
    species = torch.as_tensor(sp)
    gen = inputs.generator(seed, 0, "cpu")
    x = inputs.jittered(species, torch.as_tensor(base, dtype=torch.float32),
                        0.02, gen)
    v = inputs.velocities(species, 300.0, torch.float32, gen)
    return species, x, v


SMALL = {"molecules": ["CH2O", "H2O", "CH4", "NH3", "CH3OH", "C2H6"],
         "molsize": 8}
NONANE = {"alkane_carbons": [9], "molsize": 29}


def test_same_seed_same_arrays():
    for config in (SMALL, NONANE):
        a, b = _draw(SEED, config), _draw(SEED, config)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        c = _draw(SEED + 1, config)
        assert not torch.equal(a[1], c[1])
        assert not torch.equal(a[2], c[2])


def test_streams_of_one_seed_differ():
    g0 = inputs.generator(SEED, 0, "cpu")
    g1 = inputs.generator(SEED, 1, "cpu")
    assert not torch.equal(torch.randn(8, generator=g0),
                           torch.randn(8, generator=g1))


def test_round_robin_and_padding():
    sp, base = inputs.base_batch(SMALL, 13)
    assert sp.shape == (13, 8) and base.shape == (13, 8, 3)
    for i in range(13):
        z, x = inputs.MOLECULES[SMALL["molecules"][i % 6]]
        assert list(sp[i, :len(z)]) == z and (sp[i, len(z):] == 0).all()
        np.testing.assert_array_equal(base[i, :len(z)], np.asarray(x))
    species, x, v = _draw(SEED, SMALL)
    pad = species == 0
    assert (x[pad] == 0).all() and (v[pad] == 0).all()
    assert ((x[~pad] - torch.as_tensor(
        inputs.base_batch(SMALL, 30)[1], dtype=torch.float32)[~pad]
    ).abs().max() < 0.2)


def test_nonane_is_qm9_sized():
    sp, co = inputs.make_alkane(9)
    assert sp.shape == (29,) and (sp > 1).sum() == 9
    assert list(sp) == sorted(sp, reverse=True)
    assert co.shape == (29, 3)
