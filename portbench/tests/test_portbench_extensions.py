"""A cell's parts brought as new files alone: a learned-parameter model
(the port's side and the plain side), a molecule set with a row-3
molecule, and a cell kind, from ``toy/``, found by name in a copy of the
benchmark, run on the CPU at a tiny size and judged as the card's runs
are.  The accepted configurations draw what they drew before."""
import json
import os

import pytest
import torch

from _harness import BENCH, SEED, run_cpu, tiny_spec, toy_checkout
from pbench import inputs, registry

# the mass table as the accepted configurations were first drawn with it
PARENT_MASS = {1: 1.00790, 6: 12.01100, 7: 14.00670, 8: 15.99940}

# faults planted in a model file: the model left out, and its coordinate
# dependence cut off the force
FAULTS = {
    "dropped": ('return {"zeta_s": zeta_s[species] * s}', "return {}"),
    "detached": ("torch.sin(coordinates)", "torch.sin(coordinates.detach())"),
}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return toy_checkout(tmp_path_factory.mktemp("toy"))


def _edit(path, old, new):
    with open(path) as fh:
        text = fh.read()
    assert old in text, (path, old)
    with open(path, "w") as fh:
        fh.write(text.replace(old, new))


def test_parts_are_found_by_name(toy):
    root, bench = toy
    spec = registry.load(root, "toy-xl", bench_dir=bench)
    assert spec["learned"]["name"] == "toy"
    assert spec["learned"]["elements"] == (1, 6, 7, 8, 16)
    assert registry.load(root, "xl-small", bench_dir=bench)["learned"] is None
    assert registry.kind(bench, "xl_toy").__module__ == \
        "portbench_kind_xl_toy"
    species, coords = inputs.base_batch(spec["config"], 5, bench)
    assert species.shape == (5, 6) and list(species[0, :3]) == [16, 1, 1]
    assert list(species[1, :3]) == [8, 1, 1] and coords.shape == (5, 6, 3)
    with open(os.path.join(bench, "kinds", "not_a_cell.py"), "w") as fh:
        fh.write("Cell = object\n")
    with pytest.raises(TypeError, match="not a subclass"):
        registry.kind(bench, "not_a_cell")


@pytest.mark.parametrize("workload", ["toy-xl", "toy-sp"])
def test_added_cells_run_correct(toy, workload):
    root, bench = toy
    seen = []
    res = run_cpu(workload, root=root, bench=bench, hook=seen.append)
    assert res["correct"] is True, res["checks"]
    cell = seen[0]
    assert cell.row3 and cell.learned is not None
    if workload == "toy-xl":
        assert type(cell).__module__ == "portbench_kind_xl_toy"


@pytest.mark.parametrize("side", ["learned", "reference/learned"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_a_model_file_is_not_correct(tmp_path, side, fault):
    root, bench = toy_checkout(tmp_path)
    _edit(os.path.join(bench, side, "toy.py"), *FAULTS[fault])
    res = run_cpu("toy-xl", root=root, bench=bench)
    assert res["correct"] is False
    assert res["checks"]["force_err"]["value"] > \
        res["checks"]["force_err"]["limit"]


@pytest.mark.parametrize("molecule,message", [
    ({"name": "HCl", "species": [17, 1],
      "coordinates": [[0.0, 0.0, 0.0], [0.0, 0.0, 1.2746]]},
     r"Z=\[17\], which the parameter model toy"),
    ({"name": "Ne", "species": [10], "coordinates": [[0.0, 0.0, 0.0]]},
     r"Z=\[10\], which the AM1 tables"),
    ({"name": "HBr", "species": [35, 1],
      "coordinates": [[0.0, 0.0, 0.0], [0.0, 0.0, 1.4145]]},
     r"Z=\[35\], which the mass table"),
    ({"name": "OH2", "species": [1, 8, 1],
      "coordinates": [[0.0, 0.76, -0.47], [0.0, 0.0, 0.12],
                      [0.0, -0.76, -0.47]]},
     "descending order"),
])
def test_uncovered_element_raises_at_setup(tmp_path, molecule, message):
    root, bench = toy_checkout(tmp_path)
    with open(os.path.join(bench, "molecules", "row3-toy.json"), "w") as fh:
        json.dump({"molecules": [molecule]}, fh)
    spec = tiny_spec("toy-xl", 4, root, bench)
    cls = registry.kind(bench, spec["traffic"]["kind"])
    with pytest.raises(ValueError, match=message):
        cls(spec, SEED, "cpu", False)


@pytest.mark.parametrize("name", ["am1-small-organics", "am1-nonane"])
def test_accepted_configurations_draw_what_they_drew(monkeypatch, name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        config = json.load(fh)
    assumed = config["assumed"]

    def draw():
        sp, base = inputs.base_batch(config, 30)
        species = torch.as_tensor(sp)
        gen = inputs.generator(SEED, 0, "cpu")
        x = inputs.jittered(species, torch.as_tensor(base,
                                                     dtype=torch.float32),
                            assumed["jitter_angstrom"], gen)
        v = inputs.velocities(species, assumed["temperature_k"],
                              torch.float32, gen)
        return torch.as_tensor(sp), torch.as_tensor(base), x, v

    assert {z: inputs.MASS[z] for z in PARENT_MASS} == PARENT_MASS
    now = draw()
    monkeypatch.setattr(inputs, "MASS", PARENT_MASS)
    for a, b in zip(now, draw()):
        assert torch.equal(a, b)
