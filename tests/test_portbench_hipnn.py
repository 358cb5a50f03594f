"""The benchmark's trained HIP-NN configuration (``pm3-hipnn-small-organics``)
and its cells on the CPU, without JAX: the plain reference
(``portbench/reference/learned/hipnn_pm3.py``) against the JAX package's
float64 outputs kept in ``reference/golden/pm3-hipnn-small-organics.npz``;
the port's model against the plain one, with the trained weights and with
seeded random weights of the same shapes; tiny ``xl-ml-trained`` and
``sp-nonane`` cells through ``run.run`` judged as the card's runs are;
faults planted on either side of the model; an element the model lacks;
no JAX loaded by a cell run; the count of the network's operations."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(BENCH, "tests"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402
from _harness import SEED, tiny_spec  # noqa: E402
from pbench import hipnn_ops, inputs, program, registry  # noqa: E402
from reference.check import Reference  # noqa: E402
from reference.learned import hipnn_pm3 as plain  # noqa: E402

CONFIG = "pm3-hipnn-small-organics"
GOLDEN = os.path.join(BENCH, "reference", "golden", CONFIG + ".npz")
F64 = torch.float64


with open(os.path.join(BENCH, "traffic", "xlbomd-nve-163840.json")) as fh:
    REFERENCE_SCF = json.load(fh)["reference_scf"]


def _golden():
    with np.load(GOLDEN) as d:
        return ({k: torch.as_tensor(d[k]) for k in d.files if k != "names"},
                [str(n) for n in d["names"]])


def _max(a, b, mask=None):
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = torch.where(mask, d, torch.zeros_like(d))
    return float(d.max())


def test_reference_matches_jax_golden():
    """The plain network and the frozen PM3 reference with it, against the
    JAX package at float64 (12 molecules drawn by the frozen generators;
    the JAX package on the full 4A layout, the reference packed)."""
    torch.set_num_threads(1)
    g, names = _golden()
    sp, x = g["species"], g["x0"]
    model = plain.reference("cpu", F64)
    par = model(sp, x)
    assert list(par) == names
    for k, name in enumerate(names):
        ref = g["params"][..., k]
        assert _max(par[name], ref) <= 1e-10 * float(ref.abs().max()), name
    from pyseqm_tpu_torch import packed_heavy_count
    ref = Reference("PM3", F64, "cpu", packed_heavy_count(sp.numpy()),
                    REFERENCE_SCF, learned=model)
    r = ref.single_point(sp, x)
    assert not bool(r["nc"].any())
    assert _max(r["Hf"], g["sp_Hf"]) < 1e-8
    assert _max(r["f"], g["sp_f"], (sp > 0)[..., None]) < 1e-8
    assert _max(r["P"], g["sp_P"]) < 1e-8


def _random_weights(path):
    """The trained file with every layer's weights and biases drawn anew
    (seeded, each array's own spread), the sensitivities' centres and
    widths and the PM3 base and scale kept."""
    gen = np.random.default_rng(20261019)
    keep = ("mu", "sigma", "seqm_p", "seqm_weight", "__meta__")
    with np.load(plain.WEIGHTS) as d:
        out = {k: (d[k] if k.endswith(keep) else
                   gen.normal(0.0, d[k].std(), d[k].shape))
               for k in d.files}
    np.savez(path, **out)
    return str(path)


@pytest.mark.parametrize("weights", ["trained", "random"])
def test_port_matches_plain_reference(weights, tmp_path, monkeypatch):
    """The port's model and the plain one at float64 on 12 molecules:
    the parameters, and the PM3 force through the port and through the
    frozen reference, each with its own side of the model."""
    torch.set_num_threads(1)
    from pyseqm_tpu_torch.models.hipnn import make_hipnn_callable
    path = None
    if weights == "random":
        path = _random_weights(tmp_path / "random.npz")
        monkeypatch.setattr(plain, "WEIGHTS", path)
    with open(os.path.join(BENCH, "configs", CONFIG + ".json")) as fh:
        config = json.load(fh)
    sp_np, base = inputs.base_batch(config, 12)
    sp = torch.as_tensor(sp_np)
    x = inputs.jittered(sp, torch.as_tensor(base), 0.05,
                        inputs.generator(SEED, 7, "cpu"))
    port = make_hipnn_callable(path, dtype=F64, device="cpu")
    model = plain.reference("cpu", F64)
    got, ref = port(sp, x), model(sp, x)
    assert list(got) == list(ref)
    for name in ref:
        assert _max(got[name], ref[name]) <= \
            1e-10 * float(ref[name].abs().max()), name
    const, tables, cfg, K = program.build(dict(config, dtype="float64"),
                                          REFERENCE_SCF, sp_np, "cpu")
    f, out = program.force(const, tables, cfg, sp, x, port)
    r = Reference("PM3", F64, "cpu", K, REFERENCE_SCF,
                  learned=model).single_point(sp, x)
    assert not bool(out.notconverged.any() or r["nc"].any())
    assert _max(f, r["f"], (sp > 0)[..., None]) < 1e-7
    assert _max(out.Hf, r["Hf"]) < 1e-8


def _run(workload, spec=None, hook=None, monkeypatch=None):
    """One tiny cell run on the CPU in this process (whose test set-up
    loads JAX: the look for it after the window is left to
    ``test_cell_run_loads_no_jax``)."""
    torch.set_num_threads(1)
    monkeypatch.setattr(run, "loaded_forbidden", lambda: [])
    spec = spec or tiny_spec(workload, 12)
    if spec["traffic"]["kind"] == "single_point":
        # one request: the n = 64 plain Jacobi solver is slow on the CPU
        spec["traffic"].update(batch=2, warmup_requests=0)
    return run.run(spec, SEED, 0.01, False, "cpu", time.perf_counter(),
                   cell_hook=hook)


@pytest.mark.parametrize("workload", ["xl-ml-trained", "sp-nonane"])
def test_tiny_cells_are_correct(workload, monkeypatch):
    seen = []
    res = _run(workload, hook=seen.append, monkeypatch=monkeypatch)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    cell = seen[0]
    if workload == "xl-ml-trained":
        assert cell.config["method"] == "PM3"
        assert cell.learned_model["elements"] == plain.ELEMENTS
        assert callable(cell.learned)
    else:
        assert cell.learned is None and cell.n_solver == 64


def _detached(program_side):
    def build(device, dtype):
        model = program_side(device, dtype)
        return lambda species, x: model(species, x.detach())
    return build


def _perturbed(reference_side):
    def build(device, dtype):
        model = reference_side(device, dtype)
        model.w["b1_int_weights"] = model.w["b1_int_weights"] * 1.1
        return model
    return build


@pytest.mark.parametrize("fault", ["program_detached",
                                   "reference_perturbed"])
def test_fault_in_the_model_is_not_correct(fault, monkeypatch):
    spec = tiny_spec("xl-ml-trained", 12)
    lm = dict(spec["learned"])
    if fault == "program_detached":
        lm["program"] = _detached(lm["program"])
    else:
        lm["reference"] = _perturbed(lm["reference"])
    spec["learned"] = lm
    res = _run("xl-ml-trained", spec=spec, monkeypatch=monkeypatch)
    assert res["correct"] is False
    assert res["checks"]["force_err"]["value"] > \
        res["checks"]["force_err"]["limit"]


def test_element_the_model_lacks_raises_at_setup(monkeypatch):
    monkeypatch.setitem(inputs.MOLECULES, "H2S", (
        [16, 1, 1], [[0.0, 0.0, 0.0], [0.0, 0.9617, 0.9268],
                     [0.0, -0.9617, 0.9268]]))
    spec = tiny_spec("xl-ml-trained", 4)
    spec["config"] = dict(spec["config"], molecules=["H2O", "H2S"])
    cls = registry.kind(BENCH, spec["traffic"]["kind"])
    with pytest.raises(ValueError,
                       match=r"Z=\[16\], which the parameter model hipnn_pm3"):
        cls(spec, SEED, "cpu", False)


PROBE = r"""
import sys, time
sys.path[:0] = [{tests!r}, {bench!r}, {root!r}]
import torch
torch.set_num_threads(1)
import run
from _harness import SEED, tiny_spec
res = run.run(tiny_spec("xl-ml-trained", 6), SEED, 0.01, False, "cpu",
              time.perf_counter())
print("CORRECT", res["correct"])
print("FOUND", run.loaded_forbidden())
print("PORT", "pyseqm_tpu_torch" in sys.modules)
"""


def test_cell_run_loads_no_jax():
    """A whole xl-ml-trained run in a fresh interpreter, both sides of the
    model included, leaves no JAX, flax or JAX package loaded."""
    code = PROBE.format(tests=os.path.join(BENCH, "tests"), bench=BENCH,
                        root=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "CORRECT True" in res.stdout
    assert "FOUND []" in res.stdout
    assert "PORT True" in res.stdout


def test_forward_operations_at_eight_atoms():
    """1,967,648 multiply-adds per 8-slot molecule: 1,024,000 of them in
    the second block's interaction weights."""
    assert hipnn_ops.macs_per_atom(8) * 8 == 1_967_648
    assert hipnn_ops.forward_flops(3, 24) == 3 * 2 * 1_967_648
    assert hipnn_ops.forward_flops(0, 0) == 0.0
    w = hipnn_ops.WIDTHS
    assert 8 * w["n_sensitivities"] * w["n_features"] ** 2 == 1_024_000


def test_counted_widths_are_the_weights():
    """The count's widths (the configuration's network block) are those
    of the trained weights the reference reads."""
    w = hipnn_ops.WIDTHS
    d = np.load(os.path.join(BENCH, "reference", "learned", "hipnn_pm3.npz"))
    blocks = sorted({k.split("_")[0] for k in d.files
                     if k.startswith("b") and k[1].isdigit()})
    assert len(blocks) == w["n_blocks"]
    f_in = w["n_in"]
    for b in blocks:
        assert d[f"{b}_int_weights"].shape == (
            w["n_sensitivities"], w["n_features"], f_in)
        layers = {k.split("_")[1] for k in d.files
                  if k.startswith(f"{b}_a") and k.endswith("_base_w")}
        assert len(layers) == w["n_atom_layers"]
        f_in = w["n_features"]
    assert d["seqm_weight"].shape == (w["n_outputs"],)
