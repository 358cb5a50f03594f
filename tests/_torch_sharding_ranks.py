"""The ranks of tests/test_torch_sharding.py: a two-rank gloo group on the
CPU runs every sharded entry point of ``pyseqm_tpu_torch.parallel`` once
and rank 0 saves what the tests compare.  Spawned children import this
module by name, so it imports no JAX."""
import os

import numpy as np
import torch
import torch.distributed as dist

import pyseqm_tpu_torch as pt
from pyseqm_tpu_torch.drivers.md import MDConfig
from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
from pyseqm_tpu_torch.parallel import (gather_molecules, make_train_step,
                                       molecule_mesh, pad_to_mesh,
                                       shard_molecules, sharded_energy_fn,
                                       sharded_force_fn, sharded_xlbomd_step)
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.utils.checkpoint import load_state, save_state
from pyseqm_tpu_torch.utils.molecules import make_batch

CPU = "cpu"
NPAD = 13          # the ragged batch pad_to_mesh pads
TRAIN_LR = 2e-3
TRAIN_SHIFT = 0.05  # target = golden Hf + shift


def setup():
    """(const, tables, cfg, species, coords): AM1 float64, the eigh SCF
    (converger 1), make_batch(16, 6)."""
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device=CPU,
                                  scf=SCFConfig(eps=1.0e-9, converger=(1,)))
    sp, co = make_batch(16, 6, jitter=0.01)
    return const, tables, cfg, sp, torch.tensor(co)


def sp2_config(species):
    """The packed SP2 path (DIIS, class-segmented dense layout)."""
    return pt.SEQMConfig(method="AM1", scf=SCFConfig(
        eps=1.0e-9, converger=(2,), use_sp2=True,
        pack_heavy=pt.packed_heavy_count(species)))


def train_config(**scf):
    return pt.SEQMConfig(method="AM1", scf=SCFConfig(
        eps=1.0e-10, converger=(1,), backward=1, backward_eps=1.0e-6, **scf))


def xl_driver(const, tables, cfg):
    return XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)


def xl_start(md, species, coords):
    return md.initialize(species, coords, velocities=torch.zeros_like(coords),
                         initial_force=False)


def run(rank, out, golden):
    """One rank (spawn_ranks starts the group); rank 0 saves to ``out``."""
    torch.set_num_threads(1)
    mesh = molecule_mesh(device=CPU)
    const, tables, cfg, sp, co = setup()
    res = {"size": mesh.size}
    ssp, sco = shard_molecules(mesh, (sp, co))

    res["Hf"] = gather_molecules(
        mesh, sharded_energy_fn(const, tables, cfg, mesh)(ssp, sco))
    f, _ = sharded_force_fn(const, tables, cfg, mesh)(ssp, sco)
    res["force"] = gather_molecules(mesh, f)

    # a ragged batch padded with an empty molecule, eigh and SP2
    psp, pco, pch, nreal = pad_to_mesh(mesh, sp[:NPAD], co[:NPAD])
    res["pad_shape"] = (tuple(psp.shape), tuple(pco.shape), pch, nreal)
    for name, c in (("eigh", cfg), ("sp2", sp2_config(sp))):
        f, hf = sharded_force_fn(const, tables, c, mesh)(
            *shard_molecules(mesh, (psp, pco)))
        res[f"pad_{name}"] = gather_molecules(mesh, (hf, f))

    # XL-BOMD: 2 steps, then a checkpoint after the 3rd, restored and
    # re-sharded, against the live state for 2 more
    md = xl_driver(const, tables, cfg)
    xstep = sharded_xlbomd_step(md, mesh)
    st = shard_molecules(mesh, xl_start(md, sp, co))
    for _ in range(2):
        st, _ = xstep(ssp, st)
    res["xl2"] = gather_molecules(mesh, st)
    st, _ = xstep(ssp, st)
    path = os.path.join(os.path.dirname(out), "xl_ckpt.npz")
    whole = gather_molecules(mesh, st)
    if rank == 0:
        save_state(path, whole)
    dist.barrier()
    for _ in range(2):
        st, _ = xstep(ssp, st)
    cur = shard_molecules(mesh, load_state(path, whole))
    for _ in range(2):
        cur, _ = xstep(ssp, cur)
    res["ckpt"] = (gather_molecules(mesh, st), gather_molecules(mesh, cur))

    # every wrapper checks its block's species (a block out of the
    # descending-Z order)
    bad = ssp.flip(1)
    deltas = {"U_ss": torch.zeros_like(tables["U_ss"])}
    calls = {
        "energy": lambda: sharded_energy_fn(const, tables, cfg, mesh)(bad,
                                                                      sco),
        "force": lambda: sharded_force_fn(const, tables, cfg, mesh)(bad, sco),
        "xl": lambda: xstep(bad, st),
        "train": lambda: make_train_step(const, tables, cfg, mesh, ("U_ss",))(
            deltas, bad, sco, torch.zeros(sco.shape[0],
                                          dtype=torch.float64)),
    }
    res["raised"] = []
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            res["raised"].append((name, str(e)))

    # the training step on the ch2o/h2o golden pair, one molecule a rank
    g = np.load(os.path.join(golden, "am1_ch2o_h2o.npz"))
    tsp, tco, thf = shard_molecules(mesh, (g["species"], g["coordinates"],
                                           g["Hf"]))
    deltas = {"U_ss": torch.zeros_like(tables["U_ss"])}
    step = make_train_step(const, tables, train_config(), mesh, ("U_ss",),
                           lr=TRAIN_LR)
    res["train"] = step(deltas, tsp, tco, thf + TRAIN_SHIFT)
    # targets equal to the model: no loss; an SCF stopped after 2
    # iterations: every molecule masked out of the loss
    step0 = make_train_step(const, tables, train_config(), mesh, ("U_ss",),
                            lr=0.0)
    res["train_exact"] = step0(deltas, tsp, tco, thf)[1]
    stepm = make_train_step(const, tables, train_config(max_iter=2), mesh,
                            ("U_ss",), lr=TRAIN_LR)
    res["train_masked"] = stepm(deltas, tsp, tco, thf + TRAIN_SHIFT)
    if rank == 0:
        torch.save(res, out)
