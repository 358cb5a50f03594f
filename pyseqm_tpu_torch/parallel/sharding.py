"""Data parallelism over the molecule batch axis on ``torch.distributed``.

PyTorch counterpart of ``pyseqm_tpu/parallel/sharding.py``.  Molecules are
independent, so the batch axis splits over processes, one per GPU (SPMD,
``torchrun --nproc_per_node=N``): each rank holds a contiguous block of
the batch and runs its own SCF with local convergence masks; no
collective runs per SCF iteration or per MD step.  Collectives appear
only where the physics needs them: the training step's mean loss and
gradients (``all_reduce``), and :func:`gather_molecules`, which assembles
the whole batch where a caller needs it (tests, checkpoints).

Parameter tables and learned offsets are replicated; molecular data
(species, coordinates, densities, MD state) split along axis 0, the XL
history ring ``Pt`` along axis 1 (:func:`xlbomd_state_specs`).  Every
wrapper checks its block's species on the host (``check_species``).

On CUDA the group is NCCL.  Gloo runs the CPU (the tests) and, staged
through host memory, several ranks on one card, which NCCL refuses.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..constants import Constants
from ..models.energy import SEQMConfig, check_species, energy, force

# all_reduce calls made by the training step (one per step)
all_reduces = 0


@dataclasses.dataclass(frozen=True)
class MoleculeMesh:
    """The process group over which the molecule axis splits, this
    process's rank in it, its size and the rank's device."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str


def free_port() -> int:
    """A free TCP port on localhost, for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, backend, args):
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args=(), backend: str = "gloo",
                timeout: Optional[float] = None):
    """Run ``fn(rank, *args)`` in ``world`` spawned processes, joined in a
    ``backend`` group on a free localhost port (the default group of each,
    so :func:`molecule_mesh` finds it).  ``fn`` must be importable by name
    from a module the children can import.  Returns when every rank has
    returned; raises if one fails or ``timeout`` seconds pass, and stops
    the ranks still running."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(fn, world, free_port(),
                                               backend, tuple(args)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def molecule_mesh(devices: Optional[Sequence] = None, group=None,
                  device=None) -> MoleculeMesh:
    """The mesh of this process: ``group`` (default: the default group),
    and this rank's device: ``devices[rank]`` when ``devices`` lists one
    per rank, else ``device``, else ``cuda:<LOCAL_RANK>``.

    Without an initialized default group one is started: from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when set, else a world of one on a free localhost
    port; NCCL for a CUDA device, gloo for the CPU.  A CUDA device without
    a GPU raises; nothing falls back to the CPU or to gloo."""
    if group is None and not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0))
    else:
        rank = dist.get_rank(group)
    if devices is not None:
        device = devices[rank]
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"molecule_mesh: device {device} needs CUDA, "
                               "and no GPU is available; pass device='cpu' "
                               "for a gloo group on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"molecule_mesh: unsupported device {device}")
    if group is None and not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{free_port()}",
                rank=0, world_size=1)
    size = dist.get_world_size(group)
    if devices is not None and len(devices) != size:
        raise ValueError(f"molecule_mesh: {len(devices)} devices for a "
                         f"group of {size}")
    return MoleculeMesh(group=group, rank=dist.get_rank(group), size=size,
                        device=device, backend=dist.get_backend(group))


def pad_to_mesh(mesh: MoleculeMesh, species, coordinates, charges=None):
    """Pad a molecule batch to a multiple of the mesh size with empty
    molecules (species 0 rows, zero coordinates, charge 0), which flow
    through the SCF and MD as inert work (P = 0, Hf = 0, zero forces, on
    the eigh and SP2 paths alike).  Returns ``(species, coordinates,
    charges, nreal)``: slice outputs back to ``[:nreal]``.  numpy arrays
    stay numpy arrays, tensors tensors."""
    n = species.shape[0]
    m = (-n) % mesh.size

    def pad(x):
        if x is None or m == 0:
            return x
        if torch.is_tensor(x):
            return torch.cat([x, x.new_zeros((m,) + tuple(x.shape[1:]))])
        x = np.asarray(x)
        return np.concatenate([x, np.zeros((m,) + x.shape[1:], x.dtype)])

    return pad(species), pad(coordinates), pad(charges), n


def xlbomd_state_specs():
    """The axis along which each ``XLBOMDState`` field splits over the
    mesh, as an XLBOMDState: the batch axis 0, except the history ring
    ``Pt`` (k+1, nmol, n, n), split on axis 1, and the step counter,
    replicated (None)."""
    from ..drivers.xlbomd import XLBOMDState
    return XLBOMDState(coordinates=0, velocities=0, acc=0, D=0, P=0, Pt=1,
                       E0=0, step=None)


def _block(mesh: MoleculeMesh, x, axis):
    if axis is None or not (torch.is_tensor(x) or isinstance(x, np.ndarray)):
        return x
    x = torch.as_tensor(x)
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"axis {axis} of length {n} does not split over "
                         f"{mesh.size} ranks; pad the batch first "
                         "(pad_to_mesh)")
    b = n // mesh.size
    return x.narrow(axis, mesh.rank * b, b).to(mesh.device, copy=True)


def _map(tree, specs, fn):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        if specs is None:
            specs = xlbomd_state_specs()
        return dataclasses.replace(tree, **{
            f.name: fn(getattr(tree, f.name), getattr(specs, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(fn(x, 0) for x in tree)
    if isinstance(tree, dict):
        return {k: fn(v, 0) for k, v in tree.items()}
    return fn(tree, 0)


def shard_molecules(mesh: MoleculeMesh, tree, specs=None):
    """This rank's contiguous block of the molecule axis of ``tree`` (an
    array, a tuple, list or dict of arrays, or an XLBOMDState split by
    ``specs``, default :func:`xlbomd_state_specs`), copied to the mesh's
    device.  The axis must divide by the mesh size (:func:`pad_to_mesh`
    first)."""
    return _map(tree, specs, lambda x, ax: _block(mesh, x, ax))


def _stage(mesh: MoleculeMesh, x: torch.Tensor) -> torch.Tensor:
    """A tensor a collective of this group can take: gloo works on host
    memory, so a CUDA tensor is staged through it."""
    if mesh.backend == "gloo" and x.device.type != "cpu":
        return x.cpu()
    return x


def _all_gather(mesh: MoleculeMesh, x, axis):
    if axis is None or not torch.is_tensor(x):
        return x
    xs = _stage(mesh, x.contiguous())
    parts = [torch.empty_like(xs) for _ in range(mesh.size)]
    dist.all_gather(parts, xs, group=mesh.group)
    return torch.cat(parts, dim=axis).to(x.device)


def gather_molecules(mesh: MoleculeMesh, tree, specs=None):
    """The whole batch from every rank's block (``all_gather`` on the
    split axis), on each rank: the counterpart of reading a global array
    of the JAX package's sharded functions."""
    return _map(tree, specs, lambda x, ax: _all_gather(mesh, x, ax))


def _inputs(const: Constants, cfg: SEQMConfig, tables, species, coords,
            charges):
    """Check the block's species (and charges) on the host, then the
    coordinates and charges as tensors on the device of ``const``."""
    check_species(cfg, tables, species, charges)
    coords = torch.as_tensor(coords, dtype=const.dtype, device=const.device)
    if charges is not None:
        charges = torch.as_tensor(charges, dtype=torch.long,
                                  device=const.device)
    return coords, charges


def sharded_energy_fn(const: Constants, tables, cfg: SEQMConfig,
                      mesh: MoleculeMesh):
    """Batched energy on this rank's block: ``efn(species, coords,
    charges=None) -> Hf`` of the block (optional per-molecule net charges
    split like the batch)."""
    def efn(species, coords, charges=None):
        coords, charges = _inputs(const, cfg, tables, species, coords,
                                  charges)
        with torch.no_grad():
            return energy(const, tables, cfg, species, coords,
                          charges=charges).Hf
    return efn


def sharded_force_fn(const: Constants, tables, cfg: SEQMConfig,
                     mesh: MoleculeMesh):
    """Batched forces on this rank's block: ``ffn(species, coords,
    charges=None) -> (force, Hf)`` of the block."""
    def ffn(species, coords, charges=None):
        coords, charges = _inputs(const, cfg, tables, species, coords,
                                  charges)
        f, out = force(const, tables, cfg, species, coords, charges=charges)
        return f, out.Hf
    return ffn


def sharded_xlbomd_step(md, mesh: MoleculeMesh):
    """One XL-BOMD step of this rank's block of the trajectory:
    ``step(species, state) -> (state, observables)`` with the state split
    by :func:`xlbomd_state_specs`.  The electronic propagation, the
    Hcore/Fock build, the density solve and the Verlet update are all
    molecule-local: no collective.  A driver built with per-molecule net
    charges (``md.charges``, the whole batch's) passes the rank's block of
    them."""
    charges = (None if getattr(md, "charges", None) is None
               else shard_molecules(mesh, md.charges))

    def step(species, state):
        check_species(md.seqm_cfg, md.tables, species, charges)
        return md.step(species, state, charges=charges)
    return step


def make_train_step(const: Constants, tables, cfg: SEQMConfig,
                    mesh: MoleculeMesh, param_names=("U_ss", "zeta_s"),
                    lr: float = 1.0e-4):
    """Data-parallel learned-Hamiltonian training step on per-element
    offset tables (cf. tests/test-train.py): replicated ``deltas``, this
    rank's block of the batch, loss and gradients averaged over the group
    with one ``all_reduce``, then SGD.  Molecules whose SCF failed are
    masked out of the loss (cf. tests/test-train.py:133-147).

    Returns ``step(deltas, species, coords, hf_target, charges=None) ->
    (deltas, loss)``; the local loss is sum(ok (Hf - target)^2) over the
    block's molecules divided by their number.
    """
    def step(deltas, species, coords, hf_target, charges=None):
        global all_reduces
        coords, charges = _inputs(const, cfg, tables, species, coords,
                                  charges)
        hf_target = torch.as_tensor(hf_target, dtype=const.dtype,
                                    device=const.device)
        sp = torch.as_tensor(species, dtype=torch.long, device=const.device)
        leaves = [deltas[n].detach().requires_grad_(True)
                  for n in param_names]
        with torch.enable_grad():
            learned = {n: (tables[n] + d)[sp]
                       for n, d in zip(param_names, leaves)}
            out = energy(const, tables, cfg, sp, coords, learned=learned,
                         charges=charges)
            ok = (~out.notconverged).to(coords.dtype)
            loss = (ok * (out.Hf - hf_target) ** 2).sum() / hf_target.shape[0]
            grads = torch.autograd.grad(loss, leaves)
        # the mean over the group of the loss and every gradient, in one
        # all_reduce of one flat buffer
        flat = torch.cat([loss.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        buf = _stage(mesh, flat)
        dist.all_reduce(buf, group=mesh.group)
        all_reduces += 1
        flat = buf.to(flat.device) / mesh.size
        new, i = dict(deltas), 1
        for n, g in zip(param_names, grads):
            new[n] = deltas[n] - lr * flat[i:i + g.numel()].reshape(g.shape)
            i += g.numel()
        return new, flat[0]
    return step
