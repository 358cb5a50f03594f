"""The system under test: the PyTorch port, built through its public
entry points as a user would (``pyseqm_tpu_torch.build``, ``force``,
``drivers.xlbomd.XLBOMD``).  The benchmark reads from the port only what
it produces, its launch counters and its kernels' names."""
from __future__ import annotations

import numpy as np
import torch


def build(config: dict, scf: dict, species: np.ndarray, device,
          row3: bool = False):
    """(const, tables, cfg, K) for the configuration: its method and dtype,
    the static packed layout (``pack_heavy`` = ``packed_heavy_count``), the
    traffic's SCF settings, and ``row3`` where the molecules hold an
    element of row 3."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.scf import SCFConfig
    if config["layout"] != "static_packed":
        raise ValueError(f"unknown layout {config['layout']!r}")
    K = pt.packed_heavy_count(species)
    kw = dict(scf)
    kw["converger"] = tuple(kw["converger"])
    const, tables, cfg = pt.build(
        config["method"], dtype=getattr(torch, config["dtype"]),
        device=device, scf=SCFConfig(pack_heavy=K, **kw), row3=row3)
    return const, tables, cfg, K


def xlbomd(const, tables, cfg, traffic: dict, learned=None):
    """The XL-BOMD driver; ``learned``: the parameter model's callable, or
    None (the port's default: the method's tables)."""
    from pyseqm_tpu_torch.drivers.md import MDConfig
    from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
    return XLBOMD(const, tables, cfg, MDConfig(timestep=traffic["dt_fs"]),
                  k=traffic["k"], learned=learned)


def force(const, tables, cfg, species, coords, learned=None):
    import pyseqm_tpu_torch as pt
    return pt.force(const, tables, cfg, species, coords, learned=learned)


def eigh_launches() -> int:
    """The port's counter of K2 (Jacobi eigensolver) launches."""
    from pyseqm_tpu_torch.ops import eigh_kernel
    return eigh_kernel.launches
