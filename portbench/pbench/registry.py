"""Finding a cell's parts by name.  ``BENCHMARK.json`` names the cell's
configuration and traffic, and each part of the cell is a file of its own
under the benchmark's directory:

- the configuration: the ``file`` of its ``configs`` entry;
- the traffic mix: ``traffic/<traffic>.json``;
- the cell's limits of ``correct``: ``limits/<workload>.json``;
- each per-layer metric's reader: ``metrics/<metric>.py`` (``read``);
- the molecules, where the configuration sets ``"geometries": "<g>"``:
  ``molecules/<g>.json`` (read by ``inputs.templates``; otherwise the
  configuration names ``molecules`` of ``inputs.MOLECULES`` or
  ``alkane_carbons``);
- the learned-parameter model, where the configuration sets
  ``"learned": "<m>"``: ``learned/<m>.py`` (``program(device, dtype)``, the
  port's side, built from its public entry points) and
  ``reference/learned/<m>.py`` (``reference(device, dtype)``, plain torch
  importing nothing of the port, and ``ELEMENTS``, the atomic numbers it
  covers); each returns the callable the port's ``learned=`` takes,
  f(species, coordinates) -> {parameter name: (nmol, A)};
- the cell kind, the traffic's ``kind``: ``cells.KINDS`` (``xlbomd``,
  ``single_point``), else ``kinds/<kind>.py``, whose ``Cell`` subclasses
  ``cells.Cell``.

A later cell, configuration, metric, molecule set, parameter model or
cell kind is added by adding files and entries, without editing any file
that is here."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(root: str, workload: str, bench_dir: str = HERE) -> dict:
    """The spec of one cell: its BENCHMARK.json entries, configuration,
    traffic, limits and the metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = _json(os.path.join(root, entry["file"]))
    return {
        "name": workload,
        "cell": cell,
        "chips": int(cell["chips"]),
        "config": config,
        "traffic": _json(os.path.join(bench_dir, "traffic",
                                      cell["traffic"] + ".json")),
        "limits": _json(os.path.join(bench_dir, "limits",
                                     workload + ".json")),
        "end_to_end": [m for m in bench["end_to_end"]
                       if applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"]
                      if applies(m, workload)],
        "learned": (learned(bench_dir, config["learned"])
                    if "learned" in config else None),
        "bench_dir": bench_dir,
    }


def _module(path: str, prefix: str, name: str):
    """The module of the file ``path``, loaded under a name of its own."""
    mod_name = prefix + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: str, metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module(os.path.join(bench_dir, "metrics", metric + ".py"),
                   "portbench_metric_", metric).read


def learned(bench_dir: str, name: str) -> dict:
    """The two sides of the learned-parameter model ``name``: ``program``
    (``learned/<name>.py``) and ``reference`` (``reference/learned/
    <name>.py``), each a function (device, dtype) -> callable, and
    ``elements``, the atomic numbers the reference side covers."""
    prog = _module(os.path.join(bench_dir, "learned", name + ".py"),
                   "portbench_learned_", name)
    ref = _module(os.path.join(bench_dir, "reference", "learned",
                               name + ".py"),
                  "portbench_reference_learned_", name)
    return {"name": name, "program": prog.program,
            "reference": ref.reference,
            "elements": tuple(int(z) for z in ref.ELEMENTS)}


def kind(bench_dir: str, name: str) -> type:
    """The cell class of the traffic kind ``name``: ``cells.KINDS``, else
    the ``Cell`` of ``kinds/<name>.py``, a subclass of ``cells.Cell``."""
    from . import cells
    if name in cells.KINDS:
        return cells.KINDS[name]
    cls = _module(os.path.join(bench_dir, "kinds", name + ".py"),
                  "portbench_kind_", name).Cell
    if not (isinstance(cls, type) and issubclass(cls, cells.Cell)):
        raise TypeError(f"kinds/{name}.py: Cell is not a subclass of "
                        "cells.Cell")
    return cls


def read_per_layer(spec: dict, data: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read for; a reader that finds nothing returns None and the metric
    is left out."""
    out = {}
    for m in spec["per_layer"]:
        value = reader(spec["bench_dir"], m["name"])(data)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

