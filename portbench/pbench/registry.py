"""Finding a cell's parts by name: ``BENCHMARK.json`` names the cell's
configuration and traffic; each is a file of its own (the configuration's
``file``, ``traffic/<traffic>.json``), as are the cell's limits
(``limits/<workload>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``).  A later cell or metric is added by adding
files and entries, without editing any file that is here."""
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
    return {
        "name": workload,
        "cell": cell,
        "chips": int(cell["chips"]),
        "config": _json(os.path.join(root, entry["file"])),
        "traffic": _json(os.path.join(bench_dir, "traffic",
                                      cell["traffic"] + ".json")),
        "limits": _json(os.path.join(bench_dir, "limits",
                                     workload + ".json")),
        "end_to_end": [m for m in bench["end_to_end"]
                       if applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"]
                      if applies(m, workload)],
        "bench_dir": bench_dir,
    }


def reader(bench_dir: str, metric: str) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    mod_name = "portbench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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

