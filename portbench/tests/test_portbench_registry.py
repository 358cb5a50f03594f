"""Discovery by name: a configuration, traffic mix, limits file and metric
reader added as files, with their entries in BENCHMARK.json, are found
without a change to any other file."""
import json
import os
import shutil

from _harness import BENCH, ROOT
from pbench import registry


def test_added_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(bench / "configs" / "am1-small-organics.json"))
    cfg["name"] = "dummy-config"
    json.dump(cfg, open(bench / "configs" / "dummy-config.json", "w"))
    tr = json.load(open(bench / "traffic" /
                        (spec["workloads"][0]["traffic"] + ".json")))
    tr["batch"] = 7
    json.dump(tr, open(bench / "traffic" / "dummy-traffic.json", "w"))
    json.dump({"force_err": 1.0}, open(bench / "limits" / "dummy.json", "w"))
    (bench / "metrics" / "dummy_metric.md.py").write_text(
        "def read(data):\n    return data['answer']\n")
    spec["configs"].append({"name": "dummy-config", "source": "test",
                            "file": "portbench/configs/dummy-config.json",
                            "reduced": []})
    spec["workloads"].append({"name": "dummy", "config": "dummy-config",
                              "traffic": "dummy-traffic", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "dummy_metric.md", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "setup_s",
                              "workloads": ["dummy"]})
    json.dump(spec, open(root / "BENCHMARK.json", "w"))
    got = registry.load(str(root), "dummy", bench_dir=str(bench))
    assert got["config"]["name"] == "dummy-config"
    assert got["traffic"]["batch"] == 7
    assert got["limits"] == {"force_err": 1.0}
    assert [m["name"] for m in got["per_layer"]] == ["dummy_metric.md"]
    assert "md_mol_steps_per_s" not in [m["name"] for m in got["end_to_end"]]
    assert "setup_s" in [m["name"] for m in got["end_to_end"]]
    assert registry.read_per_layer(got, {"answer": 3}) == {
        "dummy_metric.md": {"value": 3.0, "unit": "%"}}
    # a reader that finds nothing leaves its metric out
    assert registry.read_per_layer(got, {"answer": None}) == {}


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in spec["per_layer"]:
        assert callable(registry.reader(BENCH, m["name"]))
    for w in spec["workloads"]:
        got = registry.load(ROOT, w["name"])
        assert got["limits"] and got["traffic"]["batch"] > 0
