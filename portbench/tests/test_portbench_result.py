"""The result line: its keys, the numbers compared beside their limits as
the last key, and no result without a card."""
import json
import subprocess
import sys

from _harness import BENCH, ROOT, SEED, run_cpu


def test_result_keys_timed_and_traced():
    for trace in (False, True):
        res = run_cpu("xl-small", trace=trace)
        keys = list(res)
        assert keys[:3] == ["correct", "attempted", "failed"]
        assert {"metrics", "device"} <= set(keys) and keys[-1] == "checks"
        assert res["correct"] is True and res["failed"] == 0
        assert set(res["checks"]) == set(json.load(open(
            f"{BENCH}/limits/xl-small.json"))) | {"failed"}
        for c in res["checks"].values():
            assert c["value"] <= c["limit"]
        dev = res["device"]
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
        if trace:
            assert "busy_s" in dev and "window_s" in dev
            assert len(res["breakdown"]["device_ops"]) <= 10
            assert len(res["breakdown"]["idle_gaps"]) <= 10
        else:
            assert "setup_s" in res["metrics"]
            json.dumps(res)


def test_single_point_result():
    res = run_cpu("sp-small")
    assert res["correct"] is True
    assert set(res["metrics"]) == {"sp_mols_per_s", "setup_s"}


def test_no_card_no_result():
    res = subprocess.run(
        [sys.executable, f"{BENCH}/run.py", "--workload", "xl-small",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
