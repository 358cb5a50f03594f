"""Nothing the benchmark runs imports JAX or the JAX package: a whole
cell run (set-up, window, trace reading, reference and check) in a fresh
interpreter leaves no such module loaded, names compared whole by their
top-level part (``pyseqm_tpu_torch`` is not ``pyseqm_tpu``).  That holds
too for a cell whose configuration names a learned-parameter model."""
import subprocess
import sys

from _harness import BENCH, ROOT, toy_checkout

PROBE = r"""
import sys
sys.path[:0] = [{bench!r}, {tests!r}, {root!r}]
from _harness import run_cpu
run_cpu("xl-small", trace=True)
run_cpu("sp-small")
run_cpu("toy-xl", root={toy_root!r}, bench={toy_bench!r})
import run
print("FOUND", run.loaded_forbidden())
print("PORT", "pyseqm_tpu_torch" in sys.modules)
"""


def test_cell_run_loads_no_jax(tmp_path):
    toy_root, toy_bench = toy_checkout(tmp_path)
    code = PROBE.format(bench=BENCH, tests=BENCH + "/tests", root=ROOT,
                        toy_root=toy_root, toy_bench=toy_bench)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOUND []" in res.stdout
    assert "PORT True" in res.stdout


def test_names_compared_whole():
    import run
    saved = dict(sys.modules)
    try:
        sys.modules["pyseqm_tpu_torch_lookalike"] = sys
        assert "pyseqm_tpu" not in run.loaded_forbidden()
        sys.modules["pyseqm_tpu.ops"] = sys
        assert "pyseqm_tpu" in run.loaded_forbidden()
        sys.modules["jax.numpy"] = sys
        assert "jax" in run.loaded_forbidden()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
