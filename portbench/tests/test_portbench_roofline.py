"""The frozen operation and byte counts of K1, K2 and K3 against the
bounds that PERF.md's table of kernels gives at its shapes: K3 forward
0.0031 ms at 40,960 cells (bytes), K1 0.0275 ms at (10240, 16, 16) with
17.2 mean iterations (operations), K2 0.0215 ms at n = 16 with 5.47 mean
sweeps (operations)."""
import pytest

from pbench import roofline


def test_k3_bound():
    t, by = roofline.k3_least("fwd", 40960)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.0031, abs=5e-5)
    t, by = roofline.k3_least("bwd", 40960)
    assert by == "bytes" and t * 1e3 == pytest.approx(0.0054, abs=5e-5)


def test_k1_bound():
    t, by = roofline.k1_least([17.2] * 10240, 16)
    assert by == "operations" and t * 1e3 == pytest.approx(0.0275, abs=5e-5)


def test_k2_bound():
    t, by = roofline.k2_least([5.47] * 10240, 16)
    assert by == "operations" and t * 1e3 == pytest.approx(0.0215, abs=5e-5)
