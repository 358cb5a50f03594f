"""Shared arithmetic of the per-layer metric readers (``metrics/``).

Each reader takes the traced run's data: ``a`` (a trace.Session over the
profiled steps or requests), ``b`` (one step or request with the
outermost calls into the port's ops/ modules recorded) and the cell's
counts (``batch``, ``cells_k3``, ``n_solver``, ``k1_iterations``,
``k2_sweeps``, ``k2_per_request``).  A reader returns None where the
trace holds nothing to read; a roofline share is never made up as 0."""
from __future__ import annotations

from . import roofline

INTEGRAL_MODULES = ("hcore.py", "overlap.py", "overlap_general.py",
                    "tetci.py", "multipole.py")


def roofline_share(sess, needles, least_s_per_launch) -> float:
    """100 x (least time of the launches) / (their kernel time)."""
    ks = sess.kernels(*needles)
    if not ks:
        return None
    t = sum(b - a for a, b, _ in ks) * 1e-9
    return 100.0 * least_s_per_launch * len(ks) / t


def k3_roofline(data):
    sess, total, least = data["a"], 0.0, 0.0
    for kind in ("fwd", "bwd"):
        ks = sess.kernels("wapply_" + kind)
        total += sum(b - a for a, b, _ in ks) * 1e-9
        least += len(ks) * roofline.k3_least(kind, data["cells_k3"])[0]
    return 100.0 * least / total if total > 0 else None


def k1_roofline(data):
    its = data.get("k1_iterations")
    if not its:
        return None
    return roofline_share(data["a"], ("sp2_",),
                          roofline.k1_least(its, data["n_solver"])[0])


def k2_roofline(data):
    sw = data.get("k2_sweeps")
    if not sw:
        return None
    # the sampled molecules' mean sweeps stand for the whole batch
    mean = sum(sw) / len(sw)
    return roofline_share(data["a"], ("eigh_",),
                          roofline.k2_least([mean] * data["batch"],
                                            data["n_solver"])[0])


def idle_share(data):
    sess = data["a"]
    if not sess.device:
        return None
    busy, _ = sess.busy()
    return 100.0 * max(0.0, 1.0 - busy / sess.window_s)


def launches_per_unit(data):
    sess = data["a"]
    if not sess.launches:
        return None
    return sess.launch_count() / sess.units


def backward_ms(data):
    sess = data["a"]
    if not sess.device:
        return None
    return 1e3 * sess.backward_seconds() / sess.units


def integrals_ms(data):
    sess = data["b"]
    if not sess.device:
        return None
    s = sess.module_seconds(INTEGRAL_MODULES)
    return None if s is None else 1e3 * s / sess.units

