"""PyTorch port, the optax-routed L-BFGS on the CPU at float64: the port's
``make_lbfgs`` (zoom, backtracking, none) and ``make_lbfgs_chunk`` state
for state against the JAX package's, which run optax, on cheap analytic
surfaces (the module-level ``energy`` of both driver modules patched
inside each test): a smooth anisotropic well, a V-shaped valley and a
gradient pointing uphill (the zoom search fails and takes optax's
fallback step), a far, shallow well (the interval search must grow the
step); the dispatch
of ``geometry_optimize_lbfgs``; and on the real energy, the optax route
reaching the warm L-BFGS's minimum."""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.drivers import opt as jopt
from pyseqm_tpu_torch.drivers import opt as topt
from pyseqm_tpu_torch.scf import SCFConfig

torch.set_num_threads(1)
CPU = "cpu"
TOL = 1e-10


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


class _Out(NamedTuple):
    Hf: object
    P: object


_C = np.linspace(-0.3, 0.4, 6).reshape(2, 3)
_CURV = np.arange(1, 7, dtype=np.float64).reshape(2, 3)


def _well(xp, x, kind):
    torch_ = xp is torch
    d = x - (torch.tensor(_C) if torch_ else xp.asarray(_C))
    curv = torch.tensor(_CURV) if torch_ else xp.asarray(_CURV)
    smooth = (curv * d * d).sum(axis=(1, 2)) + 0.1 * (d ** 4).sum(axis=(1, 2))
    if kind == "smooth":     # anisotropic quartic well
        return smooth
    if kind == "uphill":     # the smooth well's value, the gradient of -1x it
        held = smooth.detach() if torch_ else jax.lax.stop_gradient(smooth)
        return 2.0 * held - smooth
    if kind == "kink":       # a V-shaped valley: |slope| never shrinks
        return (curv * d).sum(axis=(1, 2)).__abs__()
    # "far": a shallow well 40 A away, reached by growing steps
    return 1e-3 * (curv * (d - 40.0) ** 2).sum(axis=(1, 2))


def _patch(monkeypatch, kind):
    def fake_jax(const, tables, cfg, species, coords, learned=None, P0=None,
                 charges=None):
        Hf = _well(jnp, coords, kind)
        return _Out(Hf, None if P0 is None else P0 + 1e-3 * Hf[:, None, None])

    def fake_torch(const, tables, cfg, species, coords, learned=None,
                   P0=None, charges=None):
        Hf = _well(torch, coords, kind)
        return _Out(Hf, None if P0 is None else P0 + 1e-3 * Hf[:, None, None])

    monkeypatch.setattr(jopt, "energy", fake_jax)
    monkeypatch.setattr(topt, "energy", fake_torch)


def _start(seed=2, nmol=3):
    rng = np.random.default_rng(seed)
    return np.ones((nmol, 2), np.int64), rng.uniform(-0.5, 0.5,
                                                      (nmol, 2, 3)) + _C


def _port():
    return pt.build("AM1", dtype=torch.float64, device=CPU)


def _assert_states(ts, js, linesearch):
    """The port's LBFGSState against optax's (ScaleByLBFGSState, scale,
    line search) tuple."""
    lb = js[0]
    assert ts.count == int(lb.count)
    for f in ("params", "updates", "diff_params_memory",
              "diff_updates_memory", "weights_memory"):
        np.testing.assert_allclose(_np(getattr(ts, f)),
                                   np.asarray(getattr(lb, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)
    if linesearch == "none":
        return
    ls = js[2]
    np.testing.assert_allclose(ts.learning_rate, float(ls.learning_rate),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts.value, float(ls.value), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(ts.grad), np.asarray(ls.grad), rtol=TOL,
                               atol=TOL)
    assert ts.num_linesearch_steps == int(ls.info.num_linesearch_steps)
    np.testing.assert_allclose(ts.decrease_error,
                               float(ls.info.decrease_error), rtol=TOL,
                               atol=TOL)
    if linesearch == "zoom":
        np.testing.assert_allclose(ts.curvature_error,
                                   float(ls.info.curvature_error), rtol=TOL,
                                   atol=TOL)


def _run_both(kind, linesearch, iters, seed=2, nmol=3):
    """``iters`` outer iterations of both packages' make_lbfgs from the
    same start, every output and state compared after each; returns the
    port's states."""
    sp, co = _start(seed, nmol)
    const, tables, cfg = _port()
    jinit, jstep = jopt.make_lbfgs(pq.make_constants(dtype=jnp.float64),
                                   None, None, jnp.asarray(sp),
                                   linesearch=linesearch)
    tinit, tstep = topt.make_lbfgs(const, tables, cfg, sp,
                                   linesearch=linesearch)
    jx, tx = jnp.asarray(co), torch.tensor(co)
    js, ts = jinit(jx), tinit(tx)
    states = []
    for _ in range(iters):
        jx, js, jv, jg = jstep(jx, js)
        tx, ts, tv, tg = tstep(tx, ts)
        np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=0, atol=TOL)
        np.testing.assert_allclose(float(tv), float(jv), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(tg), float(jg), rtol=TOL, atol=TOL)
        _assert_states(ts, js, linesearch)
        states.append(ts)
    return states


@pytest.mark.parametrize("linesearch", ["zoom", "backtracking", "none"])
def test_lbfgs_matches_jax(monkeypatch, linesearch):
    """12 iterations on the smooth well: coordinates, value and max|g|
    after each, and every field of optax's state (the memory ring, the
    identity scale's inputs, the line search's step, value, gradient and
    info) to 1e-10."""
    _patch(monkeypatch, "smooth")
    states = _run_both("smooth", linesearch, 12)
    assert states[-1].count == 12
    if linesearch != "none":
        # the batch descended to near its minimum
        assert states[-1].value < states[0].value


@pytest.mark.parametrize("kind,iters", [("kink", 3), ("uphill", 1)])
def test_zoom_failure_matches_jax(monkeypatch, kind, iters):
    """The zoom search's failures and optax's fallback, state for state.
    On a V-shaped valley (one molecule) the slope's magnitude never
    shrinks, so no step meets the curvature criterion: the interval
    narrows on the kink below the step precision and the search returns
    its best step with sufficient decrease.  With a gradient pointing
    uphill (the value of a well, the gradient of its negative) every
    trial climbs although the slope says descent: the search narrows on
    0 until its 20 steps run out (one iteration compared: the pair it
    stores is rounding noise)."""
    _patch(monkeypatch, kind)
    states = _run_both(kind, "zoom", iters, nmol=1 if kind == "kink" else 3)
    assert all(s.failed and s.curvature_error > 0.0 for s in states)
    assert all(s.learning_rate > 0.0 for s in states)
    if kind == "uphill":
        assert states[0].num_linesearch_steps == 20


def test_zoom_interval_grows_matches_jax(monkeypatch):
    """40 A from a shallow well the first direction is capped at unit
    length: the interval search doubles the step until the slope turns,
    then zooms, state for state."""
    _patch(monkeypatch, "far")
    states = _run_both("far", "zoom", 4)
    assert states[0].learning_rate > 4.0
    assert not any(s.failed for s in states)


def test_lbfgs_chunk_matches_jax(monkeypatch):
    """make_lbfgs_chunk (zoom, chunk 5) against JAX's: the state after
    each chunk, the whole-state freeze at max|g| <= force_tol inside a
    chunk, and nit counting only the iterations that advanced (plus the
    one that saw convergence)."""
    _patch(monkeypatch, "smooth")
    sp, co = _start()
    const, tables, cfg = _port()
    force_tol = 1e-6
    jinit, jrun = jopt.make_lbfgs_chunk(
        pq.make_constants(dtype=jnp.float64), None, None, jnp.asarray(sp),
        chunk=5, force_tol=force_tol)
    tinit, trun = topt.make_lbfgs_chunk(const, tables, cfg, sp, chunk=5,
                                        force_tol=force_tol)
    jx, tx = jnp.asarray(co), torch.tensor(co)
    js, ts = jinit(jx), tinit(tx)
    jdone, jnit = jnp.zeros((), bool), jnp.zeros((), jnp.int32)
    tdone, tnit = False, 0
    for _ in range(8):
        jx, js, jdone, jnit, jv, jg = jrun(jx, js, jdone, jnit)
        tx, ts, tdone, tnit, tv, tg = trun(tx, ts, tdone, tnit)
        np.testing.assert_allclose(_np(tx), np.asarray(jx), rtol=0, atol=TOL)
        np.testing.assert_allclose(float(tv), float(jv), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(tg), float(jg), rtol=TOL, atol=TOL)
        assert tdone == bool(jdone) and tnit == int(jnit)
        _assert_states(ts, js, "zoom")
        if tdone:
            break
    assert tdone and tnit % 5 != 0 and float(tg) <= force_tol


@pytest.mark.parametrize("kw", [dict(), dict(chunk=4, linesearch="backtracking"),
                                dict(chunk=4)])
def test_geometry_optimize_lbfgs_dispatch(monkeypatch, kw):
    """geometry_optimize_lbfgs routes as the JAX package's: chunk=0 to the
    zoom host loop, chunk > 0 with a line search to the chunked optax
    route, chunk > 0 without one to the warm L-BFGS; the same coordinates,
    max|g| and iteration count."""
    _patch(monkeypatch, "smooth")
    sp, co = _start()
    const, tables, cfg = _port()
    args = dict(force_tol=1e-5, max_evl=40, **kw)
    xj, fj, ij = jopt.geometry_optimize_lbfgs(
        pq.make_constants(dtype=jnp.float64), None, None, jnp.asarray(sp),
        jnp.asarray(co), **args)
    xt, ft, it = topt.geometry_optimize_lbfgs(const, tables, cfg, sp,
                                              torch.tensor(co), **args)
    np.testing.assert_allclose(_np(xt), np.asarray(xj), rtol=0, atol=TOL)
    assert abs(float(ft) - float(fj)) < TOL and float(ft) <= 1e-5
    assert int(it) == int(ij)


def test_optax_route_reaches_warm_minimum(golden):
    """On the real energy (H3O+/NH4+/OH-, 5% stretched, float64): the
    zoom host loop and the warm L-BFGS reach the same minimum to 1e-8 eV
    per molecule (tests/test_md.py's chunked-parity check on the port)."""
    g = golden("am1_charged")
    const, tables, cfg = pt.build(
        "AM1", dtype=torch.float64, device=CPU,
        scf=SCFConfig(eps=1.0e-10, converger=(2,)))
    sp, ch = g["species"], g["charges"]
    co = torch.tensor(g["coordinates"] * 1.05)
    xl, fl, il = topt.geometry_optimize_lbfgs(const, tables, cfg, sp, co,
                                              force_tol=1e-4, max_evl=60,
                                              charges=ch)
    xm, fm, im = topt.geometry_optimize_lbfgs(const, tables, cfg, sp, co,
                                              force_tol=1e-4, max_evl=60,
                                              chunk=10, charges=ch)
    assert float(fl) <= 1e-4 and float(fm) <= 1e-4 and 0 < il <= 60
    El = pt.energy(const, tables, cfg, sp, xl, charges=ch).Hf
    Em = pt.energy(const, tables, cfg, sp, xm, charges=ch).Hf
    np.testing.assert_allclose(_np(El), _np(Em), rtol=0, atol=1e-8)
