"""PyTorch port, geometry optimization on the CPU: steepest descent (host
loop and chunked) and one step of SD with line search against the JAX
package's at f64 on the am1_md golden batch; the warm batched L-BFGS's
logic against the JAX package's ``make_lbfgs_warm`` on a cheap analytic
surface (the module-level ``energy`` of both driver modules patched inside
the test) whose molecules take a plain descent, a forced accept and the
freeze after repeated forced accepts; the port's L-BFGS on the real energy
(the H3O+/NH4+/OH- ions).  The optax routes are in test_torch_lbfgs.py."""
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.drivers import opt as jopt
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu_torch.drivers import opt as topt
from pyseqm_tpu_torch.scf import SCFConfig

torch.set_num_threads(1)
CPU = "cpu"
SCF = dict(eps=1.0e-10, converger=(2,))


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _am1(golden):
    g = golden("am1_md")
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device=CPU,
                                  scf=SCFConfig(**SCF))
    ref = (pq.make_constants(dtype=jnp.float64),
           pq.load_element_tables("AM1", dtype=jnp.float64),
           pq.SEQMConfig(method="AM1", scf=JSCFConfig(**SCF)))
    return g["species"], g["coordinates"] * 1.03, (const, tables, cfg), ref


def test_steepest_descent_matches_jax(golden):
    """12 evaluations of SD (alpha 0.004, force_tol 0), the host loop and
    the chunked route (chunk 4), against the JAX host loop to 1e-10
    (tests/test_md.py holds the JAX pair to each other); the chunked
    route's whole-batch freeze ends where the host loop stops; one step of
    SD with line search against JAX's."""
    sp, co, port, ref = _am1(golden)
    # int32 species, as tests/test_md.py's _setup: the JAX force program
    # is then the one of its SD tests, compiled once for both files
    jsp, jco = jnp.asarray(sp, jnp.int32), jnp.asarray(co)
    xj, fj, ej = jopt.geometry_optimize_sd(*ref, jsp, jco, alpha=0.004,
                                           force_tol=0.0, max_evl=12)
    xa, fa, ea = topt.geometry_optimize_sd(*port, sp, co, alpha=0.004,
                                           force_tol=0.0, max_evl=12)
    xb, fb, eb = topt.geometry_optimize_sd(*port, sp, co, alpha=0.004,
                                           force_tol=0.0, max_evl=12,
                                           chunk=4)
    for x, f, e in ((xa, fa, ea), (xb, fb, eb)):
        np.testing.assert_allclose(_np(x), np.asarray(xj), rtol=0, atol=1e-10)
        assert abs(float(f) - float(fj)) < 1e-10
        assert abs(float(e) - float(ej)) < 1e-10
    # a tolerance met at the 6th evaluation, inside the second chunk
    tol = float(fa) * 1.5
    xh, fh, _ = topt.geometry_optimize_sd(*port, sp, co, alpha=0.004,
                                          force_tol=tol, max_evl=12)
    xc, fc, _ = topt.geometry_optimize_sd(*port, sp, co, alpha=0.004,
                                          force_tol=tol, max_evl=12, chunk=4)
    assert float(fh) <= tol and float(fc) <= tol
    np.testing.assert_array_equal(_np(xc), _np(xh))

    xj, fj = jopt.geometry_optimize_sd_ls(*ref, jsp, jco, alpha=0.004,
                                          force_tol=0.0, max_evl=1)
    xt, ft = topt.geometry_optimize_sd_ls(*port, sp, co, alpha=0.004,
                                          force_tol=0.0, max_evl=1)
    np.testing.assert_allclose(_np(xt), np.asarray(xj), rtol=0, atol=1e-10)
    assert abs(float(ft) - float(fj)) < 1e-10


class _Out(NamedTuple):
    Hf: object
    P: object


# per molecule: a smooth anisotropic well, a stiff well (the first model
# step overshoots at every backtrack: one forced accept) and a well under
# a fine staircase that autodiff does not see (every trial step climbs:
# forced accepts until the freeze)
_W = np.array([[1.0, 0.0, 0.0], [0.0, 1.0e3, 0.0], [0.0, 0.0, 1.0e3]])
_C = np.linspace(-0.3, 0.4, 6).reshape(2, 3)


def _surface(xp, x, w, c, curv):
    d = x - c
    smooth = (curv * d * d).sum(axis=(1, 2)) + 0.1 * (d ** 4).sum(axis=(1, 2))
    stiff = (d * d).sum(axis=(1, 2))
    stairs = stiff * 1e-3 + xp.floor(1.0e4 * (1.0 - d[:, 0, 0]))
    return w[:, 0] * smooth + w[:, 1] * stiff + w[:, 2] * stairs


def _fake_energy_jax(const, tables, cfg, species, coords, learned=None,
                     P0=None, charges=None):
    curv = jnp.asarray(np.arange(1, 7, dtype=np.float64).reshape(2, 3))
    Hf = _surface(jnp, coords, jnp.asarray(_W), jnp.asarray(_C), curv)
    return _Out(Hf, P0 + 1e-3 * Hf[:, None, None])


def _fake_energy_torch(const, tables, cfg, species, coords, learned=None,
                       P0=None, charges=None):
    t = lambda a: torch.tensor(a, dtype=coords.dtype)  # noqa: E731
    curv = t(np.arange(1, 7, dtype=np.float64).reshape(2, 3))
    Hf = _surface(torch, coords, t(_W), t(_C), curv)
    return _Out(Hf, P0 + 1e-3 * Hf[:, None, None])


def test_warm_lbfgs_logic_matches_jax(monkeypatch):
    """The full warm L-BFGS state after each of fifteen 2-iteration chunks
    against the JAX package's to 1e-10, nit/done/bad/idx exact: the E=+inf
    bootstrap, the two-loop recursion with empty slots, the sy <= 1e-10
    history skip, Armijo backtracking, the forced accept and the freeze."""
    monkeypatch.setattr(jopt, "energy", _fake_energy_jax)
    monkeypatch.setattr(topt, "energy", _fake_energy_torch)
    sp = np.ones((3, 2), np.int64)
    co = np.random.default_rng(2).uniform(-0.5, 0.5, (3, 2, 3)) + _C
    co[2, 0, 0] = _C[0, 0] + 0.5
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device=CPU)
    jconst = pq.make_constants(dtype=jnp.float64)
    jinit, jrun = jopt.make_lbfgs_warm(jconst, None, None, jnp.asarray(sp),
                                       chunk=2, force_tol=1e-6)
    tinit, trun = topt.make_lbfgs_warm(const, tables, cfg, sp, chunk=2,
                                       force_tol=1e-6)
    js, ts = jinit(jnp.asarray(co)), tinit(torch.tensor(co))
    bad_seen, skipped_seen = 0, False
    for _ in range(15):
        js, jE, jg = jrun(js)
        ts, tE, tg = trun(ts)
        # rho = 1/(s.y) reaches 2e7 near a minimum: relative there
        for f in ("x", "E", "g", "P", "S", "Y", "rho"):
            np.testing.assert_allclose(_np(getattr(ts, f)),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-10, atol=1e-10, err_msg=f)
        for f in ("idx", "nit"):
            assert int(getattr(ts, f)) == int(getattr(js, f)), f
        for f in ("done", "bad"):
            np.testing.assert_array_equal(_np(getattr(ts, f)),
                                          np.asarray(getattr(js, f)), f)
        assert abs(float(tg) - float(jg)) < 1e-10
        bad_seen = max(bad_seen, int(_np(ts.bad)[2]))
        skipped_seen |= bool((_np(ts.rho) == 0).any())
    # the staircase molecule froze on forced accepts (its bad count resets
    # once it is done), the others converged
    assert bool(_np(ts.done).all()) and bad_seen >= 2
    assert np.abs(_np(ts.g)[:2]).max() <= 1e-6 < np.abs(_np(ts.g)[2]).max()
    assert skipped_seen


def test_lbfgs_relaxes_ions(golden):
    """The port's warm L-BFGS on the real energy: H3O+/NH4+/OH- from a 5%
    stretch reach max|F| <= 1e-3 with no Hf rising (the per-molecule
    charges thread through every SCF); tests/test_md.py's
    test_charged_geometry_optimization on the port."""
    g = golden("am1_charged")
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device=CPU,
                                  scf=SCFConfig(**SCF))
    co = torch.tensor(g["coordinates"] * 1.05)
    x, ferr, nit = topt.geometry_optimize_lbfgs(
        const, tables, cfg, g["species"], co, force_tol=1e-3, max_evl=80,
        chunk=10, charges=g["charges"])
    assert float(ferr) <= 1e-3 and 0 < nit <= 80
    E0 = pt.energy(const, tables, cfg, g["species"], co,
                   charges=g["charges"]).Hf
    E1 = pt.energy(const, tables, cfg, g["species"], x,
                   charges=g["charges"]).Hf
    assert bool((E1 <= E0 + 1e-10).all())
