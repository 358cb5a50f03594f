"""PyTorch port, the SCF's convergers and backward modes on the CPU at f64:
learned-parameter and coordinate gradients through backward mode 1 (the
recursive adjoint) and mode 2 (the unrolled iterations) against the
am1_param_grads goldens at the JAX package's own tolerances and against
the JAX package's gradients of the same loss (the configs of
tests/test_grads.py, one jitted program per mode, traced once per file);
the mode-1 gradient against central differences, with and without the
integrals' remat; the HOMO energy's parameter gradient (mode 1,
eig=True) against JAX; the three convergers' common fixed point; the
failure policies forward and backward; and the configurations that
raise."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu_torch import scf as tscf
from pyseqm_tpu_torch.scf import SCFConfig, SCFConvergenceError
from test_grads import _hf_and_grads, _scatter_ref

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# the port against the JAX package at f64: the same fixed point and the
# same adjoint iterations, rounding apart
TOL_JAX = 1e-8


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _golden(name):
    return np.load(os.path.join(GOLDEN, name + ".npz"))


def _cfg(mode, **kw):
    """tests/test_grads.py's configuration of each backward mode."""
    conv = (2,) if mode == 1 else (1,)
    return pt.SEQMConfig(method="AM1", scf=SCFConfig(
        eps=1.0e-10, converger=conv, backward=mode, backward_eps=1.0e-8,
        backward_scan_iters=60), **kw)


def _tables():
    return (pt.make_constants(dtype=torch.float64, device="cpu"),
            pt.load_element_tables("AM1", device="cpu", dtype=torch.float64))


def _learned(tables, sp):
    """Per-atom U_ss and zeta_s from the tables (test_grads.py's learned
    parameters), zero on padding."""
    return {k: _scatter_ref(sp, _np(tables[k])[sp[sp > 0]])
            for k in ("U_ss", "zeta_s")}


@functools.lru_cache(maxsize=None)
def jax_param_grads(mode):
    """The JAX package's Hf and gradients of sum(Hf) by the learned U_ss,
    zeta_s and the coordinates (test_grads._hf_and_grads)."""
    g = _golden("am1_param_grads")
    sp = g["species"]
    jc = pq.make_constants(dtype=jnp.float64)
    jt = pq.load_element_tables("AM1", dtype=jnp.float64)
    learned = {k: jnp.asarray(v) for k, v in _learned(
        {k: np.asarray(jt[k]) for k in ("U_ss", "zeta_s")}, sp).items()}
    hf, gl, gc = _hf_and_grads(mode, jc, jt, jnp.asarray(sp, jnp.int32),
                               jnp.asarray(g["coordinates"]), learned)
    return (np.asarray(hf), np.asarray(gl["U_ss"]), np.asarray(gl["zeta_s"]),
            np.asarray(gc))


def _port_grads(mode, learned=None, **kw):
    """The port's (Hf, dHf/dU_ss, dHf/dzeta_s, dHf/dR) on the golden
    batch."""
    g = _golden("am1_param_grads")
    sp = g["species"]
    const, tables = _tables()
    learned = learned or _learned(tables, sp)
    lt = {k: torch.tensor(v, requires_grad=True) for k, v in learned.items()}
    co = torch.tensor(g["coordinates"], requires_grad=True)
    out = pt.energy(const, tables, _cfg(mode, **kw), sp, co, learned=lt)
    gU, gz, gc = torch.autograd.grad(out.Hf.sum(), (lt["U_ss"],
                                                    lt["zeta_s"], co))
    return [_np(t) for t in (out.Hf, gU, gz, gc)]


@pytest.mark.parametrize("mode", [1, 2])
def test_param_and_coord_grads_match_jax_and_golden(mode):
    g = _golden("am1_param_grads")
    m = g["species"] > 0
    hf, gU, gz, gc = _port_grads(mode)
    # the goldens at test_grads.py's tolerances
    np.testing.assert_allclose(hf, g[f"Hf_m{mode}"], atol=1e-6)
    np.testing.assert_allclose(gU[m], g[f"gU_ss_m{mode}"], atol=2e-5)
    np.testing.assert_allclose(gz[m], g[f"gzeta_s_m{mode}"], atol=2e-5)
    np.testing.assert_allclose(gc, g[f"gcoord_m{mode}"], atol=2e-5)
    for a, b, what in zip((hf, gU, gz, gc), jax_param_grads(mode),
                          ("Hf", "dU_ss", "dzeta_s", "dR")):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_JAX,
                                   err_msg=f"mode {mode} {what}")


@pytest.mark.parametrize("remat", [False, True])
def test_adjoint_param_grad_finite_difference(remat):
    """Mode-1 dHf/dU_ss of the carbon of molecule 0 against central
    differences (test_grads.py: h 1e-5, atol 5e-6); with the integrals'
    remat (torch.utils.checkpoint) the adjoint's cotangents flow through
    the recomputed build to the same gradients."""
    g = _golden("am1_param_grads")
    sp = g["species"]
    const, tables = _tables()
    learned = _learned(tables, sp)
    _, gU, gz, gc = _port_grads(1, remat_integrals=remat)
    if remat:
        for a, b in zip((gU, gz, gc), _port_grads(1)[1:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    h = 1e-5
    cfg = _cfg(1, remat_integrals=remat)

    def hf_with(delta):
        lt = {k: torch.tensor(v) for k, v in learned.items()}
        lt["U_ss"][0, 1] += delta
        return float(pt.energy(const, tables, cfg, sp,
                               torch.tensor(g["coordinates"]),
                               learned=lt).Hf.sum())
    num = (hf_with(h) - hf_with(-h)) / (2 * h)
    np.testing.assert_allclose(gU[0, 1], num, atol=5e-6)


@functools.lru_cache(maxsize=None)
def jax_homo_grad():
    """tests/test_second_order.py::test_homo_energy_param_grad's HOMO
    energy and its gradient by U_ss (mode 1, eig=True), in JAX."""
    g = _golden("am1_ch2o_h2o")
    sp, co = g["species"][:1], g["coordinates"][:1]
    jc = pq.make_constants(dtype=jnp.float64)
    jt = pq.load_element_tables("AM1", dtype=jnp.float64)
    cfg = pq.SEQMConfig(method="AM1", eig=True, scf=JSCFConfig(
        eps=1.0e-11, converger=(2,), backward=1, backward_eps=1.0e-9,
        backward_max_iter=60))
    species = jnp.asarray(sp, jnp.int32)
    base = jt["U_ss"][species]

    def homo(delta):
        out = pq.energy(jc, jt, cfg, species, jnp.asarray(co),
                        learned={"U_ss": base + delta})
        nocc = pq.make_system(jc, species, jnp.asarray(co)).nocc[0]
        return out.e[0, nocc - 1]
    e, gr = jax.jit(jax.value_and_grad(homo))(jnp.zeros_like(base))
    return sp, co, float(e), np.asarray(gr)


def test_homo_energy_param_grad_matches_jax():
    sp, co, e_ref, g_ref = jax_homo_grad()
    const, tables = _tables()
    cfg = pt.SEQMConfig(method="AM1", eig=True, scf=SCFConfig(
        eps=1.0e-11, converger=(2,), backward=1, backward_eps=1.0e-9,
        backward_max_iter=60))
    base = tables["U_ss"][torch.as_tensor(sp)]
    nocc = int(pt.make_system(const, sp, torch.tensor(co)).nocc[0])

    def homo(delta):
        out = pt.energy(const, tables, cfg, sp, torch.tensor(co),
                        learned={"U_ss": base + delta})
        return out.e[0, nocc - 1]
    d = torch.zeros_like(base, requires_grad=True)
    e = homo(d)
    (gr,) = torch.autograd.grad(e, d)
    np.testing.assert_allclose(float(e.detach()), e_ref, rtol=0,
                               atol=TOL_JAX)
    np.testing.assert_allclose(_np(gr), g_ref, rtol=0, atol=TOL_JAX)
    # and central differences (test_second_order.py: h 1e-5, atol 1e-6)
    h = 1e-5
    dd = torch.zeros_like(base)
    dd[0, 0] = 1.0
    with torch.no_grad():
        num = (homo(h * dd) - homo(-h * dd)) / (2 * h)
    np.testing.assert_allclose(float(gr[0, 0]), float(num), atol=1e-6)


def _md_case():
    """test_aux.py's batch: am1_md, coordinates stretched by 3%."""
    g = _golden("am1_md")
    return g["species"], torch.tensor(g["coordinates"] * 1.03)


def test_converger_consistency():
    """The three convergers reach the same fixed point (test_aux.py's
    test_converger_consistency at f64)."""
    const, tables = _tables()
    sp, co = _md_case()
    hfs = []
    for conv in ((0, 0.0), (1,), (2,)):
        cfg = pt.SEQMConfig(method="AM1",
                            scf=SCFConfig(eps=1.0e-10, converger=conv))
        out = pt.energy(const, tables, cfg, sp, co)
        assert not bool(out.notconverged.any()), conv
        hfs.append(_np(out.Hf))
    np.testing.assert_allclose(hfs[0], hfs[2], rtol=0, atol=1e-8)
    np.testing.assert_allclose(hfs[1], hfs[2], rtol=0, atol=1e-8)


def test_raise_on_forward_failure():
    """Opt-in raise on a forward failure (test_aux.py's
    test_raise_on_scf_failure); without the flag the flags are masked."""
    const, tables = _tables()
    sp, co = _md_case()
    bad = dict(eps=1.0e-12, max_iter=2, converger=(0, 0.0))
    for backward in (0, 1):
        cfg = pt.SEQMConfig(method="AM1", scf=SCFConfig(
            raise_on_forward_failure=True, backward=backward, **bad))
        with pytest.raises(SCFConvergenceError, match="SCF forward failed"):
            pt.energy(const, tables, cfg, sp, co)
    out = pt.energy(const, tables,
                    pt.SEQMConfig(method="AM1", scf=SCFConfig(**bad)), sp, co)
    assert bool(out.notconverged.any())


def test_backward_failure_policy():
    """A loss the adjoint cannot resolve in one iteration (a density
    element, not variational) under backward_eps 1e-12: masked by
    default (the failed molecules' gradients are exactly zero, counted),
    raised with raise_on_backward_failure."""
    const, tables = _tables()
    sp, co = _md_case()

    def grads(**kw):
        cfg = pt.SEQMConfig(method="AM1", scf=SCFConfig(
            eps=1.0e-10, converger=(2,), backward=1, backward_eps=1.0e-12,
            backward_max_iter=1, **kw))
        U = tables["U_ss"][torch.as_tensor(sp)].clone().requires_grad_(True)
        out = pt.energy(const, tables, cfg, sp, co, learned={"U_ss": U})
        (gU,) = torch.autograd.grad(out.P[:, 0, 0].sum(), U)
        return gU
    tscf.backward_failures = tscf.adjoint_iterations = 0
    gU = grads()
    assert tscf.adjoint_iterations == 1
    assert tscf.backward_failures == sp.shape[0]
    assert not bool(gU.any())
    with pytest.raises(SCFConvergenceError, match="SCF backward failed"):
        grads(raise_on_backward_failure=True)
    # the same loss with room to converge: no failure, nonzero gradients
    tscf.backward_failures = 0
    cfg = pt.SEQMConfig(method="AM1", scf=SCFConfig(
        eps=1.0e-10, converger=(2,), backward=1, backward_eps=1.0e-8,
        backward_max_iter=200, raise_on_backward_failure=True))
    U = tables["U_ss"][torch.as_tensor(sp)].clone().requires_grad_(True)
    out = pt.energy(const, tables, cfg, sp, co, learned={"U_ss": U})
    (gU,) = torch.autograd.grad(out.P[:, 0, 0].sum(), U)
    assert tscf.backward_failures == 0 and bool(gU.any())


def test_unsupported_modes_raise():
    const, tables = _tables()
    sp, co = _md_case()
    for scf, msg in ((SCFConfig(converger=(2,), backward=2),
                      "backward mode 2 requires"),
                     (SCFConfig(backward=3), "unknown backward mode"),
                     (SCFConfig(converger=(3,)), "unknown converger")):
        with pytest.raises(ValueError, match=msg):
            pt.energy(const, tables, pt.SEQMConfig(method="AM1", scf=scf),
                      sp, co)
