"""PyTorch port, the learned-parameter path on the CPU against the JAX
package at f64: the parameter network of models/ml.py (weights carried
across as numpy), the learned callable against the dict, the Kbeta and
g_ss_nuc hooks on the flat, class-segmented flat, dense and packed
class-segmented dense layouts (energies and their gradients with respect
to the hooks), the hooks in energy_xl, the gradient of a loss with respect
to the network's weights through the SCF adjoint, and the learned
parameters in the steepest-descent line search."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.models import ml as jml
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu_torch.drivers.opt import geometry_optimize_sd_ls
from pyseqm_tpu_torch.models import ml
from pyseqm_tpu_torch.models.xlbomd import energy_xl
from pyseqm_tpu_torch.ops.density import static_pack_mat
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.utils.molecules import make_batch

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64
SP, CO = make_batch(4, 8, jitter=0.02, seed=5)
K = pt.packed_heavy_count(SP)
NP = SP.shape[1] * (SP.shape[1] - 1) // 2
# the layouts _resolve_pair_layout picks: flat pairs (A < 64), the
# class-segmented flat pair list, the ordered dense grid, and the packed
# class-segmented dense grid (the headline layout)
LAYOUTS = {"flat": (False, {}),
           "flat-split": (True, {"dense_pair_grid": False}),
           "dense": (False, {"dense_pair_grid": True}),
           "packed": (True, {})}


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _hooks():
    """A random Kbeta in [0.9, 1.1] (canonical pair order) and g_ss_nuc
    within 5% of the table's g_ss, from a numpy seed."""
    rng = np.random.default_rng(17)
    kb = rng.uniform(0.9, 1.1, (SP.shape[0], NP, 4))
    gss = np.asarray(pq.load_element_tables("AM1", dtype=jnp.float64)
                     ["g_ss"])[SP]
    return kb, gss * rng.uniform(0.95, 1.05, SP.shape)


def _scf(layout):
    pack, kw = LAYOUTS[layout]
    return (dict(eps=1.0e-10, converger=(2,), pack_heavy=K if pack else None),
            kw)


def _port(layout, **scf_kw):
    scf, kw = _scf(layout)
    scf.update(scf_kw)
    return pt.build("AM1", dtype=F64, device=CPU, scf=SCFConfig(**scf), **kw)


@functools.lru_cache(maxsize=None)
def jax_hooked(layout):
    """The JAX package's Hf and Enuc with both hooks on ``layout``, and
    the gradient of sum(Hf) with respect to Kbeta and g_ss_nuc (one jitted
    program)."""
    scf, kw = _scf(layout)
    jcfg = pq.SEQMConfig(method="AM1", scf=JSCFConfig(**scf), **kw)
    jc = pq.make_constants(dtype=jnp.float64)
    jt = pq.load_element_tables("AM1", dtype=jnp.float64)
    jsp, jco = jnp.asarray(SP), jnp.asarray(CO)

    def loss(kb, g):
        out = pq.energy(jc, jt, jcfg, jsp, jco,
                        learned={"Kbeta": kb, "g_ss_nuc": g})
        return out.Hf.sum(), (out.Hf, out.Enuc)

    kb, g = _hooks()
    (_, (hf, enuc)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(kb), jnp.asarray(g))
    return np.asarray(hf), np.asarray(enuc), [np.asarray(x) for x in grads]


def test_predict_parameters_matches_jax():
    jt = pq.load_element_tables("AM1", dtype=jnp.float64)
    jw = jml.init_param_model(jt, jax.random.PRNGKey(7))
    w = ml.weights_from_numpy({k: np.asarray(v) for k, v in jw.items()},
                              device=CPU, dtype=F64)
    tables = pt.load_element_tables("AM1", device=CPU, dtype=F64)
    sp, co = make_batch(6, 8, jitter=0.02, seed=11)
    jp = jax.jit(lambda c: jml.predict_parameters(
        jw, jt, jnp.asarray(sp), c))(jnp.asarray(co))
    p = ml.predict_parameters(w, tables, torch.tensor(sp, dtype=torch.long),
                              torch.tensor(co))
    assert sorted(p) == sorted(ml.DEFAULT_PARAM_NAMES)
    for name in p:
        np.testing.assert_allclose(_np(p[name]), np.asarray(jp[name]),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    # the port's own init: the JAX shapes and scalings from a generator
    w0 = ml.init_param_model(tables, torch.Generator().manual_seed(7))
    assert {k: tuple(v.shape) for k, v in w0.items()} == {
        k: tuple(np.shape(v)) for k, v in jw.items()}
    # linspace in float64 (XLA's and numpy's differ in the last ulp)
    np.testing.assert_allclose(_np(w0["centers"]), np.asarray(jw["centers"]),
                               rtol=1e-15, atol=0)


def test_callable_matches_dict_and_changes_energy():
    const, tables, cfg = _port("flat")
    w = ml.init_param_model(tables, torch.Generator().manual_seed(7),
                            scale=0.05)
    f = ml.make_learned_callable(w, tables)
    sp, co = torch.tensor(SP, dtype=torch.long), torch.tensor(CO)
    out_c = pt.energy(const, tables, cfg, sp, co, learned=f)
    out_d = pt.energy(const, tables, cfg, sp, co, learned=f(sp, co))
    np.testing.assert_allclose(_np(out_c.Hf), _np(out_d.Hf), rtol=0,
                               atol=1e-10)
    out_t = pt.energy(const, tables, cfg, sp, co)
    assert (out_c.Hf - out_t.Hf).abs().min() > 1e-4


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_hooks_match_jax_on_every_layout(layout):
    """Kbeta and g_ss_nuc on each integral layout: the identity values
    reproduce the hook-free energy, and random hooks give the JAX
    package's Hf, Enuc and gradients with respect to both hooks."""
    const, tables, cfg = _port(layout)
    sp, co = torch.tensor(SP, dtype=torch.long), torch.tensor(CO)
    base = pt.energy(const, tables, cfg, sp, co)
    ones = pt.energy(const, tables, cfg, sp, co, learned={
        "Kbeta": torch.ones(SP.shape[0], NP, 4, dtype=F64),
        "g_ss_nuc": tables["g_ss"][sp]})
    # a factor of one is exact; the table's g_ss gives the integrals' own
    # (ss|ss) through another formula
    np.testing.assert_allclose(_np(ones.Hf), _np(base.Hf), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(_np(ones.Enuc), _np(base.Enuc), rtol=0,
                               atol=1e-9)
    kb_np, g_np = _hooks()
    kb = torch.tensor(kb_np, requires_grad=True)
    g = torch.tensor(g_np, requires_grad=True)
    out = pt.energy(const, tables, cfg, sp, co,
                    learned={"Kbeta": kb, "g_ss_nuc": g})
    gkb, gg = torch.autograd.grad(out.Hf.sum(), (kb, g))
    jhf, jenuc, (jgkb, jgg) = jax_hooked(layout)
    np.testing.assert_allclose(_np(out.Hf), jhf, rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(out.Enuc), jenuc, rtol=0, atol=1e-8)
    assert np.abs(_np(out.Hf) - _np(base.Hf)).min() > 1e-3
    assert np.abs(_np(out.Enuc) - _np(base.Enuc)).min() > 1e-3
    np.testing.assert_allclose(_np(gkb), jgkb, rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(gg), jgg, rtol=0, atol=1e-8)
    # padding atoms and masked pairs keep finite, zero gradients
    assert torch.isfinite(gg).all() and (gg[sp == 0] == 0).all()


@pytest.mark.parametrize("layout", ["flat", "packed"])
def test_energy_xl_applies_both_hooks(layout):
    """energy_xl at the converged density gives the Enuc of JAX's
    energy() with the same g_ss_nuc, and the Hf: the JAX package's
    energy_xl drops g_ss_nuc (pyseqm_tpu/models/xlbomd.py:77,
    ``p.pop("g_ss_nuc", None)``), so its XL forces follow another
    nuclear energy than energy()'s."""
    const, tables, cfg = _port(layout)
    sp, co = torch.tensor(SP, dtype=torch.long), torch.tensor(CO)
    kb_np, g_np = _hooks()
    hooks = {"Kbeta": torch.tensor(kb_np), "g_ss_nuc": torch.tensor(g_np)}
    out = pt.energy(const, tables, cfg, sp, co, learned=hooks)
    packed = layout == "packed"
    P = static_pack_mat(out.P, K, pt.packed_solver_size(K, SP.shape[1])) \
        if packed else out.P
    xl = energy_xl(const, tables, cfg, sp, co, P, learned=hooks,
                   packed_io=packed)
    jhf, jenuc, _ = jax_hooked(layout)
    np.testing.assert_allclose(_np(xl.Enuc), jenuc, rtol=0, atol=1e-9)
    # the XL functional at the SCF fixed point is the SCF energy to second
    # order in D - P
    np.testing.assert_allclose(_np(xl.Hf), jhf, rtol=0, atol=1e-6)
    no_hook = energy_xl(const, tables, cfg, sp, co, P, packed_io=packed)
    assert np.abs(_np(no_hook.Enuc) - jenuc).min() > 1e-3


@functools.lru_cache(maxsize=None)
def jax_weight_grad():
    """jax.grad of sum((Hf - target)^2) with respect to the parameter
    network's weights through the SCF adjoint (backward mode 1)."""
    jt = pq.load_element_tables("AM1", dtype=jnp.float64)
    jc = pq.make_constants(dtype=jnp.float64)
    jw = jml.init_param_model(jt, jax.random.PRNGKey(3), scale=0.05)
    jcfg = pq.SEQMConfig(method="AM1", scf=JSCFConfig(
        eps=1.0e-10, converger=(1,), backward=1, backward_eps=1.0e-8,
        backward_max_iter=50))
    target = jnp.asarray(TARGET)

    def loss(w):
        f = jml.make_learned_callable(w, jt)
        out = pq.energy(jc, jt, jcfg, jnp.asarray(SP), jnp.asarray(CO),
                        learned=f)
        return jnp.sum((out.Hf - target) ** 2)

    val, g = jax.jit(jax.value_and_grad(loss))(jw)
    return ({k: np.asarray(v) for k, v in jw.items()}, float(val),
            {k: np.asarray(v) for k, v in g.items()})


TARGET = np.array([-1.0, 2.0, -3.0, 0.5])


def test_weight_gradient_through_adjoint_matches_jax():
    jw, jloss, jg = jax_weight_grad()
    const, tables, cfg = pt.build(
        "AM1", dtype=F64, device=CPU,
        scf=SCFConfig(eps=1.0e-10, converger=(1,), backward=1,
                      backward_eps=1.0e-8, backward_max_iter=50))
    w = ml.weights_from_numpy(jw, device=CPU, dtype=F64)
    for v in w.values():
        v.requires_grad_(True)
    out = pt.energy(const, tables, cfg, SP, torch.tensor(CO),
                    learned=ml.make_learned_callable(w, tables))
    loss = ((out.Hf - torch.tensor(TARGET)) ** 2).sum()
    grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-12)
    for (name, v), gt in zip(w.items(), grads):
        want = jg[name]
        got = np.zeros_like(want) if gt is None else _np(gt)
        scale = max(np.abs(want).max(), 1e-300)
        assert np.abs(got - want).max() <= 1e-7 * scale, (
            name, np.abs(got - want).max(), scale)
    assert np.abs(jg["w1"]).max() > 0 and np.abs(jg["w3"]).max() > 0


def test_sd_line_search_uses_learned_parameters():
    """The line search's trial energies see the learned parameters: a
    learned U_ss 3% above the table gives the run of a table with that
    U_ss (the JAX package's trial energies drop ``learned``,
    pyseqm_tpu/drivers/opt.py:120)."""
    const, tables, cfg = pt.build(
        "AM1", dtype=F64, device=CPU,
        scf=SCFConfig(eps=1.0e-9, converger=(2,)))
    sp, co = make_batch(3, 8, jitter=0.05, seed=2)
    sp_t = torch.tensor(sp, dtype=torch.long)
    learned = {"U_ss": tables["U_ss"][sp_t] * 1.03}
    shifted = dict(tables, U_ss=tables["U_ss"] * 1.03)
    runs = [geometry_optimize_sd_ls(const, t, cfg, sp, co, alpha=0.004,
                                    max_evl=3, learned=lp)
            for t, lp in ((tables, learned), (shifted, None))]
    np.testing.assert_allclose(_np(runs[0][0]), _np(runs[1][0]), rtol=0,
                               atol=1e-10)
    plain = geometry_optimize_sd_ls(const, tables, cfg, sp, co, alpha=0.004,
                                    max_evl=3)
    assert (runs[0][0] - plain[0]).abs().max() > 1e-6
