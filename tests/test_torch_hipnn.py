"""PyTorch port, the reference's trained HIP-NN parameter model
(models/hipnn.py) on the CPU: its f64 feature levels, heads and PM3
parameters against the replay of the reference artifact
(tests/golden/hipnn_replay.npz) and against the JAX package; permutation
and rigid-motion equivariance and the 6 A locality; the PM3 force and one
packed XL-BOMD step driven by the model against the JAX package's; and
the species outside the model's elements raising."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.drivers.md import MDConfig as JMDConfig
from pyseqm_tpu.drivers.xlbomd import XLBOMD as JXLBOMD
from pyseqm_tpu.models import hipnn as jhipnn
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu_torch.drivers.md import MDConfig
from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
from pyseqm_tpu_torch.models.hipnn import (hipnn_features, load_hipnn,
                                           make_hipnn_callable,
                                           predict_seqm_parameters)
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.utils.molecules import make_batch
from test_torch_slice import assert_xl_states_match, jax_xl_init

torch.set_num_threads(1)
CPU = "cpu"
F64 = torch.float64


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


@functools.lru_cache(maxsize=None)
def model():
    return load_hipnn(dtype=F64, device=CPU)


def _predict(sp, co):
    w, meta = model()
    return predict_seqm_parameters(w, meta,
                                   torch.as_tensor(sp, dtype=torch.long),
                                   torch.as_tensor(co, dtype=F64))


def test_replay_parity():
    """The port's forward against the reference artifact's replay
    (test_hipnn.py::test_torch_replay_parity, same bounds): every feature
    level, every head term and the per-atom PM3 parameters at f64."""
    d = np.load("tests/golden/hipnn_replay.npz")
    w, meta = model()
    species = torch.as_tensor(d["species"], dtype=torch.long)
    coords = torch.as_tensor(d["coords"], dtype=F64)
    mask = d["species"] > 0
    levels = hipnn_features(w, meta, species, coords)
    for li in range(3):
        got = _np(levels[li])[mask]
        ref = d[f"level{li}"][mask]
        scale = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(got, ref, atol=1e-9 * scale, rtol=1e-9,
                                   err_msg=f"level{li}")
        head = _np(levels[li] @ w[f"head{li}_w"].T + w[f"head{li}_b"])[mask]
        np.testing.assert_allclose(head, d[f"head{li}"][mask], atol=1e-9,
                                   rtol=1e-7, err_msg=f"head{li}")
    pars = predict_seqm_parameters(w, meta, species, coords)
    assert list(pars) == list(meta["learned"])
    for i, name in enumerate(meta["learned"]):
        np.testing.assert_allclose(_np(pars[name])[mask],
                                   d["params"][..., i][mask], atol=1e-6,
                                   rtol=1e-9, err_msg=name)


def test_parameters_match_jax():
    sp, co = make_batch(6, 8, jitter=0.02, seed=11)
    jw, jmeta = jhipnn.load_hipnn(dtype=jnp.float64)
    jp = jax.jit(lambda c: jhipnn.predict_seqm_parameters(
        jw, jmeta, jnp.asarray(sp), c))(jnp.asarray(co))
    p = _predict(sp, co)
    for name in jmeta["learned"]:
        np.testing.assert_allclose(_np(p[name]), np.asarray(jp[name]),
                                   rtol=0, atol=1e-10, err_msg=name)
        # padding atoms predict exactly zero
        assert (_np(p[name])[sp == 0] == 0).all()


def test_equivariance_and_locality():
    sp, co = make_batch(6, 8, jitter=0.02, seed=11)
    p0 = _predict(sp, co)
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    perm = np.arange(sp.shape[1])
    perm[1], perm[2] = 2, 1
    moved = {"translation": _predict(sp, co + np.array([3.0, -1.0, 0.5])),
             "rotation": _predict(sp, co @ R.T),
             "permutation": _predict(sp[:, perm], co[:, perm])}
    for name in p0:
        for how, p in moved.items():
            ref = _np(p0[name])[:, perm] if how == "permutation" \
                else _np(p0[name])
            np.testing.assert_allclose(_np(p[name]), ref, rtol=0,
                                       atol=1e-10, err_msg=f"{how} {name}")
    # atoms beyond the 6 A hard cutoff do not interact: moving a remote
    # water leaves the first one's parameters unchanged
    spw = np.array([[8, 1, 1, 8, 1, 1]])
    cw = np.zeros((1, 6, 3))
    cw[0, 1] = [0.96, 0.0, 0.0]
    cw[0, 2] = [-0.24, 0.93, 0.0]
    cw[0, 3:] = cw[0, :3] + np.array([20.0, 0.0, 0.0])
    cw2 = cw.copy()
    cw2[0, 3:] += np.array([5.0, 2.0, 1.0])
    a, b = _predict(spw, cw), _predict(spw, cw2)
    for name in a:
        np.testing.assert_allclose(_np(a[name])[0, :3], _np(b[name])[0, :3],
                                   rtol=0, atol=1e-12)


def _scf(K):
    return dict(eps=1.0e-10, converger=(2,), use_sp2=True, sp2_eps=1.0e-7,
                pack_heavy=K)


@functools.lru_cache(maxsize=None)
def jax_hipnn_force():
    """PM3 with the JAX package's HIP-NN callable on the packed SP2 path:
    its force and energy output (one jitted program), also the bootstrap
    energy of the XL test."""
    sp, co = make_batch(4, 8, jitter=0.02, seed=13)
    K = pt.packed_heavy_count(sp)
    jcfg = pq.SEQMConfig(method="PM3", scf=JSCFConfig(**_scf(K)))
    jc = pq.make_constants(dtype=jnp.float64)
    jt = pq.load_element_tables("PM3", dtype=jnp.float64)
    jlearned = jhipnn.make_hipnn_callable(dtype=jnp.float64)
    jf, jout = jax.jit(lambda c: pq.force(jc, jt, jcfg, jnp.asarray(sp), c,
                                          learned=jlearned))(jnp.asarray(co))
    return dict(sp=sp, co=co, K=K, jcfg=jcfg, jc=jc, jt=jt,
                jlearned=jlearned, jf=jf, jout=jout)


def test_pm3_force_with_hipnn_matches_jax():
    b = jax_hipnn_force()
    const, tables, cfg = pt.build("PM3", dtype=F64, device=CPU,
                                  scf=SCFConfig(**_scf(b["K"])))
    learned = make_hipnn_callable(dtype=F64, device=CPU)
    f, out = pt.force(const, tables, cfg, b["sp"], torch.tensor(b["co"]),
                      learned=learned)
    assert not out.notconverged.any()
    np.testing.assert_allclose(_np(out.Hf), np.asarray(b["jout"].Hf), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(_np(f), np.asarray(b["jf"]), rtol=0,
                               atol=1e-7)
    # translation invariance through the network and the SCF
    np.testing.assert_allclose(_np(f).sum(axis=1), 0.0, atol=1e-6)
    # the network moves the energy away from the table's
    plain = pt.energy(const, tables, cfg, b["sp"], torch.tensor(b["co"]))
    assert (plain.Hf - out.Hf).abs().max() > 1e-2


def test_packed_xlbomd_step_with_hipnn_matches_jax():
    b = jax_hipnn_force()
    sp, co = b["sp"], b["co"]
    const, tables, cfg = pt.build("PM3", dtype=F64, device=CPU,
                                  scf=SCFConfig(**_scf(b["K"])))
    learned = make_hipnn_callable(dtype=F64, device=CPU)
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5,
                learned=learned)
    species = torch.tensor(sp, dtype=torch.long)
    s = md.initialize(species, co, velocities=np.zeros_like(co),
                      initial_force=False)
    jmd = JXLBOMD(b["jc"], b["jt"], b["jcfg"], JMDConfig(timestep=0.4), k=5,
                  learned=b["jlearned"])
    js = jax_xl_init(jmd, sp, co, b["jout"])
    assert s.Pt.shape[-1] < 4 * sp.shape[1]      # the packed electronic state
    assert_xl_states_match(s, js)
    jsp = jnp.asarray(sp)
    js, jobs = jax.jit(lambda st: jmd.step(jsp, st))(js)
    s, obs = md.step(species, s)
    assert_xl_states_match(s, js)
    np.testing.assert_allclose(_np(obs.Epot), np.asarray(jobs.Epot), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("molecule", [[16, 1, 1, 0], [9, 1, 0, 0]])
def test_species_outside_the_model_raise(molecule):
    """H2S and HF: S and F have no row in the model's base table (Z = 0..8
    only); the JAX package's gather clamps them onto oxygen's row
    (pyseqm_tpu/models/hipnn.py:124)."""
    sp = np.array([molecule])
    co = np.array([[[0.0, 0.0, 0.0], [1.3, 0.0, 0.0], [0.0, 1.3, 0.0],
                    [0.0, 0.0, 0.0]]])
    with pytest.raises(ValueError, match="HIP-NN"):
        _predict(sp, co)
    learned = make_hipnn_callable(dtype=F64, device=CPU)
    with pytest.raises(ValueError, match="HIP-NN"):
        learned(torch.as_tensor(sp), torch.as_tensor(co))
    const, tables, cfg = pt.build("PM3", dtype=F64, device=CPU,
                                  row3=molecule[0] > 10)
    with pytest.raises(ValueError, match="HIP-NN"):
        pt.energy(const, tables, cfg, sp, torch.tensor(co), learned=learned)


def test_learned_hydrogen_p_exponent_keeps_forces_finite():
    """A hydrogen has no p shell, but a learned callable may still give it
    a zeta_p, here near zero and moving with the geometry (the trained
    model predicts -5e-7 for a CH4 hydrogen at a geometry of the headline
    run).  In the packed layout CH4's first hydrogen sits in the heavy
    block next to C2H6's second carbon; the overlap there must not read
    its zeta_p, whose unread combinations overflow at float32 and turn the
    force NaN (the JAX package's diatom_overlap reads it,
    pyseqm_tpu/ops/overlap.py)."""
    sp, co = make_batch(2, 8, names=("CH4", "C2H6"), jitter=0.02, seed=1)
    K = pt.packed_heavy_count(sp)
    assert K == 2
    const, tables, cfg = pt.build(
        "PM3", dtype=torch.float32, device=CPU,
        scf=SCFConfig(eps=1.0e-5, converger=(2,), use_sp2=True,
                      sp2_eps=1.0e-4, pack_heavy=K))

    def learned(s, x):
        zp = torch.where(s == 1, -5.3e-7 * (1.0 + 0.01 * x[..., 0]),
                         tables["zeta_p"][s])
        return {"zeta_p": zp}

    f, out = pt.force(const, tables, cfg, sp,
                      torch.tensor(co, dtype=torch.float32), learned=learned)
    ref, _ = pt.force(const, tables, cfg, sp,
                      torch.tensor(co, dtype=torch.float32))
    assert torch.isfinite(f).all()
    # the hydrogens' zeta_p enters nothing
    assert torch.equal(f, ref)
