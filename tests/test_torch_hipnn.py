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


def test_learned_p_exponent_of_a_heavy_block_hydrogen_keeps_forces_finite():
    """The X-H overlap column reads no p exponent of a hydrogen that the
    packed layout places in the heavy block (NH3's first hydrogen beside
    C2H6's second carbon), so a learned one near 0 and moving with the
    geometry (the trained model predicted -1.7e-8 for such an NH3
    hydrogen at step 4 of a 163,840-molecule XL-BOMD run) leaves the force
    finite and as the table's (the column took it as given, and its
    unread combinations' float32 cotangents turned NaN)."""
    sp, co = make_batch(2, 8, names=("NH3", "C2H6"), jitter=0.02, seed=1)
    K = pt.packed_heavy_count(sp)
    assert K == 2
    const, tables, cfg = pt.build(
        "PM3", dtype=torch.float32, device=CPU,
        scf=SCFConfig(eps=1.0e-5, converger=(2,), use_sp2=True,
                      sp2_eps=1.0e-4, pack_heavy=K))

    def learned(s, x):
        zp = torch.where(s == 1, -1.7e-8 * (1.0 + 0.01 * x[..., 0]),
                         tables["zeta_p"][s])
        return {"zeta_p": zp}

    x = torch.tensor(co, dtype=torch.float32)
    f, out = pt.force(const, tables, cfg, sp, x, learned=learned)
    ref, _ = pt.force(const, tables, cfg, sp, x)
    assert torch.isfinite(f).all()
    assert torch.equal(f, ref)


def test_rho1_at_float32_near_zero_h_sp():
    """The Klopman additive term rho1 and its derivatives at float32 equal
    float64's where h_sp nears 0 (the trained model's oxygen h_sp
    lies about 0, and crossed it at step 119 of a 163,840-molecule XL-BOMD
    run); the float32 solve had drifted there by up to 100% and its
    derivative's denominator cancelled to 0, turning the force NaN."""
    from pyseqm_tpu_torch.ops.multipole import rho1_additive
    h = torch.tensor([-1e-3, -2.6e-4, -3e-5, -1e-6, 1e-6, 3e-5, 2.6e-4,
                      1e-3, 0.5938])
    d = torch.full_like(h, 0.27)
    mask = torch.ones_like(h, dtype=torch.bool)
    got = []
    for dt in (torch.float32, F64):
        hh = h.to(dt).requires_grad_(True)
        dd = d.to(dt).requires_grad_(True)
        r = rho1_additive(hh, dd, mask)
        assert r.dtype == dt
        got.append([r] + list(torch.autograd.grad(r.sum(), (hh, dd))))
    for a, b in zip(*got):
        assert torch.isfinite(a).all()
        rel = ((a.double() - b) / b).abs().max()
        assert rel < 1e-6, float(rel)


@pytest.mark.parametrize("rho1", [2.0, 245.0, 5.0e4])
def test_dipole_integrals_at_a_large_rho1_keep_their_derivative(rho1):
    """The local-frame integrals that carry rho1 pair their point charges:
    at float32 their value and their derivative in rho1 keep float64's
    relative precision where rho1 swamps the distances (a learned h_sp
    near 0; each unpaired term's derivative is ~1e8 times the pair's
    difference at rho1 = 245, so it was rounding noise, and
    drho1/dh_sp ~ 1e9 carried it into the force)."""
    from pyseqm_tpu_torch.ops.tetci import (local_frame_integrals,
                                            local_frame_integrals_xh)
    # (r, da, db, qa0, qb0, rho0a, rho0b, rho1b, rho2a, rho2b) in Bohr:
    # an O-C pair at 2.7 Bohr with PM3-like separations
    geo = (2.7, 0.41, 0.75, 0.35, 0.62, 0.9, 1.2, 0.8, 0.7, 0.9)
    got = []
    for dt in (torch.float32, F64):
        r, da, db, qa0, qb0, r0a, r0b, r1b, r2a, r2b = (
            torch.tensor([v], dtype=dt) for v in geo)
        r1a = torch.tensor([rho1], dtype=dt, requires_grad=True)
        one = torch.ones_like(r)
        ri, _, _ = local_frame_integrals(r, one, one, da, db, qa0, qb0, r0a,
                                         r0b, r1a, r1b, r2a, r2b)
        ri4 = local_frame_integrals_xh(r, da, qa0, r0a, r0b, r1a, r2a)
        cols = torch.cat([ri[0], ri4[0]])
        jac = torch.stack([torch.autograd.grad(c, r1a, retain_graph=True)[0]
                           for c in cols])
        got.append((cols.detach().double(), jac.double()))
    (v32, j32), (v64, j64) = got
    # the integrals that read rho1a: (so|ss), (so|so), (sp|sp), (so|oo),
    # (so|pp), (sp|op), and the X-H (so|ss)
    k = [1, 5, 6, 12, 13, 14, 23]
    # (the (sp|op) pairs cancel once more: it lies ~1e5 below the others at
    # rho1 = 245 and is held to their scale)
    assert (j64[k].abs() > 0).all()
    err_v = ((v32[k] - v64[k]).abs().max() / v64[k].abs().max())
    err_j = ((j32[k] - j64[k]).abs().max() / j64[k].abs().max())
    assert err_v < 1e-6, float(err_v)
    assert err_j < 1e-5, float(err_j)
    # and the others do not move with it
    rest = [i for i in range(26) if i not in k]
    assert (j32[rest] == 0).all() and (j64[rest] == 0).all()


def test_energy_derivative_in_h_sp_near_0_at_float32():
    """dHf/dh_sp of a CH3OH whose oxygen h_sp is -2.44e-4 eV (the trained
    model's, at the molecule where a 163,840-molecule XL-BOMD run's float32
    force missed float64's by 0.079 eV/A): within 1e-5 relative of float64
    (it missed by 3.6e-3 before the dipole integrals paired their charges),
    through the packed layout that solves rho1 on the heavy slots alone."""
    sp, co = make_batch(1, 8, names=("CH3OH",), jitter=0.0, seed=0)
    K = pt.packed_heavy_count(sp)
    got = []
    for dt, eps in ((torch.float32, 1e-6), (F64, 1e-10)):
        const, tables, cfg = pt.build(
            "PM3", dtype=dt, device=CPU,
            scf=SCFConfig(eps=eps, converger=(2,), max_iter=1000,
                          pack_heavy=K))
        h = torch.tensor(-2.44e-4, dtype=dt, requires_grad=True)
        out = pt.energy(const, tables, cfg, sp, torch.tensor(co, dtype=dt),
                        learned={"h_sp": torch.where(
                            torch.as_tensor(sp) == 8, h,
                            tables["h_sp"][torch.as_tensor(sp)])})
        got.append(float(torch.autograd.grad(out.Hf.sum(), h)[0]))
    g32, g64 = got
    assert abs(g64) > 10.0
    assert abs(g32 - g64) < 1e-5 * abs(g64), (g32, g64)


def test_heavy_slot_additive_terms_match_every_slot():
    """atom_multipoles with the batch's heavy count solves rho1/rho2 on the
    heavy slots alone and returns what the solve over every slot does, to
    the bit (the hydrogens and padding read 0 either way)."""
    from pyseqm_tpu_torch.models.energy import _atom_parameters
    from pyseqm_tpu_torch.ops.hcore import atom_multipoles
    sp, co = make_batch(3, 8, names=("NH3", "CH3OH", "C2H6"), jitter=0.02,
                        seed=2)
    K = pt.packed_heavy_count(sp)
    for dt in (torch.float32, F64):
        const, tables, cfg = pt.build("PM3", dtype=dt, device=CPU)
        species = torch.as_tensor(sp)
        sys = pt.make_system(const, species, torch.tensor(co, dtype=dt),
                             heavy_count=K)
        p = _atom_parameters(tables, "PM3", sys, None, sys.coordinates)
        full, cut = (atom_multipoles(const, species, p),
                     atom_multipoles(const, species, p, K))
        for n in ("rho1", "rho2"):
            assert torch.equal(full[n], cut[n]), n
            assert (full[n][:, K:] == 0).all()
