"""PyTorch port, the whole slice against the JAX package on the CPU: AM1
energy and force on the packed SP2 path (am1_batch96, f64) against JAX at
the same configuration and against the f64 goldens; five packed XL-BOMD
steps against JAX; the NVE and XL drivers against the reference's f64
trajectories; and float32 XL steps against the f64 port."""
import dataclasses
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.drivers.md import MDConfig as JMDConfig
from pyseqm_tpu.drivers.md import zero_com as jzero_com
from pyseqm_tpu.drivers.xlbomd import XLBOMD as JXLBOMD
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu_torch.drivers.md import (MDConfig, MDState,
                                         MolecularDynamics,
                                         initialize_velocity, kinetic_energy,
                                         zero_com)
from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.utils.molecules import make_batch

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def jax_xl_init(jmd, sp, co, jout):
    """JAX's XLBOMD.initialize (initial_force=False: one SCF energy, acc at
    zero) with that energy taken from ``jout``, the JAX package's energy
    output for the same molecules and configuration: XLBOMD's own packing
    and state on the reference's own density, in one jitted program,
    without tracing the SCF a second time."""
    jenergy = importlib.import_module("pyseqm_tpu.models.energy")
    energy = jenergy.energy
    jsp = jnp.asarray(sp)

    def init(x, out):
        jenergy.energy = lambda *args, **kwargs: out
        return jmd.initialize(jsp, x, velocities=jnp.zeros_like(x),
                              initial_force=False)
    try:
        return jax.jit(init)(jnp.asarray(co), jout)
    finally:
        jenergy.energy = energy


def assert_xl_states_match(s, js, atol=1e-8):
    """The port's XL state against JAX's, field by field."""
    for name in ("coordinates", "velocities", "acc", "D", "P", "Pt", "E0"):
        np.testing.assert_allclose(_np(getattr(s, name)),
                                   np.asarray(getattr(js, name)), rtol=0,
                                   atol=atol, err_msg=name)


def _configs(K, **kw):
    scf = dict(eps=1.0e-10, converger=(2,), use_sp2=True, sp2_eps=1.0e-7,
               pack_heavy=K)
    scf.update(kw)
    jcfg = pq.SEQMConfig(method="AM1", scf=JSCFConfig(**scf))
    return jcfg, scf


@functools.lru_cache(maxsize=None)
def jax_packed_force():
    """am1_batch96 on the packed SP2 path: the JAX package's force and
    energy output (one jitted program) at the configuration the port runs.
    test_torch_integrals.py holds the port's packed integrals and Fock
    build to the same output (its Hcore, integrals, and Fock matrix at its
    density)."""
    g = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "am1_batch96.npz"))
    sp, co = g["species"], g["coordinates"]
    K = pt.packed_heavy_count(sp)
    jcfg, scf = _configs(K)
    jc = pq.make_constants(dtype=jnp.float64)
    jt = pq.load_element_tables("AM1", dtype=jnp.float64)
    jf, jout = jax.jit(lambda c: pq.force(jc, jt, jcfg, jnp.asarray(sp), c))(
        jnp.asarray(co))
    return dict(g=g, sp=sp, co=co, K=K, jcfg=jcfg, scf=scf, jc=jc, jt=jt,
                jf=jf, jout=jout)


def test_energy_force_batch96_match_jax_and_golden():
    b = jax_packed_force()
    g, sp, co, jf, jout = b["g"], b["sp"], b["co"], b["jf"], b["jout"]
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device="cpu",
                                  scf=SCFConfig(**b["scf"]))
    f, out = pt.force(const, tables, cfg, sp, torch.tensor(co))
    assert not out.notconverged.any()
    # same configuration, same algorithms at f64: the energies agree to
    # rounding, forces to the SCF endpoint's linear sensitivity
    for name in ("Hf", "Etot", "Eelec", "Enuc", "Eiso_sum"):
        np.testing.assert_allclose(_np(getattr(out, name)),
                                   np.asarray(getattr(jout, name)), rtol=0,
                                   atol=1e-9, err_msg=name)
    np.testing.assert_allclose(_np(f), np.asarray(jf), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(out.P), np.asarray(jout.P), rtol=0,
                               atol=1e-8)
    # golden bounds of test_energy.py: the SP2 Hf bound (SP2 stops on its
    # trace criterion) and the batch96 force bound (two eps=1e-10 SCF
    # endpoints)
    np.testing.assert_allclose(_np(out.Hf), g["Hf"], rtol=0, atol=5e-5)
    np.testing.assert_allclose(_np(f), g["force"], rtol=0, atol=3e-5)


def test_xlbomd_packed_trajectory_matches_jax():
    b = jax_packed_force()
    sp, co = b["sp"], b["co"]
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device="cpu",
                                  scf=SCFConfig(**b["scf"]))
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=1.0), k=5)
    # the headline bootstrap: one SCF energy, acc starting at zero
    s = md.initialize(sp, co, velocities=np.zeros_like(co),
                      initial_force=False)
    jmd = JXLBOMD(b["jc"], b["jt"], b["jcfg"], JMDConfig(timestep=1.0), k=5)
    js = jax_xl_init(jmd, sp, co, b["jout"])
    assert s.Pt.shape[-1] < 4 * sp.shape[1]      # the packed electronic state
    # f64: the same bootstrap density, packed into the same state
    assert_xl_states_match(s, js)
    jsp = jnp.asarray(sp)
    jstep = jax.jit(lambda s: jmd.step(jsp, s))
    for _ in range(5):
        js, jobs = jstep(js)
        s, obs = md.step(sp, s)
    # f64, identical integrator and electronic propagation
    assert_xl_states_match(s, js)
    for got, want in ((obs.Epot, jobs.Epot), (obs.charges, jobs.charges)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-8)


def test_xlbomd_f32_tracks_f64():
    sp, co = make_batch(6, 8, jitter=0.02, seed=1)
    K = pt.packed_heavy_count(sp)
    runs = {}
    for dtype in (torch.float64, torch.float32):
        const, tables, cfg = pt.build(
            "AM1", dtype=dtype, device="cpu",
            scf=SCFConfig(eps=1.0e-5 if dtype == torch.float32 else 1.0e-10,
                          converger=(2,), use_sp2=True, sp2_eps=1.0e-4,
                          pack_heavy=K))
        md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
        s = md.initialize(sp, co, velocities=np.zeros_like(co))
        for _ in range(3):
            s, obs = md.step(sp, s)
        runs[dtype] = (s, obs)
    s32, o32 = runs[torch.float32]
    s64, o64 = runs[torch.float64]
    for t in (s32.coordinates, s32.velocities, s32.P, o32.Epot, o32.charges):
        assert torch.isfinite(t).all()
    # f32 bounds: Epot within the f32 Hf error budget (1.5e-4 eV, the
    # storage floor; see PERF.md); coordinates within what a 1e-3 eV/A f32
    # force error moves an atom in 3 steps of 0.4 fs (~6e-7 A, bound
    # 2e-6); charges within the f32 density error summed over an atom's
    # four orbitals
    np.testing.assert_allclose(_np(o32.Epot), _np(o64.Epot), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(_np(s32.coordinates), _np(s64.coordinates),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(_np(o32.charges), _np(o64.charges), rtol=0,
                               atol=1e-4)


def test_md_drivers_match_reference_goldens(golden):
    """NVE (an SCF force every step, the previous density as its guess) and
    XL-BOMD with the SCF-gradient bootstrap against the reference's f64
    trajectories (the test_md.py cases), with the two molecules padded to
    8 atom slots so the packed layout applies (padding is inert)."""
    g = golden("am1_md")
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((a.shape[0], 4) + a.shape[2:], a.dtype)], axis=1)
    sp, co = pad(g["species"]), pad(g["coordinates"] * 1.03)
    K = pt.packed_heavy_count(sp)
    _, scf = _configs(K)
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device="cpu",
                                  scf=SCFConfig(**scf))
    md = MolecularDynamics(const, tables, cfg, MDConfig(timestep=1.0))
    s = md.initialize(sp, co, velocities=np.zeros_like(co))
    s = md.run(sp, s, steps=25, thermo=25, log=False)
    # the bounds of test_md.py (f64 trajectories, 25-step horizon)
    np.testing.assert_allclose(_np(s.coordinates)[:, :4], g["nve_coords"],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(_np(s.velocities)[:, :4], g["nve_vel"],
                               rtol=0, atol=1e-7)
    xl = XLBOMD(const, tables, cfg, MDConfig(timestep=1.0), k=5)
    s = xl.initialize(sp, co, velocities=np.zeros_like(co))
    s = xl.run(sp, s, steps=5, thermo=5, log=False)
    np.testing.assert_allclose(_np(s.coordinates)[:, :4], g["xl_coords"],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(_np(s.velocities)[:, :4], g["xl_vel"],
                               rtol=0, atol=1e-7)
    assert not _np(s.coordinates)[:, 4:].any()


def test_zero_com_and_thermostats():
    sp, co = make_batch(5, 8, jitter=0.03, seed=6)
    rng = np.random.RandomState(9)
    v = rng.randn(*co.shape) * 0.01 * (sp > 0)[..., None]
    jx, jv = jax.jit(lambda c, u: jzero_com(
        pq.make_constants(dtype=jnp.float64), jnp.asarray(sp), c, u))(
            jnp.asarray(co), jnp.asarray(v))
    const = pt.make_constants(dtype=torch.float64, device="cpu")
    x, u = zero_com(const, torch.tensor(sp), torch.tensor(co),
                    torch.tensor(v))
    # f64: the same COM / angular-momentum removal and rescale
    np.testing.assert_allclose(_np(x), np.asarray(jx), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(u), np.asarray(jv), rtol=0, atol=1e-12)

    _, tables, cfg = pt.build("AM1", dtype=torch.float64, device="cpu")
    spt = torch.tensor(sp)
    gen = torch.Generator().manual_seed(0)
    v0 = initialize_velocity(const, spt, torch.tensor(co), gen, Temp=300.0)
    mass = const.mass[spt][..., None]
    # Maxwell-Boltzmann draw with the COM momentum removed
    np.testing.assert_allclose(_np((mass * v0).sum(dim=1)), 0.0, atol=1e-12)
    assert not _np(v0)[sp == 0].any()
    md = MolecularDynamics(const, tables, cfg,
                           MDConfig(scale_vel=(2, 250.0)))
    st = MDState(torch.tensor(co), torch.tensor(v), None, None, None, 2)
    st = md._thermostat(spt, st, None)
    _, T = kinetic_energy(const, spt, st.velocities)
    np.testing.assert_allclose(_np(T), 250.0, rtol=1e-12)
    md = MolecularDynamics(const, tables, cfg,
                           MDConfig(control_energy_shift=True))
    Ek, _ = kinetic_energy(const, spt, st.velocities)
    E0 = Ek + 1.0
    st = dataclasses.replace(st, E0=E0)
    st = md._thermostat(spt, st, torch.full_like(Ek, 1.05))
    # the energy-shift control removes the 0.05 eV excess from Ek
    Ek2, _ = kinetic_energy(const, spt, st.velocities)
    np.testing.assert_allclose(_np(Ek2), _np(Ek - 0.05), rtol=1e-12)
