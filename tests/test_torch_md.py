"""PyTorch port, the NVT drivers on the CPU: Langevin and Nose-Hoover
trajectories of 5 steps on the am1_md golden batch against the JAX
package's drivers at f64 (their ``step`` started from the port's initial
state; the JAX package's noise draws fed through the port's
``random_normal``), the port generator's noise scale, and the drivers'
generator and charges contracts.

The JAX steps run eagerly around one compiled program, the SCF force
(``pyseqm_tpu.drivers.opt._force_fn``: the math of the JAX base
driver's ``compute_force``), shared by both thermostats: a jitted step
per thermostat compiles the whole SCF twice."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.drivers import md as jmd
from pyseqm_tpu.drivers import opt as jopt
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu_torch.drivers import md as tmd
from pyseqm_tpu_torch.scf import SCFConfig

torch.set_num_threads(1)
CPU = "cpu"
STEPS = 5
SCF = dict(eps=1.0e-10, converger=(2,))


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _setup(golden):
    g = golden("am1_md")
    sp = g["species"]
    co = g["coordinates"] * 1.03
    v0 = np.random.default_rng(0).standard_normal(co.shape) * 0.01
    v0[sp == 0] = 0.0
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device=CPU,
                                  scf=SCFConfig(**SCF))
    jconst = pq.make_constants(dtype=jnp.float64)
    jtables = pq.load_element_tables("AM1", dtype=jnp.float64)
    jcfg = pq.SEQMConfig(method="AM1", scf=JSCFConfig(**SCF))
    return sp, co, v0, (const, tables, cfg), (jconst, jtables, jcfg)


@functools.lru_cache(maxsize=None)
def _jax_force(species):
    # int32 species: the program of tests/test_md.py's and
    # test_torch_opt.py's SD force on this batch, compiled once for all
    return jopt._force_fn(pq.make_constants(dtype=jnp.float64),
                          pq.load_element_tables("AM1", dtype=jnp.float64),
                          pq.SEQMConfig(method="AM1", scf=JSCFConfig(**SCF)),
                          jnp.asarray(species, jnp.int32), None)


@pytest.fixture
def jax_force(monkeypatch, golden):
    """The JAX base driver's compute_force as one jitted program."""
    f = _jax_force(tuple(map(tuple, golden("am1_md")["species"].tolist())))

    def compute_force(self, species, state, charges=None):
        return f(state.coordinates, state.P)
    monkeypatch.setattr(jmd.MolecularDynamics, "compute_force",
                        compute_force)


def _jax_state(st, key):
    return jmd.MDState(
        coordinates=jnp.asarray(_np(st.coordinates)),
        velocities=jnp.asarray(_np(st.velocities)),
        acc=jnp.asarray(_np(st.acc)), P=jnp.asarray(_np(st.P)),
        E0=jnp.asarray(_np(st.E0)), key=key, step=jnp.asarray(st.step))


def test_langevin_trajectory_matches_jax(golden, jax_force):
    """Coordinates and velocities after 5 steps to 1e-8, with the JAX
    driver's draws (fold_in(key, step)) fed through random_normal."""
    sp, co, v0, port, ref = _setup(golden)
    mdcfg = dict(timestep=0.5, damp=10.0, temperature=300.0)
    key = jax.random.PRNGKey(7)

    def jax_noise(state, shape):
        k = jax.random.fold_in(key, state.step)
        return torch.tensor(np.asarray(jax.random.normal(k, shape,
                                                         jnp.float64)))

    md = tmd.LangevinDynamics(*port, tmd.MDConfig(**mdcfg),
                              generator=torch.Generator())
    md.random_normal = jax_noise
    st = md.initialize(sp, torch.tensor(co), velocities=torch.tensor(v0))
    jdrv = jmd.LangevinDynamics(*ref, jmd.MDConfig(**mdcfg))
    jst = _jax_state(st, key)
    for _ in range(STEPS):
        st, obs = md.step(sp, st)
        jst, jobs = jdrv.step(jnp.asarray(sp), jst)
    assert st.step == int(jst.step) == STEPS
    for a, b in ((st.coordinates, jst.coordinates),
                 (st.velocities, jst.velocities), (obs.T, jobs.T),
                 (obs.Epot, jobs.Epot)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-8)


def test_nose_hoover_trajectory_matches_jax(golden, jax_force):
    """Coordinates, velocities and the chain's vxi and xi after 5 steps
    from given velocities to 1e-8; Ek/T are the post-thermostat ones."""
    sp, co, v0, port, ref = _setup(golden)
    mdcfg = dict(timestep=0.4, temperature=300.0)
    md = tmd.NoseHooverDynamics(*port, tmd.MDConfig(**mdcfg), tau=10.0)
    st = md.initialize(sp, torch.tensor(co), velocities=torch.tensor(v0))
    assert isinstance(st, tmd.NHState)
    jdrv = jmd.NoseHooverDynamics(*ref, jmd.MDConfig(**mdcfg), tau=10.0)
    z = jnp.zeros((sp.shape[0], 2))
    jst = jmd.NHState(base=_jax_state(st.base, jax.random.PRNGKey(0)),
                      vxi=z, xi=z)
    for _ in range(STEPS):
        st, obs = md.step(sp, st)
        jst, jobs = jdrv.step(jnp.asarray(sp), jst)
    for a, b in ((st.coordinates, jst.coordinates),
                 (st.velocities, jst.velocities), (st.vxi, jst.vxi),
                 (st.xi, jst.xi), (obs.T, jobs.T), (obs.Ek, jobs.Ek)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-8)
    assert float(np.abs(_np(st.vxi)).max()) > 0.0
    _, T = tmd.kinetic_energy(md.const, torch.tensor(sp), st.velocities)
    np.testing.assert_array_equal(_np(T), _np(obs.T))
    # run() drives the wrapped state and removes COM motion through it
    md2 = tmd.NoseHooverDynamics(
        *port, tmd.MDConfig(**mdcfg, remove_com=2), tau=10.0)
    st2 = md2.run(sp, md2.initialize(sp, torch.tensor(co),
                                     velocities=torch.tensor(v0)),
                  steps=2, thermo=2, log=False)
    assert isinstance(st2, tmd.NHState) and st2.step == 2
    mass = _np(tmd.atom_masses_zero_pad(md2.const, torch.tensor(sp)))
    np.testing.assert_allclose((mass * _np(st2.velocities)).sum(axis=1), 0.0,
                               atol=1e-12)


def test_langevin_generator_noise_and_contract(golden):
    """The port's draw: N(0,1) from the given generator (mean 0, variance
    1 over 60,000 draws; the same seed gives the same trajectory), the
    random force of padding atoms zero, and a driver without a generator
    refuses to start."""
    sp, co, v0, port, _ = _setup(golden)
    md = tmd.LangevinDynamics(*port, tmd.MDConfig(timestep=0.5, damp=10.0))
    with pytest.raises(ValueError, match="Generator"):
        md.initialize(sp, torch.tensor(co), velocities=torch.tensor(v0))
    st = md.initialize(sp, torch.tensor(co), velocities=torch.tensor(v0),
                       generator=torch.Generator().manual_seed(3))
    x = md.random_normal(st, (20000, 3)).numpy()
    assert abs(x.mean()) < 0.02 and abs(x.var() - 1.0) < 0.03

    # the force's random part over its per-atom scale is that draw, and
    # padding atoms get no force at all
    draws = []
    md.random_normal = lambda s, shape: draws.append(  # noqa: E731
        tmd.LangevinDynamics.random_normal(md, s, shape)) or draws[-1]
    F, _, _ = md.compute_force(torch.tensor(sp), st)
    md.random_normal = lambda s, shape: torch.zeros(shape,  # noqa: E731
                                                    dtype=torch.float64)
    F0, _, _ = md.compute_force(torch.tensor(sp), st)
    mass = _np(tmd.atom_masses(md.const, torch.tensor(sp)))
    scale = tmd.FR_SCALE * np.sqrt(2.0 * 300.0 * mass / 0.5 / 10.0)
    real = sp > 0
    np.testing.assert_allclose(_np(F - F0)[real] / scale[real],
                               _np(draws[0])[real], rtol=1e-9, atol=1e-9)
    assert not _np(F)[~real].any()

    runs = []
    for _ in range(2):
        m = tmd.LangevinDynamics(*port, tmd.MDConfig(timestep=0.5, damp=10.0),
                                 generator=torch.Generator().manual_seed(5))
        s = m.initialize(sp, torch.tensor(co), velocities=torch.tensor(v0))
        s, _ = m.step(sp, s)
        runs.append(_np(s.coordinates))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_thermostat_drivers_forward_charges(golden):
    """The NVT drivers thread per-molecule charges into every SCF and
    validate the species with them (H3O+/NH4+/OH-)."""
    g = golden("am1_charged")
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device=CPU,
                                  scf=SCFConfig(**SCF))
    co = torch.tensor(g["coordinates"])
    for drv in (tmd.NoseHooverDynamics(const, tables, cfg,
                                       tmd.MDConfig(timestep=0.5),
                                       charges=g["charges"]),
                tmd.LangevinDynamics(const, tables, cfg,
                                     tmd.MDConfig(timestep=0.5),
                                     charges=g["charges"],
                                     generator=torch.Generator())):
        st = drv.initialize(g["species"], co,
                            velocities=torch.zeros_like(co))
        base = getattr(st, "base", st)
        np.testing.assert_allclose(_np(base.E0), g["Hf"], atol=1e-7)
        uncharged = type(drv)(const, tables, cfg, tmd.MDConfig(timestep=0.5))
        with pytest.raises(ValueError, match="closed-shell"):
            uncharged.initialize(g["species"], co,
                                 velocities=torch.zeros_like(co),
                                 generator=torch.Generator())
