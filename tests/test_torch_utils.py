"""PyTorch port, the utilities on the CPU (the port of tests/test_aux.py's
utility tests): checkpoint round trip and exact resume of the NVE,
XL-BOMD, Nose-Hoover, Langevin (with the generator's state) and warm
L-BFGS states, structure and shape mismatches raising; the NaN
sanitizers; the seqm_parameters shim against the JAX package's, unknown
keys raising; xyz reading; the MD dump (frames at every dump boundary,
forces, the JAX package's frame format); and phase timing."""
import os
import types

import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.utils import io as jio
from pyseqm_tpu_torch.drivers.md import (ACC_SCALE, LangevinDynamics,
                                         MDConfig, MolecularDynamics,
                                         NoseHooverDynamics, atom_masses)
from pyseqm_tpu_torch.drivers.opt import (geometry_optimize_sd,
                                          make_lbfgs_warm)
from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.utils import check as tcheck
from pyseqm_tpu_torch.utils import io as tio
from pyseqm_tpu_torch.utils.checkpoint import load_state, save_state
from pyseqm_tpu_torch.utils.timing import Timing, profiler_trace

torch.set_num_threads(1)
CPU = "cpu"


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _setup(golden, eps=1.0e-9, **scf):
    g = golden("am1_md")
    const, tables, cfg = pt.build(
        "AM1", dtype=torch.float64, device=CPU,
        scf=SCFConfig(eps=eps, converger=(2,), **scf))
    sp = torch.tensor(g["species"], dtype=torch.long)
    return const, tables, cfg, sp, torch.tensor(g["coordinates"] * 1.03)


def _velocities(sp, seed=0):
    v = np.random.default_rng(seed).standard_normal(sp.shape + (3,)) * 0.01
    v[_np(sp) == 0] = 0.0
    return torch.tensor(v)


def _leaves(st):
    from pyseqm_tpu_torch.utils.checkpoint import _leaves
    return [x for _, x in _leaves(st)]


def _assert_same(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_checkpoint_roundtrip(tmp_path, golden):
    const, tables, cfg, sp, co = _setup(golden)
    md = MolecularDynamics(const, tables, cfg, MDConfig(timestep=0.5))
    st = md.initialize(sp, co, velocities=_velocities(sp))
    path = os.path.join(tmp_path, "ck.npz")
    save_state(path, st)
    st2 = load_state(path, st)
    _assert_same(st, st2)
    # a resumed trajectory is the uninterrupted one
    s1, s2 = st, st2
    for _ in range(3):
        s1, _ = md.step(sp, s1)
        s2, _ = md.step(sp, s2)
    assert torch.equal(s1.coordinates, s2.coordinates)


def test_checkpoint_mismatch_raises(tmp_path, golden):
    import dataclasses
    const, tables, cfg, sp, co = _setup(golden)
    md = MolecularDynamics(const, tables, cfg, MDConfig(timestep=0.5))
    st = md.initialize(sp, co, velocities=_velocities(sp))
    path = os.path.join(tmp_path, "ck.npz")
    save_state(path, st)
    # a structurally different target: a clear error, not reassignment
    with pytest.raises(ValueError, match="structure"):
        load_state(path, {"a": np.zeros(3)})
    # the same structure with another leaf shape
    bigger = dataclasses.replace(st, coordinates=torch.zeros(3, 7, 3,
                                                             dtype=co.dtype))
    with pytest.raises(ValueError, match="shape"):
        load_state(path, bigger)
    # a generator asked of a checkpoint saved without one
    with pytest.raises(ValueError, match="generator"):
        load_state(path, st, generator=torch.Generator())


def _lbfgs(const, tables, cfg, sp):
    init, run = make_lbfgs_warm(const, tables, cfg, sp, chunk=2,
                                force_tol=1e-6)
    return init, lambda st: run(st)[0]


@pytest.mark.parametrize("kind", ["xlbomd", "xlbomd_packed", "nose_hoover",
                                  "langevin", "lbfgs"])
def test_resume_is_exact(tmp_path, golden, kind):
    """Two steps, a checkpoint, two more steps: a driver built afresh and
    resumed from the file (and for Langevin a generator drawn elsewhere,
    restored from the file) reproduces the uninterrupted run exactly."""
    K = pt.packed_heavy_count(golden("am1_md")["species"])
    const, tables, cfg, sp, co = _setup(
        golden, **(dict(use_sp2=True, sp2_eps=1e-7, pack_heavy=K)
                   if kind == "xlbomd_packed" else {}))
    v = _velocities(sp)
    md_cfg = MDConfig(timestep=0.5, damp=10.0, temperature=300.0)

    def build(seed):
        """(driver's generator or None, initial state, step function)."""
        gen = None
        if kind.startswith("xlbomd"):
            md = XLBOMD(const, tables, cfg, md_cfg, k=5)
        elif kind == "nose_hoover":
            md = NoseHooverDynamics(const, tables, cfg, md_cfg, tau=10.0)
        elif kind == "langevin":
            gen = torch.Generator().manual_seed(seed)
            md = LangevinDynamics(const, tables, cfg, md_cfg, generator=gen)
        else:
            init, run = _lbfgs(const, tables, cfg, sp)
            return gen, init(co), run
        return gen, md.initialize(sp, co, velocities=v), \
            lambda st: md.step(sp, st)[0]

    gen, st, step = build(0)
    for _ in range(2):
        st = step(st)
    path = os.path.join(tmp_path, "ck.npz")
    save_state(path, st, generator=gen)
    for _ in range(2):
        st = step(st)

    gen2, like, step2 = build(123)
    resumed = load_state(path, like, generator=gen2)
    for _ in range(2):
        resumed = step2(resumed)
    _assert_same(st, resumed)


def test_sanitizer(tmp_path):
    x = torch.tensor([1.0, 2.0], dtype=torch.float64)
    assert torch.equal(tcheck.check(x, "ok"), x)
    with pytest.raises(FloatingPointError, match="bad: 2 non-finite"):
        tcheck.check(torch.tensor([1.0, float("nan"), float("inf")]), "bad")
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((tcheck.check_gradient(xg, "t") ** 2).sum(),
                               xg)
    assert torch.equal(g, 2.0 * x)
    # the cotangent is checked in the backward
    y = tcheck.check_gradient(xg, "t") * torch.tensor([1.0, float("nan")],
                                                      dtype=torch.float64)
    with pytest.raises(FloatingPointError, match=r"grad\(t\): 1"):
        y.sum().backward()
    tcheck.stats(x, "x")
    fn = os.path.join(tmp_path, "x.npy")
    tcheck.save(fn, x)
    np.testing.assert_array_equal(np.load(fn), _np(x))


SEQM_PARAMETERS = {
    "method": "PM3", "scf_eps": 1e-6, "scf_converger": [0, 0.3],
    "sp2": [True, 1e-5], "elements": [0, 1, 6, 8], "learned": [],
    "pair_outer_cutoff": 10.0, "eig": True, "scf_backward": 2,
    "scf_backward_eps": 1e-4, "Hf_flag": False,
}


def test_compat_shim():
    cfg = pt.from_seqm_parameters(SEQM_PARAMETERS)
    jcfg = pq.from_seqm_parameters(SEQM_PARAMETERS)
    for f in ("method", "hf_flag", "pair_outer_cutoff", "eig"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for f in ("eps", "converger", "use_sp2", "sp2_eps", "backward",
              "backward_eps"):
        assert getattr(cfg.scf, f) == getattr(jcfg.scf, f), f
    assert cfg.scf.converger == (0, 0.3) and cfg.scf.backward == 2
    # the JAX package's shim drops unknown keys; the port's raises
    for extra in ({"scf_convergr": [2]}, {"parameter_file_dir": "/x"}):
        with pytest.raises(ValueError, match="unknown seqm_parameters"):
            pt.from_seqm_parameters(dict(SEQM_PARAMETERS, **extra))
    with pytest.raises(ValueError, match="learned"):
        pt.from_seqm_parameters(dict(SEQM_PARAMETERS, learned=["U_sss"]))
    ok = pt.from_seqm_parameters(dict(SEQM_PARAMETERS,
                                      learned=["U_ss", "Kbeta"]))
    assert ok.method == "PM3"


def test_xyz_io(tmp_path):
    p = os.path.join(tmp_path, "m.xyz")
    with open(p, "w") as f:
        f.write("4\ncomment\nO 0 0 0.1\nH 0 0.75 -0.4\nH 0 -0.75 -0.4\n"
                "6 1.0 2.0 3.0\n")
    z, x = tio.read_xyz(p)
    jz, jx = jio.read_xyz(p)
    assert list(z) == [8, 1, 1, 6] and x.shape == (4, 3)
    np.testing.assert_array_equal(z, jz)
    np.testing.assert_array_equal(x, jx)


def test_md_dump_stride_and_forces(tmp_path, golden):
    """dump intervals that are not multiples of thermo still write frames;
    frames carry the reference's full column set with forces
    (MolecularDynamics.py:300-320), in the JAX package's format."""
    const, tables, cfg, sp, co = _setup(golden)
    md = MolecularDynamics(const, tables, cfg, MDConfig(timestep=0.5))
    st0 = md.initialize(sp, co, velocities=_velocities(sp, 4))
    prefix = os.path.join(tmp_path, "tr")
    # thermo=2, dump=3: boundaries at 3 (inside the second chunk) and 6
    md.run(sp, st0, steps=7, thermo=2, dump=3, dump_prefix=prefix,
           molids=(0, 1), log=False)
    lines = open(f"{prefix}.0.xyz").read().strip().splitlines()
    natom = int(lines[0])
    assert len(lines) // (natom + 2) == 2, "expected 2 frames"
    cols = lines[2].split()
    # symbol + 3 coordinates + 3 velocities + 3 forces + charge
    assert len(cols) == 11
    fx = np.array([float(c) for c in cols[7:10]])
    assert np.isfinite(fx).all() and (np.abs(fx) > 0).any()
    assert os.path.exists(f"{prefix}.1.xyz")
    # the frame of step 3 as the JAX package writes it for the same state
    st = st0
    for _ in range(3):
        st, obs = md.step(sp, st)
    snap = types.SimpleNamespace(coordinates=_np(st.coordinates),
                                 velocities=_np(st.velocities), step=3)
    jobs = type(obs)(*[_np(t) for t in obs])
    forces = _np(st.acc * atom_masses(const, sp) / ACC_SCALE)
    jprefix = os.path.join(tmp_path, "jax")
    jio.dump_frame(jprefix, None, _np(sp), snap, jobs, (0,), forces=forces)
    jlines = open(f"{jprefix}.0.xyz").read().splitlines()
    assert lines[:natom + 2] == jlines


def test_timing(tmp_path, golden):
    const, tables, cfg, sp, co = _setup(golden, eps=1e-7)
    t = Timing()
    md = MolecularDynamics(const, tables, cfg, MDConfig(timestep=0.5),
                           timing=t)
    st = md.initialize(sp, co, velocities=_velocities(sp))
    md.run(sp, st, steps=3, thermo=2, log=False)
    geometry_optimize_sd(const, tables, cfg, sp, co, alpha=0.004,
                         max_evl=2, timing=t)
    s = t.summary()
    assert s["MD"]["count"] == 2 and s["optimize"]["count"] == 2
    assert all(v["total"] > 0 and v["min"] <= v["mean"] for v in s.values())
    t.report()
    with profiler_trace(os.path.join(tmp_path, "trace")) as prof:
        md.step(sp, st)
    assert os.path.exists(os.path.join(tmp_path, "trace", "trace.json"))
    assert len(prof.key_averages()) > 0
