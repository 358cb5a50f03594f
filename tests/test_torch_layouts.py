"""PyTorch port, the unpacked integral layouts against the JAX package on
the CPU at f64: the flat ``hcore`` (and its grid exit), ``hcore_dense``,
the block-grid ``hcore_dense_split``, every ``fock()`` branch, the flat
``pair_nuclear_energy``, the unpacked ``sp2`` routes with and without
Gelfand bounds, ``eigh_rescue``; energy and force with the default
``SCFConfig()`` on am1_batch96 (against JAX and the goldens), the dense
grid against the flat pair list, a molecule with A >= 64 where the dense
grid is the default, three XL-BOMD steps on the unpacked route, and the
configurations that raise."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.drivers.md import MDConfig as JMDConfig
from pyseqm_tpu.drivers.xlbomd import XLBOMD as JXLBOMD
from pyseqm_tpu.ops import density as jdens
from pyseqm_tpu.ops import fock as jfock
from pyseqm_tpu.ops import hcore as jhcore
from pyseqm_tpu.ops import tetci as jtetci
from pyseqm_tpu.parameters import gather_atom_parameters as jgather
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu.system import make_system as jmake_system
from pyseqm_tpu_torch.drivers.md import MDConfig
from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
from pyseqm_tpu_torch.models.xlbomd import force_xl
from pyseqm_tpu_torch.ops import density as tdens
from pyseqm_tpu_torch.ops import energy as tenergy
from pyseqm_tpu_torch.ops import fock as tfock
from pyseqm_tpu_torch.ops import hcore as thcore
from pyseqm_tpu_torch.ops import matrix as tmatrix
from pyseqm_tpu_torch.ops import tetci as ttetci
from pyseqm_tpu_torch.parameters import gather_atom_parameters
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.system import make_system
from pyseqm_tpu_torch.utils.molecules import make_alkane, make_batch
from test_torch_slice import assert_xl_states_match, jax_xl_init

torch.set_num_threads(1)
NMOL = 24
# f64 integrals and Fock matrices: the same formulas in another operation
# order (matrix products here, unrolled elementwise code there)
TOL_OP = 1e-11
# the default SCF at the golden tests' convergence
DEFAULT_SCF = dict(eps=1.0e-10, converger=(2,))


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


@functools.lru_cache(maxsize=None)
def jax_default_force():
    """The JAX package's force and energy output on the first NMOL
    molecules of am1_batch96 with the default layout and SCF (eps 1e-10,
    converger 2) and eig=True, in one jitted program.  test_torch_eigh.py
    holds the port's packed eigh SCF to the same output: the same SCF on
    the packed matrices (eig adds the orbital energies and charges)."""
    g = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "am1_batch96.npz"))
    sp, co = g["species"][:NMOL], g["coordinates"][:NMOL]
    jcfg = pq.SEQMConfig(method="AM1", eig=True,
                         scf=JSCFConfig(**DEFAULT_SCF))
    jc = pq.make_constants(dtype=jnp.float64)
    jt = pq.load_element_tables("AM1", dtype=jnp.float64)
    jf, jout = jax.jit(lambda x: pq.force(jc, jt, jcfg, jnp.asarray(sp), x))(
        jnp.asarray(co))
    return dict(sp=sp, co=co, jc=jc, jt=jt, jf=jf, jout=jout)


def _close(a, b, atol=TOL_OP, msg=""):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=atol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def case():
    """The first NMOL molecules of am1_batch96 in both packages, a
    symmetric trial density, and every layout's integrals and Fock matrix
    from the JAX package: the flat pair list's from the default-layout
    run (its Hcore, integrals, per-pair nuclear energies, and Fock matrix
    at its density), the grids' in one jitted program."""
    ref = jax_default_force()
    sp, co, jout = ref["sp"], ref["co"], ref["jout"]
    K = pt.packed_heavy_count(sp)
    A = sp.shape[1]
    rng = np.random.RandomState(11)
    X = rng.randn(NMOL, 4 * A, 4 * A) * 0.3
    P = X + np.swapaxes(X, 1, 2)
    jc, jt = ref["jc"], ref["jt"]

    def grids(x, P, w):
        jsys = jmake_system(jc, jnp.asarray(sp), x)
        jp = jgather(jt, "AM1", jsys.species)
        # hcore(dense_grid=True)'s exit
        wg_flat = jtetci.to_grid(w, A, jsys.pair_i, jsys.pair_j)
        Md, wd = jhcore.hcore_dense(jc, jsys, jp)
        Ms, ws = jhcore.hcore_dense_split(jc, jsys, jp, K)
        return dict(wg_flat=wg_flat, Md=Md, wd=wd, Ms=Ms, ws=ws,
                    F_grid=jfock.fock(jsys, P, Md, wd, jp),
                    F_split=jfock.fock(jsys, P, Ms, ws, jp))
    jref = jax.jit(grids)(jnp.asarray(co), jnp.asarray(P), jout.w)
    jref.update(M=jout.Hcore, w=jout.w, F_flat=jout.F, enuc=jout.EnucAB)
    tc = pt.make_constants(dtype=torch.float64, device="cpu")
    tt = pt.load_element_tables("AM1", device="cpu", dtype=torch.float64)
    tsys = make_system(tc, sp, torch.tensor(co))
    tp = gather_atom_parameters(tt, "AM1", tsys.species)
    return dict(sp=sp, co=co, K=K, tc=tc, tsys=tsys, tp=tp, jref=jref,
                P=dict(grid=torch.tensor(P), split=torch.tensor(P),
                       flat=torch.tensor(np.asarray(jout.P))))


def test_hcore_flat_and_grid_exit_match_jax(case):
    c, j = case, case["jref"]
    M, w = thcore.hcore(c["tc"], c["tsys"], c["tp"])
    _close(tmatrix.grid_to_mat(M), j["M"])
    _close(w.ri, j["w"].ri)
    _close(w.U, j["w"].U, 1e-13)
    _, wg = thcore.hcore(c["tc"], c["tsys"], c["tp"], dense_grid=True)
    _close(wg.rig, j["wg_flat"].rig)
    _close(wg.ug, j["wg_flat"].ug, 1e-13)
    # from_grid inverts to_grid on the pair cells
    wf = ttetci.from_grid(wg, c["tsys"].pair_i, c["tsys"].pair_j)
    assert torch.equal(wf.ri, w.ri) and torch.equal(wf.U, w.U)
    # the bra/ket swap of the 22 locals is the transpose of w
    wfull = ttetci.assemble_w(w)
    wswap = ttetci.assemble_w(ttetci.WPack(
        ri=w.ri[..., torch.as_tensor(ttetci.RI_SWAP)], U=w.U))
    _close(wswap, wfull.permute(0, 1, 4, 5, 2, 3), 1e-12)
    # the materialized pipeline: the same w, and the electron-core blocks
    # that hcore sums on the diagonal
    tsys, iu, ju = c["tsys"], c["tsys"].pair_i, c["tsys"].pair_j
    mp = thcore.atom_multipoles(c["tc"], tsys.species, c["tp"])
    tore = c["tc"].tore
    w4, e1b, e2a = ttetci.two_center_integrals(
        tsys.rij, tsys.xij, tore[tsys.zi], tore[tsys.zj],
        *[mp[k][:, i] for k in ("dd", "qq", "rho0", "rho1", "rho2")
          for i in (iu, ju)])
    pm = tsys.pair_mask[..., None, None]
    _close(w4 * pm[..., None, None], _np(wfull), 1e-11)
    _, e1b_p, e2a_p = ttetci.pair_w_pack(
        tsys.rij, tsys.xij, tore[tsys.zi], tore[tsys.zj],
        *[mp[k][:, i] for k in ("dd", "qq", "rho0", "rho1", "rho2")
          for i in (iu, ju)])
    _close(e1b, _np(e1b_p), 1e-12)
    _close(e2a, _np(e2a_p), 1e-12)


def test_hcore_dense_and_split_grid_match_jax(case):
    c, j = case, case["jref"]
    Md, wd = thcore.hcore_dense(c["tc"], c["tsys"], c["tp"])
    _close(Md, j["Md"])
    _close(wd.rig, j["wd"].rig)
    _close(wd.ug, j["wd"].ug, 1e-13)
    # the dense grid's Hcore is the flat one's on every element
    _close(tmatrix.grid_to_mat(Md), j["M"])
    Ms, ws = thcore.hcore_dense_split(c["tc"], c["tsys"], c["tp"], c["K"])
    _close(Ms, j["Ms"])
    for a, b in ((ws.xx.rig, j["ws"].xx.rig), (ws.xh, j["ws"].xh),
                 (ws.hh, j["ws"].hh)):
        _close(a, b)


@pytest.mark.parametrize("layout", ["flat", "grid", "split"])
def test_fock_branches_match_jax(case, layout):
    c = case
    if layout == "flat":
        M, w = thcore.hcore(c["tc"], c["tsys"], c["tp"])
    elif layout == "grid":
        M, w = thcore.hcore_dense(c["tc"], c["tsys"], c["tp"])
    else:
        M, w = thcore.hcore_dense_split(c["tc"], c["tsys"], c["tp"], c["K"])
    # the grids at the trial density, the flat pairs at the density of the
    # JAX run whose Fock matrix they are held to
    F = tfock.fock(c["tsys"], c["P"][layout], M, w, c["tp"])
    _close(F, c["jref"][f"F_{layout}"])
    _close(F, _np(F).transpose(0, 2, 1), 1e-12)


def test_flat_pair_nuclear_energy_and_totals_match_jax(case):
    c = case
    _, w = thcore.hcore(c["tc"], c["tsys"], c["tp"])
    enuc = tenergy.pair_nuclear_energy(c["tc"], c["tsys"], w.ri[..., 0],
                                       "AM1", c["tp"])
    _close(enuc, c["jref"]["enuc"])
    # the flat pairs and the dense grid's upper triangle: the same terms
    grid, _ = tenergy.pair_nuclear_energy_dense(
        c["tc"], c["tsys"], thcore.hcore_dense(c["tc"], c["tsys"],
                                               c["tp"])[1].rig[..., 0],
        "AM1", c["tp"])
    _close(enuc.sum(-1), _np(grid.sum(-1)))
    P = c["P"]["grid"]
    Eel = tenergy.elec_energy(P, P, P)
    Etot, Enuc = tenergy.total_energy(enuc, Eel)
    _close(Enuc, _np(enuc).sum(-1), 1e-12)
    _close(Etot - Eel, _np(Enuc), 1e-12)
    # the plain electronic energies against their compensated forms
    _close(Eel, _np(tenergy.elec_energy_tf(P, P, P).value()), 1e-10)
    _close(tenergy.elec_energy_xl(P, 0.5 * P, P, 0.3 * P),
           _np(tenergy.elec_energy_xl_tf(P, 0.5 * P, P, 0.3 * P).value()),
           1e-10)


@pytest.fixture(scope="module")
def default_run(case, golden):
    """energy/force with the default SCFConfig in both packages."""
    c = case
    ref = jax_default_force()
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device="cpu",
                                  scf=SCFConfig(**DEFAULT_SCF))
    f, out = pt.force(const, tables, cfg, c["sp"], torch.tensor(c["co"]))
    return dict(ref, f=f, out=out, const=const, tables=tables, cfg=cfg,
                g=golden("am1_batch96"))


def test_energy_force_default_config_match_jax_and_golden(default_run):
    r = default_run
    out = r["out"]
    assert not out.notconverged.any()
    assert isinstance(out.w, ttetci.WPack)       # A = 8: the flat pairs
    for name in ("Hf", "Etot", "Eelec", "Enuc", "Eiso_sum"):
        _close(getattr(out, name), getattr(r["jout"], name), 1e-9, name)
    _close(r["f"], r["jf"], 1e-8)
    _close(out.P, r["jout"].P, 1e-8)
    # the golden bounds of test_energy.py test_batch96_parity
    _close(out.Hf, r["g"]["Hf"][:NMOL], 1e-6)
    _close(r["f"], r["g"]["force"][:NMOL], 3e-5)
    h = pt.hamiltonian(r["const"], r["tables"], r["cfg"], r["g"]["species"]
                       [:NMOL], torch.tensor(r["g"]["coordinates"][:NMOL]))
    for a, b in ((h.F, out.F), (h.P, out.P), (h.Hcore, out.Hcore)):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("kw", [dict(dense_pair_grid=True),
                                dict(dense_pair_grid=True, dense_fock=False)])
def test_dense_grid_matches_flat(default_run, case, kw):
    r = default_run
    cfg = dataclasses.replace(r["cfg"], **kw)
    f, out = pt.force(r["const"], r["tables"], cfg, case["sp"],
                      torch.tensor(case["co"]))
    assert isinstance(out.w, ttetci.WPackGrid)
    # f64: the same physics on another layout
    _close(out.Hf, _np(r["out"].Hf), 1e-10)
    _close(f, _np(r["f"]), 1e-10)


def test_sp2_unpacked_routes_and_rescue_match_jax(default_run, case):
    """The full-layout SP2 (valid-first permutation, with and without the
    pack_n cut and Gelfand bounds) and eigh_rescue (scored by a reference
    density and by the commutator) on a converged Fock matrix."""
    c, r = case, default_run
    F = r["out"].F.detach()
    jc = pq.make_constants(dtype=jnp.float64)
    n_pack = pt.packed_orbital_size(c["sp"], 8)
    routes = [dict(), dict(tight_bounds=True),
              dict(tight_bounds=True, pack_n=n_pack)]
    rng = np.random.RandomState(3)
    ref = F.numpy() * 0.0 + rng.rand(NMOL, 1, 1) * 1e-3
    # the commutators of SP2's converged densities are rounding noise, which
    # the two packages rank differently: the commutator-scored rescue gets
    # one density with an s-p_x offset of a per-molecule size on both sides
    E = np.zeros(F.shape[1:])
    E[0, 1] = E[1, 0] = 1.0
    off = rng.rand(NMOL, 1, 1) * 1e-4 * E

    def jref(Fj, refj, Pcj):
        jsys = jmake_system(jc, jnp.asarray(c["sp"]), jnp.asarray(c["co"]))
        Ps = [jdens.sp2(jsys, Fj, 1.0e-7, **kw) for kw in routes]
        return Ps, (jdens.eigh_rescue(jsys, Fj, Ps[0], 0.25, ref=refj),
                    jdens.eigh_rescue(jsys, Fj, Pcj, 0.25))
    P0 = None
    for kw in routes:
        P = tdens.sp2(c["tsys"], F, 1.0e-7, **kw)
        P0 = P if P0 is None else P0
    Pc = P0 + torch.tensor(off)
    jPs, jres = jax.jit(jref)(jnp.asarray(F.numpy()), jnp.asarray(ref),
                              jnp.asarray(Pc.numpy()))
    for kw, jP in zip(routes, jPs):
        P = tdens.sp2(c["tsys"], F, 1.0e-7, **kw)
        # f64: the same loop on the same input (XLA path on both sides)
        _close(P, jP, 1e-10, str(kw))
    Pr = tdens.eigh_rescue(c["tsys"], F, P0, 0.25, ref=torch.tensor(ref))
    _close(Pr, jres[0], 1e-10)
    _close(tdens.eigh_rescue(c["tsys"], F, Pc, 0.25), jres[1], 1e-10)
    # the refined bounds sit inside Gershgorin's
    Fp = tdens.permute_mat(F, tdens.orbital_permutation(c["tsys"])[0])
    h1, hN = tdens._gershgorin(Fp)
    sig = 0.5 * (h1 + hN)
    assert (tdens._gelfand_radius(Fp, sig) <= 0.5 * (hN - h1) + 1e-9).all()


def test_large_molecule_dense_default_with_remat():
    """A = 65 >= 64: the default layout is the dense grid with the
    integral build checkpointed (A >= 32), against the flat pair list."""
    z, x = make_alkane(21)
    sp, co = z[None], torch.tensor(x[None])
    out = []
    for kw in (dict(), dict(dense_pair_grid=False)):
        const, tables, cfg = pt.build(
            "AM1", dtype=torch.float64, device="cpu",
            scf=SCFConfig(eps=1.0e-10, converger=(2,)), **kw)
        f, o = pt.force(const, tables, cfg, sp, co)
        assert not o.notconverged.any()
        out.append((f, o.Hf, type(o.w).__name__))
    (f0, h0, l0), (f1, h1, l1) = out
    assert (l0, l1) == ("WPackGrid", "WPack")
    _close(h0, _np(h1), 1e-10)
    _close(f0, _np(f1), 1e-9)


def test_class_segmented_grid_without_packing():
    """pack_heavy where packing cannot shrink 4A (four atom slots): the
    class-segmented grid with fock(WPackGridSplit) and the full-layout
    SCF, against the flat pair list."""
    sp, co = make_batch(6, 4, jitter=0.03, seed=5)
    K = pt.packed_heavy_count(sp)
    assert pt.packed_solver_size(K, 4) is None
    res = []
    for pack in (K, None):
        const, tables, cfg = pt.build(
            "AM1", dtype=torch.float64, device="cpu",
            scf=SCFConfig(eps=1.0e-10, converger=(2,), pack_heavy=pack))
        f, o = pt.force(const, tables, cfg, sp, torch.tensor(co))
        res.append((f, o.Hf, type(o.w).__name__))
    assert (res[0][2], res[1][2]) == ("WPackGridSplit", "WPack")
    _close(res[0][1], _np(res[1][1]), 1e-10)
    _close(res[0][0], _np(res[1][0]), 1e-9)


def test_xlbomd_unpacked_trajectory_matches_jax(default_run):
    """Three XL-BOMD steps on the full layout (SP2 with Gelfand bounds,
    the pack_orbitals cut and the eigh rescue of the worst molecules) from
    the bootstrap of the default SCF: the port's on the molecules of the
    default-layout run, JAX's on that run's reference energy."""
    r = default_run
    sp, co = r["sp"], r["co"]
    boot = XLBOMD(r["const"], r["tables"], r["cfg"], MDConfig(timestep=1.0),
                  k=5)
    s = boot.initialize(sp, co, velocities=np.zeros_like(co),
                        initial_force=False)
    jcfg = pq.SEQMConfig(method="AM1", scf=JSCFConfig(**DEFAULT_SCF))
    js = jax_xl_init(JXLBOMD(r["jc"], r["jt"], jcfg, JMDConfig(timestep=1.0),
                             k=5), sp, co, r["jout"])
    assert s.Pt.shape[-1] == 4 * sp.shape[1]      # the full-layout state
    # f64: the same bootstrap density in the same state
    assert_xl_states_match(s, js)
    scf = dict(DEFAULT_SCF, use_sp2=True, sp2_eps=1.0e-7,
               sp2_tight_bounds=True, sp2_rescue=0.25,
               pack_orbitals=pt.packed_orbital_size(sp, 8))
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device="cpu",
                                  scf=SCFConfig(**scf))
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=1.0), k=5)
    jcfg = pq.SEQMConfig(method="AM1", scf=JSCFConfig(**scf))
    jmd = JXLBOMD(r["jc"], r["jt"], jcfg, JMDConfig(timestep=1.0), k=5)
    jsp = jnp.asarray(sp)
    jstep = jax.jit(lambda s: jmd.step(jsp, s))
    for _ in range(3):
        js, jobs = jstep(js)
        s, obs = md.step(sp, s)
    # f64, the same integrator, propagation and rescue
    assert_xl_states_match(s, js)
    for a, b in ((obs.Epot, jobs.Epot), (obs.charges, jobs.charges)):
        _close(a, b, 1e-8)


def test_unported_and_dropped_options_raise():
    sp, co = make_batch(2, 8, jitter=0.02)
    K = pt.packed_heavy_count(sp)
    const, tables, cfg = pt.build(
        "AM1", dtype=torch.float64, device="cpu",
        scf=SCFConfig(use_sp2=True, sp2_rescue=0.5, pack_heavy=K))
    n_st = pt.packed_solver_size(K, sp.shape[1])
    P = torch.zeros(2, n_st, n_st, dtype=torch.float64)
    # the packed XL route cannot apply the rescue: raise, not drop it
    with pytest.raises(ValueError, match="sp2_rescue"):
        force_xl(const, tables, cfg, sp, torch.tensor(co), P, packed_io=True)
    # a learned Kbeta hook whose pair count is not the batch's: raise, not
    # broadcast or drop it
    kb = torch.ones((2, sp.shape[1] * (sp.shape[1] - 1) // 2 - 1, 4),
                    dtype=torch.float64)
    with pytest.raises(ValueError, match="Kbeta"):
        pt.energy(const, tables, cfg, sp, torch.tensor(co),
                  learned={"Kbeta": kb})
