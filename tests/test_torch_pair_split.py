"""PyTorch port, the class-segmented flat pair list (``pack_pairs=True``
with ``dense_pair_grid=False``; the port of tests/test_pair_packing.py's
split tests) on the CPU: ``hcore_split`` and ``fock(WPackSplit)`` against
the JAX package at f64 and against the unified flat pair list on every
physical matrix element; energy and force (and the XL force) through the
split layout against the JAX package's and the unified layout's; the
degenerate segment shapes (all hydrogen K = 0, all heavy K = A); and the
float32 split pipeline against float64."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.ops import fock as jfock
from pyseqm_tpu.ops import hcore as jhcore
from pyseqm_tpu.parameters import gather_atom_parameters as jgather
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu.scf import init_density as jinit_density
from pyseqm_tpu.system import make_system as jmake_system
from pyseqm_tpu_torch.models.xlbomd import force_xl
from pyseqm_tpu_torch.ops import fock as tfock
from pyseqm_tpu_torch.ops import hcore as thcore
from pyseqm_tpu_torch.parameters import gather_atom_parameters
from pyseqm_tpu_torch.scf import SCFConfig, init_density
from pyseqm_tpu_torch.system import make_system, pair_index, pair_index_packed
from pyseqm_tpu_torch.utils.molecules import make_batch

torch.set_num_threads(1)
NMOL = 8
# f64 integrals and Fock matrices: the same formulas in another operation
# order
TOL_OP = 1e-11


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _orbital_block_mask(species):
    """(nmol, A, A, 4, 4) mask of the physically existing matrix elements
    (test_pair_packing.py: the split layout leaves the dead hydrogen p
    positions at zero, the unified formula writes s-like values there)."""
    om = np.zeros(species.shape + (4,), bool)
    om[..., 0] = species > 0
    om[..., 1:] = (species > 1)[..., None]
    return om[:, :, None, :, None] & om[:, None, :, None, :]


def _split_cfg(K, eps=1.0e-9, pack_pairs=True):
    return dict(scf=SCFConfig(eps=eps, converger=(2,), pack_heavy=K),
                pack_pairs=pack_pairs, dense_pair_grid=False)


@functools.lru_cache(maxsize=None)
def jax_split():
    """In one jitted program on make_batch(8, 8): JAX's hcore_split and
    its Fock matrix at the initial density, and its force and energy
    through the split layout (pack_pairs, dense_pair_grid=False)."""
    sp, co = make_batch(NMOL, 8, jitter=0.02)
    K = pt.packed_heavy_count(sp)
    jc = pq.make_constants(dtype=jnp.float64)
    jt = pq.load_element_tables("AM1", dtype=jnp.float64)
    cfg = pq.SEQMConfig(method="AM1", pack_pairs=True, dense_pair_grid=False,
                        scf=JSCFConfig(eps=1.0e-9, converger=(2,),
                                       pack_heavy=K))

    def ref(c):
        s = jmake_system(jc, jnp.asarray(sp), c, heavy_count=K)
        p = jgather(jt, "AM1", s.species)
        M, w = jhcore.hcore_split(jc, s, p, K)
        F = jfock.fock(s, jinit_density(jc, s), M, w, p)
        f, out = pq.force(jc, jt, cfg, jnp.asarray(sp), c)
        return M, w, F, f, out.Hf
    out = jax.jit(ref)(jnp.asarray(co))
    return sp, co, K, jax.tree.map(np.asarray, out)


def _port(dtype=torch.float64):
    return (pt.make_constants(dtype=dtype, device="cpu"),
            pt.load_element_tables("AM1", device="cpu", dtype=dtype))


def test_hcore_fock_split_match_jax_and_unified():
    sp, co, K, (jM, jw, jF, _, _) = jax_split()
    const, tables = _port()
    c = torch.tensor(co)
    sysP = make_system(const, sp, c, heavy_count=K)
    sys0 = make_system(const, sp, c)
    p = gather_atom_parameters(tables, "AM1", sysP.species)
    MP, wP = thcore.hcore_split(const, sysP, p, K)
    np.testing.assert_allclose(_np(MP), jM, rtol=0, atol=TOL_OP)
    np.testing.assert_allclose(_np(wP.xx.ri), jw.xx.ri, rtol=0, atol=TOL_OP)
    np.testing.assert_allclose(_np(wP.xx.U), jw.xx.U, rtol=0, atol=1e-13)
    np.testing.assert_allclose(_np(wP.xh), jw.xh, rtol=0, atol=TOL_OP)
    np.testing.assert_allclose(_np(wP.hh), jw.hh, rtol=0, atol=TOL_OP)
    P0 = init_density(const, sysP)
    FP = tfock.fock(sysP, P0, MP, wP, p)
    np.testing.assert_allclose(_np(FP), jF, rtol=0, atol=TOL_OP)

    # the unified flat pair list on every physical element, and (ss|ss)
    # per pair across the two pair orderings
    M0, w0 = thcore.hcore(const, sys0, p)
    bm = _orbital_block_mask(sp)
    np.testing.assert_allclose(np.where(bm, _np(MP), 0.0),
                               np.where(bm, _np(M0), 0.0), rtol=0,
                               atol=TOL_OP)
    A = sp.shape[1]
    lut = {(i, j): k for k, (i, j) in enumerate(zip(*pair_index(A)))}
    g0, gP = _np(w0.ri[..., 0]), _np(wP.gam())
    for k, (i, j) in enumerate(zip(*pair_index_packed(A, K))):
        np.testing.assert_allclose(gP[:, k], g0[:, lut[(i, j)]], rtol=0,
                                   atol=TOL_OP)
    F0 = tfock.fock(sys0, P0, M0, w0, p)
    fm = bm.transpose(0, 1, 3, 2, 4).reshape(F0.shape)
    np.testing.assert_allclose(np.where(fm, _np(FP), 0.0),
                               np.where(fm, _np(F0), 0.0), rtol=0,
                               atol=TOL_OP)


def test_energy_force_split_match_jax_and_unified():
    """Energy and force through the split layout against the JAX
    package's (the SCF's tolerance class of the other layouts' tests) and
    the unified flat layout's (test_pair_packing.py: 1e-9 eV, 1e-8 eV/A);
    the XL force on the converged density as well."""
    sp, co, K, (_, _, _, jf, jhf) = jax_split()
    const, tables = _port()
    c = torch.tensor(co)
    res = {}
    for pp in (False, True):
        cfg = pt.SEQMConfig(method="AM1", **_split_cfg(K, pack_pairs=pp))
        f, out = pt.force(const, tables, cfg, sp, c)
        assert type(out.w).__name__ == ("WPackSplit" if pp else "WPack")
        fx, hfx, _ = force_xl(const, tables, cfg, sp, c, out.P)
        res[pp] = [_np(t) for t in (out.Hf, f, hfx, fx)]
    np.testing.assert_allclose(res[True][0], jhf, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res[True][1], jf, rtol=0, atol=1e-8)
    for k, tol in enumerate((1e-9, 1e-8, 1e-9, 1e-8)):
        np.testing.assert_allclose(res[True][k], res[False][k], rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("case", ["all_hydrogen", "heavy_and_padding",
                                  "all_heavy"])
def test_split_degenerate_segments(case):
    """All hydrogen (K = 0: every pair HH) and all heavy (K = A: every
    pair XX, XH and HH empty) batches run the empty segment slices."""
    species, coords, K = {
        "all_hydrogen": ([[1, 1, 0, 0]], [[[0., 0., 0.], [0., 0., .74],
                                           [9., 9., 9.], [9., 9., 9.5]]], 0),
        "heavy_and_padding": ([[8, 6, 0, 0]],
                              [[[0., 0., 0.], [0., 0., 1.13],
                                [9., 9., 9.], [9., 9., 9.5]]], 2),
        "all_heavy": ([[8, 6]], [[[0., 0., 0.], [0., 0., 1.13]]], 2)}[case]
    sp = np.asarray(species)
    c = torch.tensor(coords, dtype=torch.float64)
    const, tables = _port()
    ref = None
    for pp in (False, True):
        cfg = pt.SEQMConfig(method="AM1", **_split_cfg(
            K if pp else None, pack_pairs=pp))
        f, out = pt.force(const, tables, cfg, sp, c)
        if ref is None:
            ref = (_np(out.Hf), _np(f))
        else:
            np.testing.assert_allclose(_np(out.Hf), ref[0], rtol=0,
                                       atol=1e-9)
            np.testing.assert_allclose(_np(f), ref[1], rtol=0, atol=1e-8)


def test_split_float32_accuracy():
    """The float32 split pipeline against float64 (test_pair_packing.py's
    bounds: 5e-4 eV, 5e-3 eV/A)."""
    sp, co = make_batch(NMOL, 8, jitter=0.02)
    K = pt.packed_heavy_count(sp)
    res = {}
    for dtype, eps in ((torch.float64, 1.0e-9), (torch.float32, 1.0e-5)):
        const, tables = _port(dtype)
        cfg = pt.SEQMConfig(method="AM1", **_split_cfg(K, eps=eps))
        f, out = pt.force(const, tables, cfg, sp, torch.tensor(co,
                                                               dtype=dtype))
        res[dtype] = (_np(out.Hf).astype(np.float64),
                      _np(f).astype(np.float64))
    dhf = np.abs(res[torch.float32][0] - res[torch.float64][0]).max()
    df = np.abs(res[torch.float32][1] - res[torch.float64][1]).max()
    assert dhf < 5.0e-4, dhf
    assert df < 5.0e-3, df


def test_split_mode1_grads_match_unified():
    """The adjoint (mode 1) through the split layout: its nested integral
    leaves carry the same gradients as the unified flat pair list's."""
    sp, co = make_batch(4, 8, jitter=0.02)
    K = pt.packed_heavy_count(sp)
    const, tables = _port()
    res = {}
    for pp in (False, True):
        cfg = pt.SEQMConfig(method="AM1", pack_pairs=pp,
                            dense_pair_grid=False, scf=SCFConfig(
                                eps=1.0e-10, converger=(2,), backward=1,
                                backward_eps=1.0e-8, pack_heavy=K))
        U = tables["U_ss"][torch.as_tensor(sp)].clone().requires_grad_(True)
        c = torch.tensor(co, requires_grad=True)
        out = pt.energy(const, tables, cfg, sp, c, learned={"U_ss": U})
        res[pp] = [_np(t) for t in torch.autograd.grad(
            out.P[:, 0, 0].sum() + out.Hf.sum(), (U, c))]
    for a, b in zip(res[True], res[False]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
