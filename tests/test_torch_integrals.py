"""PyTorch port, integral layer against the JAX package: the f32
double-float STO overlap (values and backward), the rho1/rho2 secant solves
and their implicit VJPs, hcore_dense_split(packed_m) and
fock_packed_split.  Inputs come from numpy seeds and the am1_batch96
golden geometries."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu_torch as pt
from pyseqm_tpu.ops import multipole as jmp
from pyseqm_tpu.ops import overlap as jov
from pyseqm_tpu_torch.ops import density as tdens
from pyseqm_tpu_torch.ops import fock as tfock
from pyseqm_tpu_torch.ops import hcore as thcore
from pyseqm_tpu_torch.ops import multipole as tmp
from pyseqm_tpu_torch.ops import overlap as tov
from pyseqm_tpu_torch.parameters import gather_atom_parameters
from pyseqm_tpu_torch.system import make_system
from test_torch_slice import jax_packed_force

torch.set_num_threads(1)
CPU = "cpu"


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _overlap_inputs(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    qni = rng.choice([1, 2], n)
    qnj = np.minimum(qni, rng.choice([1, 2], n))
    x = rng.randn(n, 3)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = rng.uniform(1.2, 9.0, n)
    zi = rng.uniform(0.8, 3.0, (n, 2))
    zj = rng.uniform(0.8, 3.0, (n, 2))
    return qni, qnj, x, r, zi, zj


def _port_overlap(args, dtype, precise, grad=False):
    qni, qnj, x, r, zi, zj = args
    ts = [torch.tensor(v, dtype=dtype) for v in (x, r, zi, zj)]
    for t in ts[1:]:
        t.requires_grad_(grad)
    S = tov.diatom_overlap(torch.tensor(qni), torch.tensor(qnj), *ts,
                           precise=precise)
    return S, ts


def test_precise_overlap_f32_values():
    args = _overlap_inputs()
    S, _ = _port_overlap(args, torch.float32, precise=True)
    # the f32 double-float and the f64 plain JAX values in one program
    jS, jS64 = jax.jit(lambda qni, qnj, *a: [jov.diatom_overlap(
        qni, qnj, *[t.astype(dt) for t in a], precise=dt == jnp.float32)
        for dt in (jnp.float32, jnp.float64)])(*map(jnp.asarray, args))
    exact = _np(_port_overlap(args, torch.float64, precise=False)[0])
    # |S| <= 1: both double-float chains round once into f32, so they sit
    # within 2 ulp (1.2e-7) of each other and ~3 ulp of the f64 integrals;
    # the plain f32 chain is ~100x worse (3e-5), which this bound excludes
    np.testing.assert_allclose(_np(S), np.asarray(jS), rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(_np(S), exact, rtol=0, atol=3.0e-7)
    # the f64 chains agree to rounding
    np.testing.assert_allclose(exact, np.asarray(jS64), rtol=0, atol=1e-13)


def test_precise_overlap_f32_backward_matches_jax_vjp():
    args = _overlap_inputs(n=600, seed=1)
    S, (x, r, zi, zj) = _port_overlap(args, torch.float32, precise=True,
                                      grad=True)
    g = np.random.RandomState(2).randn(*S.shape).astype(np.float32)
    gr, gzi, gzj = torch.autograd.grad(S, (r, zi, zj), torch.from_numpy(g))
    qni, qnj, xn, rn, zin, zjn = args
    f = lambda rr, a, b: jov.diatom_overlap(  # noqa: E731
        jnp.asarray(qni), jnp.asarray(qnj), jnp.asarray(xn, jnp.float32),
        rr, a, b, precise=True)
    _, vjp = jax.vjp(f, jnp.asarray(rn, jnp.float32),
                     jnp.asarray(zin, jnp.float32),
                     jnp.asarray(zjn, jnp.float32))
    jgr, jgzi, jgzj = vjp(jnp.asarray(g))
    # both backwards are the plain-f32 chain's gradient; op order differs
    # in the last bits only, amplified by the alternating-sign A/B sums
    for a, b in ((gr, jgr), (gzi, jgzi), (gzj, jgzj)):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=0,
                                   atol=2e-4 * np.abs(b).max())


def test_rho_additive_forward_and_vjp():
    rng = np.random.RandomState(4)
    n = 64
    h = rng.uniform(0.5, 6.0, n)          # hsp / hpp in eV
    d = rng.uniform(0.3, 1.5, n)          # dd / qq in Bohr
    mask = rng.rand(n) > 0.2
    g = rng.randn(n)
    for jf, tf in ((jmp.rho1_additive, tmp.rho1_additive),
                   (jmp.rho2_additive, tmp.rho2_additive)):
        jy, vjp = jax.vjp(lambda a, b: jf(a, b, jnp.asarray(mask)),
                          jnp.asarray(h), jnp.asarray(d))
        jgh, jgd = vjp(jnp.asarray(g))
        th = torch.tensor(h, requires_grad=True)
        td = torch.tensor(d, requires_grad=True)
        y = tf(th, td, torch.tensor(mask))
        gh, gd = torch.autograd.grad(y, (th, td), torch.tensor(g))
        # f64: same 25-step secant and the same analytic implicit VJP
        np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-13,
                                   atol=1e-13)
        np.testing.assert_allclose(_np(gh), np.asarray(jgh), rtol=1e-11,
                                   atol=1e-13)
        np.testing.assert_allclose(_np(gd), np.asarray(jgd), rtol=1e-11,
                                   atol=1e-13)


@pytest.fixture(scope="module")
def packed_case():
    """am1_batch96 on the packed layout in the port, and the JAX package's
    packed SP2 force run on it (test_torch_slice.py): its Hcore, integrals
    and Fock matrix at its density, unpacked to (nmol, 4A, 4A)."""
    ref = jax_packed_force()
    sp, co, K = ref["sp"], ref["co"], ref["K"]
    n_st = pt.packed_solver_size(K, sp.shape[1])
    tc = pt.make_constants(dtype=torch.float64, device=CPU)
    tt = pt.load_element_tables("AM1", device=CPU, dtype=torch.float64)
    tsys = make_system(tc, sp, torch.tensor(co), heavy_count=K)
    tp = gather_atom_parameters(tt, "AM1", tsys.species)
    tM, tw = thcore.hcore_dense_split(tc, tsys, tp, K, n_st)
    return dict(K=K, n_st=n_st, A=sp.shape[1], tsys=tsys, tp=tp, tM=tM,
                tw=tw, jout=ref["jout"])


def test_hcore_dense_split_packed_matches_jax(packed_case):
    c = packed_case
    jout, jw, tw = c["jout"], c["jout"].w, c["tw"]
    # f64 integrals: the same formulas, op order differs in rounding only
    np.testing.assert_allclose(
        _np(tdens.static_unpack_mat(c["tM"], c["K"], c["A"])),
        np.asarray(jout.Hcore), rtol=0, atol=1e-11)
    np.testing.assert_allclose(_np(tw.xx.rig), np.asarray(jw.xx.rig),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(_np(tw.xx.ug), np.asarray(jw.xx.ug),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(_np(tw.xh), np.asarray(jw.xh), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(_np(tw.hh), np.asarray(jw.hh), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(_np(tw.gam_grid()),
                               np.asarray(jw.gam_grid()), rtol=0, atol=1e-11)


def test_fock_packed_split_matches_jax(packed_case):
    """The packed Fock build at the density of the JAX run whose Fock
    matrix it is held to."""
    c = packed_case
    K, n_st, A = c["K"], c["n_st"], c["A"]
    P = tdens.static_pack_mat(torch.tensor(np.asarray(c["jout"].P)), K, n_st)
    tF = tfock.fock_packed_split(c["tsys"], P, c["tM"], c["tw"], c["tp"], K,
                                 n_st)
    # f64; the port contracts w with small matrix products where the JAX
    # package unrolls them: rounding-level differences on ~10 eV entries
    np.testing.assert_allclose(_np(tdens.static_unpack_mat(tF, K, A)),
                               np.asarray(c["jout"].F), rtol=0, atol=1e-11)
    np.testing.assert_allclose(_np(tF), _np(tF).transpose(0, 2, 1), rtol=0,
                               atol=1e-12)
