"""PyTorch port, eigh density path: the Jacobi kernel's plain version
against the JAX package's Pallas kernel in interpret mode (the cases of
test_kernels.py), the rescue of unconverged molecules, the eigh backward
against JAX's perturbation JVP, ``sym_eig`` on its three routes against
JAX at f64, and the whole slice (eigh SCF with ``eig=True``, hamiltonian,
eigh XL-BOMD) against JAX and the f64 goldens.  The CUDA kernel itself is
held against the plain version in test_torch_cuda.py."""
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
from pyseqm_tpu.ops import eigh_pallas as jeigh
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu.system import make_system as jmake_system
from pyseqm_tpu_torch.drivers.md import MDConfig
from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
from pyseqm_tpu_torch.ops import density as tdens
from pyseqm_tpu_torch.ops import eigh_kernel
from pyseqm_tpu_torch.ops.eigh_kernel import (JacobiEigh, eigh_jacobi,
                                              eigh_jacobi_reference,
                                              perturbation_vjp)
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.system import make_system
from pyseqm_tpu_torch.utils.molecules import make_batch
from test_torch_layouts import jax_default_force
from test_torch_slice import assert_xl_states_match, jax_xl_init

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _random_sym(B, n, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(B, n, n)
    return (0.5 * (A + np.swapaxes(A, 1, 2)) * 5.0).astype(np.float32)


def _degenerate(B, n, seed):
    """Non-power-of-two n with an exact double eigenvalue (test_kernels.py
    test_eigh_kernel_nonpow2_and_degenerate)."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(B, n, n))
    ev = np.sort(rng.randn(B, n) * 4.0, axis=-1)
    ev[:, 5] = ev[:, 4]
    A = np.einsum('bik,bk,bjk->bij', Q, ev, Q)
    return (0.5 * (A + np.swapaxes(A, 1, 2))).astype(np.float32)


def _projector(v, nocc):
    vo = v[..., :nocc].astype(np.float64)
    return np.einsum('bik,bjk->bij', vo, vo)


@pytest.mark.parametrize("case", ["random", "resid", "degenerate"])
def test_reference_matches_interpret_kernel(case):
    A = {"random": lambda: _random_sym(16, 32, 3),
         "resid": lambda: _random_sym(16, 32, 5),
         "degenerate": lambda: _degenerate(8, 24, 9)}[case]()
    B, n, _ = A.shape
    e, v, resid, sweeps = eigh_jacobi(torch.from_numpy(A), with_resid=True,
                                      return_sweeps=True)
    ej, vj, rj = jeigh.eigh_tpu(jnp.asarray(A), interpret=True,
                                with_resid=True)
    e, v = _np(e).astype(np.float64), _np(v).astype(np.float64)
    An = A.astype(np.float64)
    nrm = np.abs(An).max()
    assert e.shape == (B, n) and v.shape == (B, n, n)
    # two f32 Jacobi runs whose column sums round differently: each sits
    # 1.0e-5 to 2.8e-5 max|A| from the exact spectrum on these dense
    # matrices (the Gershgorin shift is ~10 max|A|, and e = sigma - |g|),
    # so they agree to that class, not to 1e-5 max|A|.  Measured gap:
    # 1.6e-5 (random), 2.1e-5 (resid), 8.3e-6 (degenerate) max|A|
    gap = np.abs(e - np.asarray(ej, np.float64)).max() / nrm
    assert gap <= 3.0e-5, f"plain vs interpret-mode kernel: {gap:.3e} max|A|"
    # the occupied projector is what the density uses (away from the
    # double eigenvalue at positions 4/5 of the degenerate case)
    for nocc in (3, n // 2):
        d = np.abs(_projector(v, nocc) - _projector(np.asarray(vj), nocc))
        assert d.max() < 5.0e-5
    assert (_np(resid) <= eigh_kernel.OFF_TOL).all()
    assert (np.asarray(rj) <= jeigh.OFF_TOL).all()
    assert ((_np(sweeps) >= 1) & (_np(sweeps) <= eigh_kernel.MAX_SWEEPS)).all()
    # the bounds of test_kernels.py against exact
    np.testing.assert_allclose(e, np.linalg.eigvalsh(An), rtol=0,
                               atol=5e-4 * nrm)
    assert np.abs(An @ v - e[:, None, :] * v).max() < 5.0e-4 * nrm
    assert np.abs(np.swapaxes(v, 1, 2) @ v - np.eye(n)).max() < 1.0e-5
    if case == "resid":
        # the same decomposition with or without the residual
        e2, v2 = eigh_jacobi(torch.from_numpy(A))
        assert np.array_equal(_np(e2), e.astype(np.float32))
        assert np.array_equal(_np(v2), v.astype(np.float32))


def test_wrapper_checks_and_dispatch():
    A = torch.from_numpy(_random_sym(3, 8, 1))
    before = eigh_kernel.launches
    out = eigh_jacobi(A, with_resid=True, return_sweeps=True)
    ref = eigh_jacobi_reference(A, with_resid=True, return_sweeps=True)
    # a CPU tensor runs the plain version; only kernel launches count
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert eigh_kernel.launches == before
    assert eigh_kernel.supported(128, torch.float32)
    assert not eigh_kernel.supported(129, torch.float32)
    assert not eigh_kernel.supported(16, torch.float64)
    with pytest.raises(TypeError):
        eigh_jacobi(A.double())
    with pytest.raises(ValueError):
        eigh_jacobi(torch.zeros(2, 130, 130))
    with pytest.raises(ValueError):
        eigh_jacobi(A.transpose(1, 2))
    with pytest.raises(ValueError):
        eigh_jacobi(A[:, :, :4])


def test_sort_rank_matches_stable_argsort():
    """The kernel's sort, a rank per column, gives torch.argsort(stable=
    True)'s order: on ties, on NaN (last), and on the padding columns of a
    solve (norm 0, so e = sigma: after every real column)."""
    rng = np.random.RandomState(12)
    e = torch.from_numpy(rng.randint(0, 4, size=(64, 16)).astype(np.float32))
    e[0, 3] = e[1, 0] = e[1, 9] = float("nan")
    order = torch.argsort(e, dim=-1, stable=True)
    pos = torch.empty_like(order).scatter_(
        1, order, torch.arange(16).expand(64, 16).contiguous())
    assert torch.equal(eigh_kernel.sort_rank(e), pos)

    A = torch.from_numpy(_random_sym(6, 5, 2))
    G0, sigma = eigh_kernel._shift_and_pad(A)
    assert G0.shape == (6, 8, 8) and not G0[:, 5:].any()
    assert not G0[:, :, 5:].any()
    G, nrm, _, _ = eigh_kernel._sweeps_reference(
        G0, eigh_kernel.OFF_TOL, eigh_kernel.MAX_SWEEPS)
    e_raw = sigma[:, None] - nrm
    assert torch.equal(e_raw[:, 5:], sigma[:, None].expand(6, 3))
    order = torch.argsort(e_raw, dim=-1, stable=True)
    assert (order[:, 5:] >= 5).all()
    e5, v5 = eigh_kernel._sort(G, nrm, sigma, 5)
    v_all = G / torch.clamp(nrm, min=1.0e-20)[:, None, :]
    assert torch.equal(e5, torch.take_along_dim(e_raw, order, -1)[:, :5])
    assert torch.equal(v5, torch.take_along_dim(
        v_all, order[:, None, :], -1)[:, :5, :5])


@pytest.mark.parametrize("n", [5, 16, 24])
def test_shift_is_the_sequential_row_sum(n):
    """sigma from row sums of |A| added in order, one float32 rounding per
    addition, as the kernel adds them down its column."""
    A = _random_sym(8, n, 4) * np.linspace(0.01, 100.0, n,
                                           dtype=np.float32)[None, :, None]
    A = 0.5 * (A + np.swapaxes(A, 1, 2))
    s = np.zeros((8, n), np.float32)
    for i in range(n):
        s = s + np.abs(A[:, i, :])
    aii = np.diagonal(A, axis1=1, axis2=2)
    r = s - np.abs(aii)
    h1, hN = (aii - r).min(-1), (aii + r).max(-1)
    sigma = hN + np.float32(0.05) * np.maximum(hN - h1, np.float32(1.0))
    assert sigma.dtype == np.float32
    got = eigh_kernel.gershgorin_shift(torch.from_numpy(A)).numpy()
    assert np.array_equal(got, sigma)
    G0, sig = eigh_kernel._shift_and_pad(torch.from_numpy(A))
    assert np.array_equal(sig.numpy(), sigma)
    np.testing.assert_array_equal(
        np.diagonal(G0.numpy(), axis1=1, axis2=2)[:, :n],
        sigma[:, None] - aii)


def test_rescue_after_one_sweep(monkeypatch):
    """MAX_SWEEPS forced to 1 (read at call time): the plain Jacobi flags
    molecules, the rescue re-solves exactly those with the exact eigh and
    passes the rest through unchanged (test_kernels.py
    test_eigh_rescue_unconverged_panels)."""
    A = torch.from_numpy(_random_sym(16, 32, 11))
    # every other matrix diagonal: its columns are orthogonal from the
    # start, so one sweep converges it and it must pass through
    A[1::2] = torch.diag_embed(torch.diagonal(A[1::2], dim1=1, dim2=2))
    monkeypatch.setattr(eigh_kernel, "MAX_SWEEPS", 1)
    e, v, resid, sweeps = eigh_jacobi(A, with_resid=True, return_sweeps=True)
    monkeypatch.undo()
    bad_expected = _np(resid) > eigh_kernel.OFF_TOL
    assert bad_expected[::2].all() and not bad_expected[1::2].any()
    assert (_np(sweeps) == 1).all()
    n0 = tdens.rescued
    e2, v2, bad = tdens.rescue_unconverged_panels(A, e, v, resid)
    assert np.array_equal(_np(bad), bad_expected)
    assert tdens.rescued - n0 == int(bad_expected.sum())
    An = A.double().numpy()
    nrm = np.abs(An).max()
    e_ref = np.linalg.eigvalsh(An)
    e2n, v2n = _np(e2).astype(np.float64), _np(v2).astype(np.float64)
    for b in range(A.shape[0]):
        if bad_expected[b]:
            np.testing.assert_allclose(e2n[b], e_ref[b], atol=5e-4 * nrm)
            res = np.abs(An[b] @ v2n[b] - e2n[b][None, :] * v2n[b]).max()
            assert res < 5.0e-4 * nrm
        else:
            assert np.array_equal(_np(e2[b]), _np(e[b]))
            assert np.array_equal(_np(v2[b]), _np(v[b]))
    # a converged batch flags nothing and passes through unchanged
    ec, vc, rc = eigh_jacobi(A, with_resid=True)
    ec2, vc2, badc = tdens.rescue_unconverged_panels(A, ec, vc, rc)
    assert not badc.any()
    assert ec2 is ec and vc2 is vc


def test_backward_matches_jax_perturbation_vjp(monkeypatch):
    rng = np.random.RandomState(4)
    B, n = 3, 6
    e = np.sort(rng.randn(B, n) * 3.0, axis=-1)
    v, _ = np.linalg.qr(rng.randn(B, n, n))
    e_bar, v_bar = rng.randn(B, n), rng.randn(B, n, n)
    (Aj,) = jax.jit(lambda eb, vb: jax.vjp(
        lambda dA: jeigh._perturbation_jvp(jnp.asarray(e), jnp.asarray(v), dA),
        jnp.zeros((B, n, n)))[1]((eb, vb)))(jnp.asarray(e_bar),
                                            jnp.asarray(v_bar))
    At = perturbation_vjp(*(torch.tensor(x) for x in (e, v, e_bar, v_bar)))
    # f64, the transpose of the same linear map
    np.testing.assert_allclose(_np(At), np.asarray(Aj), rtol=0, atol=1e-10)

    # through the autograd.Function, its forward run by the float64 plain
    # Jacobi (the wrapper itself takes float32 only)
    monkeypatch.setattr(eigh_kernel, "eigh_jacobi", eigh_jacobi_reference)
    A = torch.tensor(_random_sym(2, 4, 8), dtype=torch.float64,
                     requires_grad=True)
    ee, vv, res = JacobiEigh.apply(A)
    assert not res.requires_grad
    eb, vb = torch.tensor(rng.randn(2, 4)), torch.tensor(rng.randn(2, 4, 4))
    (g,) = torch.autograd.grad((ee * eb).sum() + (vv * vb).sum(), A)
    np.testing.assert_allclose(_np(g), _np(perturbation_vjp(
        ee.detach(), vv.detach(), eb, vb)), rtol=0, atol=1e-12)
    # finite differences need a forward that is smooth in A: at OFF_TOL =
    # 1e-12 the sweeps stop with ~1e-9 left in v, which a 1e-6 step turns
    # into 1e-3; at 1e-28 every sweep runs to f64 rounding.  The eigh
    # derivative is defined on symmetric perturbations, so the checked
    # function symmetrises its input
    monkeypatch.setattr(eigh_kernel, "OFF_TOL", 1.0e-28)
    assert torch.autograd.gradcheck(
        lambda X: JacobiEigh.apply(0.5 * (X + X.transpose(1, 2)))[:2],
        (A,), eps=1e-6, atol=1e-6)


def _systems(sp, co, K):
    jsys = jax.jit(lambda x: jmake_system(
        pq.make_constants(dtype=jnp.float64), jnp.asarray(sp), x,
        heavy_count=K))(jnp.asarray(co))
    tsys = make_system(pt.make_constants(dtype=torch.float64, device="cpu"),
                       sp, torch.tensor(co), heavy_count=K)
    return jsys, tsys


def _sign_aligned(v, vj):
    s = np.sign(np.einsum('bij,bij->bj', v, vj))
    return v * s[:, None, :]


def test_sym_eig_routes_match_jax():
    sp, co = make_batch(10, 8, jitter=0.05, seed=4)
    K = pt.packed_heavy_count(sp)
    A = sp.shape[1]
    n_st = pt.packed_solver_size(K, A)
    rng = np.random.RandomState(6)
    X = rng.randn(sp.shape[0], n_st, n_st)
    Fpk = 3.0 * (X + np.swapaxes(X, 1, 2)) - 20.0 * np.eye(n_st)
    Ffull = _np(tdens.static_unpack_mat(torch.tensor(Fpk), K, A))
    jsys, tsys = _systems(sp, co, K)
    routes = {
        "prepacked": (Fpk, dict(pack_heavy=K, prepacked=True,
                                check_degeneracy=True)),
        "pack_heavy": (Ffull, dict(pack_heavy=K)),
        "permutation": (Ffull, dict(check_degeneracy=True)),
        "pack_n": (Ffull, dict(pack_n=pt.packed_orbital_size(sp, 4))),
    }
    # every route's JAX reference, and eig_only's, in one program
    jref = jax.jit(lambda Fp, Ff: {
        name: jdens.sym_eig(jsys, Fp if name == "prepacked" else Ff, **kw)
        for name, (_, kw) in routes.items()} | {
        "eig_only": jdens.sym_eig(jsys, Ff, eig_only=True)})(
            jnp.asarray(Fpk), jnp.asarray(Ffull))
    Ps = {}
    for name, (F, kw) in routes.items():
        ej, Pj, vj = jref[name]
        e, P, v, flag = tdens.sym_eig(tsys, torch.tensor(F), with_flag=True,
                                      **kw)
        # f64: torch.linalg.eigh against jnp.linalg.eigh, same prep
        assert not flag.any()
        np.testing.assert_allclose(_np(e), np.asarray(ej), rtol=0,
                                   atol=1e-10, err_msg=name)
        np.testing.assert_allclose(_np(P), np.asarray(Pj), rtol=0,
                                   atol=1e-10, err_msg=name)
        vj = np.asarray(vj)
        np.testing.assert_allclose(_sign_aligned(_np(v), vj), vj, rtol=0,
                                   atol=1e-8, err_msg=name)
        Ps[name] = _np(P)
    e2, v2, flag = tdens.sym_eig(tsys, torch.tensor(Ffull), eig_only=True,
                                 with_flag=True)
    np.testing.assert_allclose(_np(e2), np.asarray(jref["eig_only"][0]),
                               rtol=0, atol=1e-10)
    # the XL eigh branch solves the packed F directly: the same D as
    # unpack -> pack_heavy solve (held to the JAX package above) -> pack
    np.testing.assert_allclose(
        _np(tdens.static_pack_mat(torch.tensor(Ps["pack_heavy"]), K, n_st)),
        Ps["prepacked"], rtol=0, atol=1e-12)

    # fractional occupations across a degenerate Fermi level
    e = np.sort(rng.randn(6, 12), axis=-1)
    e[:, 4] = e[:, 5] = e[:, 6]
    nocc = np.array([5, 6, 7, 4, 3, 1])
    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        occ = tdens._occupations(torch.tensor(e, dtype=dtype),
                                 torch.tensor(nocc), dtype, True)
        occj = jax.jit(jdens._occupations, static_argnums=(2, 3))(
            jnp.asarray(e, jdtype), jnp.asarray(nocc), jdtype, True)
        np.testing.assert_allclose(_np(occ), np.asarray(occj), rtol=0,
                                   atol=1e-7)
    assert np.allclose(_np(occ).sum(-1), nocc)
    # no electrons (an all-padding slot): all zero (the JAX package's index
    # nocc - 1 wraps to the last orbital here; ROADMAP Queue 3)
    occ0 = tdens._occupations(torch.tensor(e[:1]), torch.tensor([0]),
                              torch.float64, True)
    assert not occ0.any()


def _nondegenerate(e, norb, gap=1.0e-3):
    """(nmol, n) mask of orbitals at least ``gap`` eV from both
    neighbours, among the first norb."""
    d = np.diff(e, axis=-1)
    big = np.abs(d) > gap
    left = np.concatenate([np.ones_like(big[:, :1]), big], axis=1)
    right = np.concatenate([big, np.ones_like(big[:, :1])], axis=1)
    idx = np.arange(e.shape[-1])
    return left & right & (idx[None, :] < norb[:, None])


@pytest.mark.parametrize("method", ["AM1", "MNDO", "PM3"])
def test_eig_slice_batch96(golden, method):
    g = golden(f"{method.lower()}_batch96")
    sp, co = g["species"][:24], g["coordinates"][:24]
    const, tables, cfg = pt.build(
        method, dtype=torch.float64, device="cpu", eig=True,
        scf=SCFConfig(eps=1.0e-10, converger=(2,),
                      pack_heavy=pt.packed_heavy_count(sp)))
    f, out = pt.force(const, tables, cfg, sp, torch.tensor(co))
    assert not out.notconverged.any()
    assert out.e.shape == (24, 32) and out.charge.shape == (24, 32, 8)
    # golden bounds of test_energy.py test_batch96_parity
    np.testing.assert_allclose(_np(out.Hf), g["Hf"][:24], rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(out.e), g["e_orb"][:24], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(_np(f), g["force"][:24], rtol=0, atol=3e-5)
    # charge invariant: 2 sum_{mo < nocc} charge[mo, a] = sum of diag(P)
    # over atom a's orbitals.  The charges come from the eigenvectors of
    # F(P), P from the last SCF solve; the |dE| <= 1e-10 stop leaves the
    # two ~sqrt(1e-10) apart (worst 3.3e-6 AM1, 1.8e-5 PM3)
    sys_ = make_system(const, sp, torch.tensor(co))
    occ = np.arange(32)[None, :] < _np(sys_.nocc)[:, None]
    q_mo = 2.0 * np.einsum('nla,nl->na', _np(out.charge), occ)
    q_p = np.diagonal(_np(out.P), axis1=1, axis2=2).reshape(24, 8, 4).sum(-1)
    np.testing.assert_allclose(q_mo, q_p, rtol=0, atol=5e-5)
    h = pt.hamiltonian(const, tables, cfg, sp, torch.tensor(co))
    for a, b in ((h.F, out.F), (h.P, out.P), (h.e, out.e),
                 (h.charge, out.charge), (h.Hcore, out.Hcore)):
        assert torch.equal(a.detach(), b)
    if method != "AM1":
        return
    # against the JAX package's default layout with eig=True on the same
    # molecules (the same SCF on the unpacked matrices; one method: each
    # compiles its own program on the CPU)
    jout = jax_default_force()["jout"]
    for name in ("Hf", "Etot"):
        np.testing.assert_allclose(_np(getattr(out, name)),
                                   np.asarray(getattr(jout, name)), rtol=0,
                                   atol=1e-9, err_msg=name)
    # the converged density of the packed eigh SCF (the XL-BOMD bootstrap)
    np.testing.assert_allclose(_np(out.P), np.asarray(jout.P), rtol=0,
                               atol=1e-8)
    # per-MO charges of non-degenerate orbitals (sign-free, but a
    # degenerate pair mixes arbitrarily).  The golden ``charge`` is not
    # compared: it holds another convention (the same sum rules, but its
    # per-MO rows differ from the JAX package's and the port's by up to
    # 0.96 on non-degenerate orbitals)
    keep = _nondegenerate(_np(out.e), _np(sys_.norb))
    dq = np.abs(_np(out.charge) - np.asarray(jout.charge))
    assert dq[keep].max() <= 1e-8


def test_default_scfconfig_energy_runs():
    sp, co = make_batch(4, 8, jitter=0.02, seed=3)
    const, tables, cfg = pt.build(
        "AM1", dtype=torch.float64, device="cpu",
        scf=SCFConfig(pack_heavy=pt.packed_heavy_count(sp)))
    assert not cfg.scf.use_sp2 and not cfg.eig
    out = pt.energy(const, tables, cfg, sp, torch.tensor(co))
    assert torch.isfinite(out.Hf).all() and not out.notconverged.any()
    assert out.e is None and out.charge is None


def test_scf_check_degeneracy_reaches_the_solver(monkeypatch):
    """SCFConfig(check_degeneracy=True) reaches every density solve of the
    packed SCF; these closed-shell molecules have a gap at the Fermi level,
    so the fractional occupations are the integer ones and the energy is
    that of the default."""
    from pyseqm_tpu_torch import scf as tscf
    sp, co = make_batch(4, 8, jitter=0.02, seed=3)
    K = pt.packed_heavy_count(sp)
    seen = []

    def tapped(*args, **kwargs):
        seen.append(kwargs.get("check_degeneracy"))
        return tdens.sym_eig(*args, **kwargs)

    monkeypatch.setattr(tscf, "sym_eig", tapped)
    Hf = {}
    for check in (False, True):
        const, tables, cfg = pt.build(
            "AM1", dtype=torch.float64, device="cpu",
            scf=SCFConfig(eps=1.0e-10, converger=(2,), pack_heavy=K,
                          check_degeneracy=check))
        n0 = len(seen)
        out = pt.energy(const, tables, cfg, sp, torch.tensor(co))
        assert not out.notconverged.any()
        assert len(seen) > n0 and all(c is check for c in seen[n0:])
        Hf[check] = _np(out.Hf)
    np.testing.assert_allclose(Hf[True], Hf[False], rtol=0, atol=1e-9)


def test_xlbomd_eigh_trajectory_matches_jax():
    """Five XL-BOMD steps on eigh densities from JAX's bootstrap on the
    molecules of the eig=True reference (its energy is the bootstrap's:
    the packed eigh SCF solves the same equations)."""
    e = jax_default_force()
    sp, co = e["sp"], e["co"]
    scf = dict(eps=1.0e-10, converger=(2,), use_sp2=False,
               pack_heavy=pt.packed_heavy_count(sp))
    const, tables, cfg = pt.build("AM1", dtype=torch.float64, device="cpu",
                                  scf=SCFConfig(**scf))
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=1.0), k=5)
    s = md.initialize(sp, co, velocities=np.zeros_like(co),
                      initial_force=False)
    jcfg = pq.SEQMConfig(method="AM1", scf=JSCFConfig(**scf))
    jmd = JXLBOMD(e["jc"], e["jt"], jcfg, JMDConfig(timestep=1.0), k=5)
    js = jax_xl_init(jmd, sp, co, e["jout"])
    assert_xl_states_match(s, js)
    jsp = jnp.asarray(sp)
    jstep = jax.jit(lambda s: jmd.step(jsp, s))
    for _ in range(5):
        js, jobs = jstep(js)
        s, obs = md.step(sp, s)
    # f64: the same integrator and electronic propagation, eigh densities
    assert_xl_states_match(s, js)
    for a, b in ((obs.Epot, jobs.Epot), (obs.charges, jobs.charges)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-8)


def test_f32_plain_jacobi_tracks_f64():
    sp, co = make_batch(6, 8, jitter=0.02, seed=1)
    K = pt.packed_heavy_count(sp)
    runs = {}
    for dtype in (torch.float64, torch.float32):
        const, tables, cfg = pt.build(
            "AM1", dtype=dtype, device="cpu", eig=True,
            scf=SCFConfig(eps=1.0e-5 if dtype == torch.float32 else 1.0e-10,
                          converger=(2,), pack_heavy=K))
        f, out = pt.force(const, tables, cfg, sp,
                          torch.tensor(co.astype(np.float32), dtype=dtype))
        assert not out.notconverged.any()
        runs[dtype] = (f, out)
    (f32, o32), (f64, o64) = runs[torch.float32], runs[torch.float64]
    # the f32 bounds of chip_smoke.py (PERF.md): Hf at the f32 storage
    # floor, forces 1e-3 eV/A, orbital energies 2e-3 eV
    np.testing.assert_allclose(_np(o32.Hf), _np(o64.Hf), rtol=0, atol=1.5e-4)
    np.testing.assert_allclose(_np(f32), _np(f64), rtol=0, atol=1e-3)
    np.testing.assert_allclose(_np(o32.e), _np(o64.e), rtol=0, atol=2e-3)
