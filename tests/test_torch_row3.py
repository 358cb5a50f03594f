"""PyTorch port, row 3 (Na..Cl, ``SEQMConfig.row3``) on the CPU: the
generated-coefficient overlap against the JAX package's at f64 and f32
(double-float chain), its coefficients against the hand-coded classes, the
double-float chain's second derivative against the plain chain's, dd/qq
for S and Cl, the port's energies, forces and orbital energies against the
JAX package's f64 fixtures (tests/golden/row3_fixtures.npz) for MNDO, AM1
and PM3, every pair layout against the flat one, the row-3 gate, and the
published PM3 H2S pin (Stewart 1989) reached by the port's warm L-BFGS."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu_torch as pt
from pyseqm_tpu.ops import multipole as jmultipole
from pyseqm_tpu.ops import overlap_general as jog
from pyseqm_tpu.system import validate as jvalidate
from pyseqm_tpu_torch.drivers.opt import geometry_optimize_lbfgs
from pyseqm_tpu_torch.ops import multipole, overlap
from pyseqm_tpu_torch.ops import overlap_general as og
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.system import validate

torch.set_num_threads(1)
CPU = "cpu"
KCAL = 23.060907
CLASSES = [(3, 1), (3, 2), (3, 3)]
SCF_TIGHT = dict(eps=1.0e-10, converger=(2,))


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _cases(N=256, seed=3):
    """rij (bohr) and four exponents; the last quarter has zeta_i ~ zeta_j
    so |R (za - zb) / 2| <= 0.5 and B_k runs its Taylor branch."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.8, 8.0, N)
    z = [rng.uniform(0.8, 3.5, N) for _ in range(4)]
    q = N // 4
    for a, b in ((0, 2), (1, 3), (1, 2), (0, 3)):
        z[b][-q:] = z[a][-q:] + rng.uniform(-0.05, 0.05, q)
    return [r] + z


def _h2s(bond=1.2903, angle_deg=93.51):
    ang = np.deg2rad(angle_deg)
    sp = np.array([[16, 1, 1, 0]])
    co = np.zeros((1, 4, 3))
    co[0, 1] = [bond, 0.0, 0.0]
    co[0, 2] = [bond * np.cos(ang), bond * np.sin(ang), 0.0]
    return sp, co


def _build(method, dtype=torch.float64, **kw):
    kw.setdefault("scf", SCFConfig(**SCF_TIGHT))
    return pt.build(method, dtype=dtype, device=CPU, row3=True, **kw)


@pytest.mark.parametrize("na,nb", CLASSES)
def test_general_overlap_matches_jax(na, nb):
    """Plain chain at f64 and the double-float chain at f32 against the
    JAX package's, on both B_k branches; the f32 double-float chain also
    against the f64 values (~2e-7), where the plain f32 chain loses up to
    ~5e-3 to the binomial cancellation."""
    args = _cases()
    small = np.abs(0.5 * args[0] * (args[1] - args[3])) <= 0.5
    assert small.sum() > 20 and (~small).sum() > 20
    ref = [np.asarray(g) for g in jog.s_combinations_general(
        na, nb, *[jnp.asarray(a) for a in args])]
    got = og.s_combinations_general(na, nb, *[torch.tensor(a) for a in args])
    scale = max(np.abs(r).max() for r in ref)
    # the forward B_k recursion amplifies a 1-ulp difference between
    # XLA's and torch's exp by up to ~1e4 at high k (6e-12 of B_8 here)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=2e-11 * scale)

    a32 = [a.astype(np.float32) for a in args]
    ref32 = [np.asarray(g) for g in jog.s_combinations_general_tf(
        na, nb, *[jnp.asarray(a) for a in a32])]
    t32 = [torch.tensor(a) for a in a32]
    tf = og.s_combinations_general_tf(na, nb, *t32)
    plain = og.s_combinations_general(na, nb, *t32)
    exact = [np.asarray(g) for g in jog.s_combinations_general(
        na, nb, *[jnp.asarray(a.astype(np.float64)) for a in a32])]
    for r, g, p, e in zip(ref32, tf, plain, exact):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=2e-7 * scale)
        np.testing.assert_allclose(_np(g), e, rtol=0, atol=5e-7 * scale)
        np.testing.assert_allclose(_np(p), e, rtol=0, atol=1e-2 * scale)


def test_generated_coefficients_match_hand_coded():
    """The generated coefficients reproduce the hand-coded jcall 2/3/4
    combinations on the A/B exact branch (tests/test_integrals.py,
    test_general_overlap_matches_hand_coded)."""
    rng = np.random.default_rng(7)
    N = 512
    rij, zs1, zp1, zs2, zp2 = (torch.tensor(rng.uniform(lo, hi, N))
                               for lo, hi in ((0.8, 8.0),) + 4 * ((0.8, 3.5),))
    m = torch.ones(N, dtype=torch.bool)
    zpairs = [(zs1, zs2), (zp1, zs2), (zs1, zp2), (zp1, zp2), (zp1, zp2)]
    for (na, nb), js in (((1, 1), (m, ~m, ~m)), ((2, 1), (~m, m, ~m)),
                         ((2, 2), (~m, ~m, m))):
        hand = overlap._s_combinations(rij, zs1, zp1, zs2, zp2, *js, False)
        gen = og.s_combinations_general(na, nb, rij, zs1, zp1, zs2, zp2)
        for ci, (h, g) in enumerate(zip(hand, gen)):
            if h.abs().max() == 0.0:
                continue
            z1, z2 = zpairs[ci]
            exact = (0.5 * rij * (z1 - z2)).abs() > 0.6
            assert int(exact.sum()) > 50
            assert float((h - g).abs()[exact].max()) < 1e-13, (na, nb, ci)


@pytest.mark.parametrize("na,nb", CLASSES)
def test_doublefloat_second_derivative(na, nb):
    """On float32 the double-float chain's gradient is the plain chain's,
    and under create_graph so is its second derivative (the JAX
    custom_jvp's tangent under forward-over-reverse)."""
    args = [a.astype(np.float32) for a in _cases(N=64, seed=5)]
    w = torch.tensor(np.random.default_rng(0).standard_normal((5, 64)),
                     dtype=torch.float32)

    def hess_rows(fn):
        ins = [torch.tensor(a, requires_grad=True) for a in args]
        L = sum((wk * s).sum() for wk, s in zip(w, fn(na, nb, *ins)))
        g = torch.autograd.grad(L, ins, create_graph=True)
        rows = [torch.autograd.grad(gi.sum(), ins, retain_graph=True,
                                    allow_unused=True) for gi in g]
        return g, rows

    g_tf, h_tf = hess_rows(og.s_combinations_general_tf)
    g_pl, h_pl = hess_rows(og.s_combinations_general)
    for a, b in zip(g_tf, g_pl):
        np.testing.assert_array_equal(_np(a), _np(b))
    n = 0
    for ra, rb in zip(h_tf, h_pl):
        for a, b in zip(ra, rb):
            if a is None or b is None:
                assert a is None and b is None
                continue
            np.testing.assert_array_equal(_np(a), _np(b))
            n += int(torch.count_nonzero(a))
    assert n > 0


def test_row3_diatom_overlap_cells_and_precision():
    """diatom_overlap with row3: the row-3 classes' cells carry the
    generated values, the others the hand-coded ones, with host cell lists
    or without; on float32 with precise the double-float primal."""
    rng = np.random.default_rng(11)
    N = 96
    qi = np.tile([3, 3, 3, 2], N // 4)
    qj = np.tile([1, 2, 3, 1], N // 4)
    r = rng.uniform(1.5, 6.0, N)
    zi, zj = rng.uniform(1.0, 2.5, (N, 2)), rng.uniform(1.0, 2.5, (N, 2))
    x = rng.standard_normal((N, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt)  # noqa: E731
    ql = lambda a: torch.tensor(a, dtype=torch.long)           # noqa: E731
    ref = overlap.diatom_overlap(ql(qi), ql(qj), t(x), t(r), t(zi), t(zj),
                                 row3=True)
    host = overlap.diatom_overlap(ql(qi), ql(qj), t(x), t(r), t(zi), t(zj),
                                  row3=True, qn_host=(qi, qj))
    np.testing.assert_array_equal(_np(ref), _np(host))
    for (na, nb) in CLASSES:
        m = (qi == na) & (qj == nb)
        S = og.s_combinations_general(na, nb, t(r[m]), t(zi[m, 0]),
                                      t(zi[m, 1]), t(zj[m, 0]), t(zj[m, 1]))
        np.testing.assert_array_equal(_np(ref)[m, 0, 0], _np(S[0]))
    row12 = qi == 2
    plain = overlap.diatom_overlap(ql(qi), ql(qj), t(x), t(r), t(zi), t(zj))
    np.testing.assert_array_equal(_np(ref)[row12], _np(plain)[row12])
    assert np.abs(_np(plain)[~row12]).max() == 0.0

    f32 = [t(a, torch.float32) for a in (x, r, zi, zj)]
    tf = overlap.diatom_overlap(ql(qi), ql(qj), *f32, precise=True,
                                row3=True)
    assert float((tf.double() - ref).abs().max()) < 5e-7


def test_dd_qq_row3_matches_jax():
    """dd/qq of S and Cl (qn = 3) against the JAX package, each method's
    exponents."""
    for method in ("MNDO", "AM1", "PM3"):
        tables = pt.load_element_tables(method, device=CPU,
                                        dtype=torch.float64)
        zs = tables["zeta_s"][[16, 17]]
        zp = tables["zeta_p"][[16, 17]]
        qn = torch.full((2,), 3.0, dtype=torch.float64)
        dd, qq = multipole.dd_qq(qn, zs, zp)
        jd, jq = jmultipole.dd_qq(jnp.asarray(_np(qn)), jnp.asarray(_np(zs)),
                                  jnp.asarray(_np(zp)))
        np.testing.assert_allclose(_np(dd), np.asarray(jd), rtol=1e-14)
        np.testing.assert_allclose(_np(qq), np.asarray(jq), rtol=1e-14)


@pytest.mark.parametrize("method", ["MNDO", "AM1", "PM3"])
def test_row3_fixture_parity(golden, method):
    """H2S/PH3/SiH4/HCl/CH3Cl/AlH3 energies, forces and orbital energies
    against the JAX package's f64 fixtures (held to the JAX package by
    tests/test_row3.py::test_row3_fixture_parity)."""
    g = golden("row3_fixtures")
    const, tables, cfg = _build(method, eig=True)
    f, out = pt.force(const, tables, cfg, g[f"{method}_species"],
                      torch.tensor(g[f"{method}_coords"]))
    assert not bool(out.notconverged.any())
    np.testing.assert_allclose(_np(out.Hf), g[f"{method}_Hf"], atol=1e-8)
    np.testing.assert_allclose(_np(f), g[f"{method}_force"], atol=1e-7)
    np.testing.assert_allclose(_np(out.e), g[f"{method}_e_orb"], atol=1e-7)


def _mixed_batch():
    """H2S, CH3SH, H2O (row-2 control), CH4, SiH3Cl: the (3,1), (3,2) and
    (3,3) classes (tests/test_row3.py::test_row3_packed_layout_parity
    plus a molecule with two row-3 atoms)."""
    sp = np.zeros((5, 8), np.int64)
    co = np.zeros((5, 8, 3))
    sp[0, :3] = [16, 1, 1]
    co[0, 1] = [1.34, 0, 0]
    co[0, 2] = [-0.1, 1.33, 0]
    sp[1, :6] = [16, 6, 1, 1, 1, 1]
    co[1, 1] = [1.81, 0, 0]
    co[1, 2] = [-0.45, 1.24, 0]
    co[1, 3] = [2.16, 0.51, 0.89]
    co[1, 4] = [2.16, 0.51, -0.89]
    co[1, 5] = [2.16, -1.03, 0.0]
    sp[2, :3] = [8, 1, 1]
    co[2, 1] = [0.0, 0.76, -0.59]
    co[2, 2] = [0.0, -0.76, -0.59]
    sp[3, :5] = [6, 1, 1, 1, 1]
    d = 1.09 / np.sqrt(3.0)
    co[3, 1:5] = [[d, d, d], [-d, -d, d], [-d, d, -d], [d, -d, -d]]
    sp[4, :5] = [17, 14, 1, 1, 1]
    co[4, 1] = [2.05, 0.0, 0.0]
    for k, phi in enumerate((0.0, 2.1, 4.2)):
        co[4, 2 + k] = [2.55, 1.39 * np.cos(phi), 1.39 * np.sin(phi)]
    return sp, co


def test_row3_layouts_match_flat():
    """Every integral layout with row 3 (the class-segmented dense grid
    with the packed SCF, the class-segmented flat list, the ordered dense
    grid) against the flat pair list at f64, with host cell lists and
    with the species given as a tensor (cell lists copied from the
    device)."""
    sp, co = _mixed_batch()
    coords = torch.tensor(co)
    K = pt.packed_heavy_count(sp)
    const, tables, cfg = _build("PM3", pack_pairs=False,
                                dense_pair_grid=False)
    f0, o0 = pt.force(const, tables, cfg, sp, coords)
    assert not bool(o0.notconverged.any())
    packed = SCFConfig(**SCF_TIGHT, pack_heavy=K)
    for kw, layout in ((dict(scf=packed), "WPackGridSplit"),
                       (dict(scf=packed, dense_pair_grid=False),
                        "WPackSplit"),
                       (dict(dense_pair_grid=True), "WPackGrid")):
        _, _, c = _build("PM3", **kw)
        for species in (sp, torch.tensor(sp)):
            f, o = pt.force(const, tables, c, species, coords)
            assert type(o.w).__name__ == layout
            assert not bool(o.notconverged.any())
            np.testing.assert_allclose(_np(o.Hf), _np(o0.Hf), atol=1e-9)
            np.testing.assert_allclose(_np(f), _np(f0), atol=1e-8)


def test_row3_gate():
    """Row 3 is refused without the flag, by validate (as the JAX
    package's) and by the entry points; with it, argon still is."""
    sp = np.array([[16, 1, 1, 0]])
    for fn in (validate, jvalidate):
        with pytest.raises(ValueError, match="row3"):
            fn(sp)
        fn(sp, allow_row3=True)
        with pytest.raises(ValueError, match="argon"):
            fn(np.array([[18, 0]]), allow_row3=True)
    const, tables, cfg = pt.build("PM3", dtype=torch.float64, device=CPU)
    _, co = _h2s()
    with pytest.raises(ValueError, match="row3"):
        pt.energy(const, tables, cfg, sp, torch.tensor(co))


def test_h2s_published_pm3_pin():
    """Stewart's published PM3 H2S: Hf -0.913 kcal/mol at r(SH) 1.2903 A
    and 93.51 deg, a stationary point; the port's warm L-BFGS finds that
    geometry from a distorted start (tests/test_row3.py, examples/row3.py)."""
    const, tables, cfg = _build("PM3")
    sp, co = _h2s()
    f, out = pt.force(const, tables, cfg, sp, torch.tensor(co))
    assert not bool(out.notconverged[0])
    assert abs(float(out.Hf[0]) * KCAL - (-0.913)) < 0.05
    assert float(f.abs().max()) < 5.0e-3

    sp, co = _h2s(bond=1.42, angle_deg=99.0)
    x, ferr, nit = geometry_optimize_lbfgs(
        const, tables, cfg, sp, torch.tensor(co), force_tol=2.0e-4,
        max_evl=120, chunk=10)
    assert float(ferr) <= 2.0e-4
    x = _np(x)[0]
    r1, r2 = (np.linalg.norm(x[k] - x[0]) for k in (1, 2))
    ang = np.rad2deg(np.arccos(np.dot(x[1] - x[0], x[2] - x[0]) / (r1 * r2)))
    assert abs(r1 - 1.2903) < 2e-3 and abs(r2 - 1.2903) < 2e-3, (r1, r2)
    assert abs(ang - 93.51) < 0.2, ang
