"""PyTorch port, the fused two-electron apply K3 on the CPU: its plain
version against the JAX package's ``_w_apply`` (forward and VJP, f64) and
against the TPU kernel ``tools/wapply_pallas.py`` in interpret mode (f32);
the CUDA kernels' constexpr table of T's nonzeros (parsed from
``csrc/wapply.cu``) against the package's expansion tensor, per perm; the
kernels' arithmetic (that table unrolled in its order, and the backward
formulas) emulated in plain torch against autograd of the plain version;
``WApply`` with that emulation swapped in, through gradcheck; the wrapper's
dispatch and checks; and the frame structure the kernel assumes."""
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu_torch as pt
from pyseqm_tpu.ops import tetci as jtetci
from pyseqm_tpu_torch.ops import tetci as ttetci
from pyseqm_tpu_torch.ops import wapply_kernel as wk
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.utils.molecules import make_batch

torch.set_num_threads(1)
PERMS = [(1, 2, 3, 4), (3, 4, 1, 2), (1, 3, 2, 4)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


def _case(C, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    x = rng.randn(C, 3)
    U = _np(ttetci.frame_matrix(torch.tensor(x / np.linalg.norm(
        x, axis=-1, keepdims=True))))
    return [a.astype(dtype) for a in (5.0 * rng.randn(C, 22), U,
                                      rng.randn(C, 4, 4), rng.randn(C, 4, 4))]


def _torch_grads(fn, ri, U, X, Yb, perm):
    leaves = [torch.tensor(a, requires_grad=True) for a in (ri, U, X)]
    y = fn(*leaves, perm)
    return [y] + list(torch.autograd.grad(y, leaves, torch.tensor(Yb)))


@pytest.fixture(scope="module")
def jax_refs():
    """In one jitted program: JAX _w_apply and its VJP for every perm
    (f64), and the TPU kernel tools/wapply_pallas.py in interpret mode for
    every perm (f32; loaded by path, tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "wapply_pallas", os.path.join(REPO, "tools", "wapply_pallas.py"))
    pallas = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pallas)
    f64 = _case(40, 1)
    # 300 cells: not a multiple of the TPU kernel's 128-lane rows
    f32 = _case(300, 2, np.float32)[:3]

    def ref(f64, f32):
        ri, U, X, yb = f64
        vjps = {}
        for perm in PERMS:
            y, vjp = jax.vjp(lambda *o: jtetci._w_apply(
                jtetci.WPack(ri=o[0], U=o[1]), o[2], perm), ri, U, X)
            vjps[perm] = (y,) + vjp(yb)
        return vjps, {perm: pallas.w_apply_fused(*f32, perm, True)
                      for perm in PERMS}
    vjps, fused = jax.jit(ref)(*jax.tree.map(jnp.asarray, (f64, f32)))
    return dict(f64=f64, f32=f32, fused=fused,
                vjps={k: [np.asarray(t) for t in v] for k, v in vjps.items()})


@pytest.mark.parametrize("perm", PERMS)
def test_reference_matches_jax_w_apply(jax_refs, perm):
    ri, U, X, Yb = jax_refs["f64"]
    want = list(jax_refs["vjps"][perm])
    got = _torch_grads(wk.w_apply_reference, ri, U, X, Yb, perm)
    # f64, the same contraction (matrix products here, unrolled there):
    # rounding only.  JAX's U gradient, like the kernel's, lives on the
    # 3x3 block; the plain version's row 0 / column 0 entries fall on
    # frame_matrix's constants
    got[2] = got[2][..., 1:, 1:]
    want[2] = want[2][..., 1:, 1:]
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), b, rtol=0,
                                   atol=1e-12 * np.abs(b).max())


def test_reference_matches_pallas_interpret(jax_refs):
    """The plain version against the TPU kernel's forward, each perm.  Its
    backward kernel is held to JAX's VJP of _w_apply by its own check(),
    and the plain version's VJP to that same VJP above."""
    for perm in PERMS:
        y = wk.w_apply_reference(*map(torch.tensor, jax_refs["f32"]), perm)
        b = np.asarray(jax_refs["fused"][perm])
        # f32: the bound of the TPU kernel's own check (3e-6 of the
        # largest value)
        assert np.abs(_np(y) - b).max() < 3.0e-6 * np.abs(b).max(), perm


def _frame_is_structured(U):
    """Whether every frame has row 0 = e_0 and zeros in column 0 of rows
    1-3, as frame_matrix builds it and as the kernel assumes."""
    one = U[..., 0, 0] == 1.0
    zero = (U[..., 0, 1:] == 0.0).all(dim=-1) & (U[..., 1:, 0] == 0.0).all(
        dim=-1)
    return bool((one & zero).all())


def _structural(U):
    """U rebuilt from its 3x3 block (row 0 = e_0, column 0 of rows 1-3 =
    0): the only part of U the kernel reads."""
    Us = torch.zeros_like(U)
    Us[..., 0, 0] = 1.0
    Us[..., 1:, 1:] = U[..., 1:, 1:]
    return Us


def _kernel_table():
    """T's nonzeros (r, k, l, m, n) as the constexpr table kT of
    csrc/wapply.cu lists them, in its order (the kernels' unrolled
    order)."""
    path = os.path.join(os.path.dirname(os.path.dirname(wk.__file__)),
                        "csrc", "wapply.cu")
    with open(path) as fh:
        src = fh.read()
    body = re.search(r"constexpr int kT\[72\]\[5\] = \{(.*?)\n\s*\};", src,
                     re.S).group(1)
    rows = re.findall(r"\{\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+)\s*\}",
                      body)
    return np.array(rows, dtype=np.int64).reshape(-1, 5)


def _kernel_entries(perm):
    """(r, f, c) of T_perm's entries in the kernels' order, as the template
    Perm<P0, P1, P2, P3> of csrc/wapply.cu computes them: f = 4 idx[P0] +
    idx[P1], c = 4 idx[P2] + idx[P3] with idx[1..4] = (k, l, m, n)."""
    t = _kernel_table()
    p0, p1, p2, p3 = perm
    return list(zip(t[:, 0], 4 * t[:, p0] + t[:, p1], 4 * t[:, p2] + t[:, p3]))


def test_kernel_table_is_the_nonzeros_of_t():
    t = _kernel_table()
    T = ttetci._ri_expansion_table()
    assert t.shape == (72, 5) and len({tuple(e) for e in t}) == 72
    # T is 0/1 with exactly these 72 ones
    assert set(np.unique(T)) == {0.0, 1.0} and T.sum() == 72
    assert (T[tuple(t.T)] == 1.0).all()


@pytest.mark.parametrize("perm", PERMS)
def test_kernel_table_per_perm_gives_the_entries_of_t_perm(perm):
    """The compile-time perm applied to the table gives the (r, f, c)
    index sets of T_perm = T.transpose((0,) + perm), f = 4 free1 + free2,
    c = 4 con1 + con2 (what the kernels' run-time table held before)."""
    r, a, b, c, d = np.nonzero(wk._expansion(perm))
    want = set(zip(r, 4 * a + b, 4 * c + d))
    got = _kernel_entries(perm)
    assert len(got) == len(want) == 72 and set(got) == want


def _kernel_fwd(ri, U, X, perm):
    """The CUDA forward's arithmetic: rotate in, the 72 multiply-adds
    y[f] += ri[r] Xl[c] in the kernels' unrolled order, rotate out."""
    Us = _structural(U)
    Xl = (Us.transpose(1, 2) @ X @ Us).reshape(-1, 16)
    y = torch.zeros_like(Xl)
    for r, f, c in _kernel_entries(perm):
        y[:, f] += ri[:, r] * Xl[:, c]
    return Us @ y.reshape(-1, 4, 4) @ Us.transpose(1, 2)


def _kernel_bwd(ri, U, X, Yb, perm, need):
    """The CUDA backward's arithmetic in the kernels' order: dri, B and C
    from one unrolled pass over the table each, dX = U C U^T,
    dU = Yb U B^T + Yb^T U B + X U C^T + X^T U C on the 3x3 block, zeros
    elsewhere."""
    ent = _kernel_entries(perm)
    Us = _structural(U)
    Ut = Us.transpose(1, 2)
    Xl = (Ut @ X @ Us).reshape(-1, 16)
    El = (Ut @ Yb @ Us).reshape(-1, 16)
    dri = torch.zeros_like(ri)
    for r, f, c in ent:
        dri[:, r] += El[:, f] * Xl[:, c]
    B, Cm = torch.zeros_like(Xl), torch.zeros_like(Xl)
    for r, f, c in ent:
        B[:, f] += ri[:, r] * Xl[:, c]
    for r, f, c in ent:
        Cm[:, c] += ri[:, r] * El[:, f]
    B, Cm = B.reshape(-1, 4, 4), Cm.reshape(-1, 4, 4)
    du = (Yb @ Us @ B.transpose(1, 2) + Yb.transpose(1, 2) @ Us @ B
          + X @ Us @ Cm.transpose(1, 2) + X.transpose(1, 2) @ Us @ Cm)
    dU = torch.zeros_like(U)
    dU[..., 1:, 1:] = du[..., 1:, 1:]
    out = (dri, dU, Us @ Cm @ Ut)
    return tuple(o if n else None for o, n in zip(out, need))


@pytest.mark.parametrize("perm", PERMS)
def test_kernel_arithmetic_matches_autograd_of_plain(perm):
    assert len(_kernel_entries(perm)) == 72
    ri, U, X, Yb = [torch.tensor(a) for a in _case(50, 3)]
    ref = _torch_grads(wk.w_apply_reference, *[_np(t) for t in
                                               (ri, U, X, Yb)], perm)
    y = _kernel_fwd(ri, U, X, perm)
    dri, dU, dX = _kernel_bwd(ri, U, X, Yb, perm, (True, True, True))
    # f64, the same function: rounding only
    for a, b in ((y, ref[0]), (dri, ref[1]), (dU[..., 1:, 1:],
                                               ref[2][..., 1:, 1:]),
                 (dX, ref[3])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=1e-12 * _np(b).__abs__().max())
    assert not _np(dU)[..., 0, :].any() and not _np(dU)[..., 1:, 0].any()


def test_wapply_function_gradcheck(monkeypatch):
    """WApply (the autograd.Function of the card) with the kernel launches
    swapped for their plain-torch arithmetic: gradcheck at f64 in ri, the
    3x3 frame block and X, for each perm."""
    monkeypatch.setattr(wk, "_launch_fwd", _kernel_fwd)
    monkeypatch.setattr(wk, "_launch_bwd", _kernel_bwd)
    ri, U, X, _ = [torch.tensor(a) for a in _case(4, 4)]
    u3 = U[:, 1:, 1:].clone()
    for perm in PERMS:
        def fn(a, b, c):
            Ub = torch.zeros(b.shape[0], 4, 4, dtype=b.dtype)
            Ub = Ub + torch.nn.functional.pad(b, (1, 0, 1, 0))
            Ub = Ub + torch.nn.functional.pad(
                torch.ones(b.shape[0], 1, 1, dtype=b.dtype), (0, 3, 0, 3))
            return wk.WApply.apply(a, Ub, c, perm)
        args = [t.clone().requires_grad_(True) for t in (ri, u3, X)]
        assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-7)
        # only the cotangents asked for are computed
        args[2].requires_grad_(False)
        (g,) = torch.autograd.grad(fn(*args).sum(), args[0])
        assert g.shape == ri.shape


def test_wrapper_checks_and_dispatch():
    ri, U, X, _ = [torch.tensor(a) for a in _case(6, 5)]
    f0, b0 = wk.launches_fwd, wk.launches_bwd
    # CPU tensors run the plain version, broadcasting like it
    y = wk.w_apply(ri, U, X[:1], (1, 2, 3, 4))
    np.testing.assert_array_equal(
        _np(y), _np(wk.w_apply_reference(ri, U, X[:1], (1, 2, 3, 4))))
    assert (wk.launches_fwd, wk.launches_bwd) == (f0, b0)
    with pytest.raises(TypeError):
        wk.w_apply(ri.float(), U, X, (1, 2, 3, 4))
    with pytest.raises(ValueError):
        wk.w_apply(ri[:, :21], U, X, (1, 2, 3, 4))
    with pytest.raises(ValueError):
        wk.w_apply(ri.to("meta"), U.to("meta"), X.to("meta"), (1, 2, 3, 4))


def test_kernel_launch_rejects_other_perms():
    """The kernels are instantiated for the package's three perms: another
    perm raises before anything is launched (or built), while the plain
    version takes any perm."""
    ri, U, X, Yb = [torch.tensor(a) for a in _case(3, 6)]
    f0, b0 = wk.launches_fwd, wk.launches_bwd
    for perm in ((1, 2, 4, 3), (2, 1, 3, 4)):
        with pytest.raises(ValueError):
            wk._launch_fwd(ri, U, X, perm)
        with pytest.raises(ValueError):
            wk._launch_bwd(ri, U, X, Yb, perm, (True, True, True))
        y = wk.w_apply(ri, U, X, perm)
        np.testing.assert_array_equal(
            _np(y), _np(wk.w_apply_reference(ri, U, X, perm)))
    assert (wk.launches_fwd, wk.launches_bwd) == (f0, b0)
    assert sorted(wk.PERM_IDS) == sorted(PERMS)


def test_frames_reaching_the_apply_are_structured(monkeypatch):
    """The kernel reads only U[1:4, 1:4]: every frame that reaches the
    apply in an energy run (flat pairs, and the packed layout's XX
    sub-grid) has row 0 = e_0 and zeros below U[0, 0]."""
    frames = []

    def tapped(ri, U, X, perm):
        frames.append(U)
        return wk.w_apply(ri, U, X, perm)
    monkeypatch.setattr(ttetci, "w_apply", tapped)
    sp, co = make_batch(3, 8, jitter=0.05, seed=8)
    for scf in (SCFConfig(eps=1e-6, converger=(2,)),
                SCFConfig(eps=1e-6, converger=(2,),
                          pack_heavy=pt.packed_heavy_count(sp))):
        const, tables, cfg = pt.build("AM1", dtype=torch.float64,
                                      device="cpu", scf=scf)
        pt.energy(const, tables, cfg, sp, torch.tensor(co))
    assert len(frames) > 4
    assert all(_frame_is_structured(U) for U in frames)
    U = ttetci.frame_matrix(torch.randn(7, 3, dtype=torch.float64))
    U[3, 1, 0] = 1e-3
    assert not _frame_is_structured(U)
