"""PyTorch port on an NVIDIA GPU: the CUDA SP2, Jacobi eigh, fused
two-electron apply and double-float overlap kernels against their plain
versions (and the exact answers where there are any), K3's second
derivative against double backward through its plain version, the
overlap kernel on real XL steps, short float32 XL-BOMD runs (SP2 and
eigh densities) through the kernels, the default flat layout's and the
class-segmented flat pair list's energy and force, the SCF adjoint's
parameter and coordinate gradients, a water Hessian through the
unrolled SCF, the Langevin and Nose-Hoover drivers, steepest descent and
the warm L-BFGS, row 3 in every layout, the trained HIP-NN model and the
force it drives, the Kbeta and g_ss_nuc hooks, against the CPU runs of
the same inputs; and checkpoint and resume on the card, bit for bit.

These tests need the card and skip without one.  They import neither JAX
nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import re

import numpy as np
import pytest
import torch

import pyseqm_tpu_torch as pt
from pyseqm_tpu_torch.drivers.md import MDConfig
from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
from pyseqm_tpu_torch.ops import (eigh_kernel, overlap_kernel, sp2_kernel,
                                  wapply_kernel)
from pyseqm_tpu_torch.ops import overlap as tov
from pyseqm_tpu_torch.ops.tetci import frame_matrix
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.utils.molecules import make_alkane, make_batch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    pt.disable_tf32()
    return torch.device("cuda")


def _gap_case(B, n, nocc, seed, device):
    """Pre-scaled SP2 inputs from symmetric matrices with a clean gap (the
    normal draws from a numpy seed, the algebra in float64 on device) and
    the exact density."""
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((B, n, n), dtype=np.float32))
    Q, _ = torch.linalg.qr(X.to(device=device, dtype=torch.float64))
    u = torch.from_numpy(rng.random((B, n))).to(device)
    evals = torch.where(torch.arange(n, device=device) < nocc,
                        -10.0 + 2.0 * u, 2.0 + 6.0 * u)
    F = (Q * evals[:, None, :]) @ Q.transpose(1, 2)
    F = 0.5 * (F + F.transpose(1, 2))
    occ = (torch.arange(n, device=device) < nocc).double()
    P = 2.0 * (Q * occ) @ Q.transpose(1, 2)
    aii = torch.diagonal(F, dim1=-2, dim2=-1)
    ri = F.abs().sum(-1) - aii.abs()
    h1, hN = (aii - ri).amin(-1), (aii + ri).amax(-1)
    eye = torch.eye(n, dtype=torch.float64, device=device)
    a0 = (eye * hN[:, None, None] - F) / (hN - h1)[:, None, None]
    return (a0.float(), torch.full((B,), float(nocc), device=device), P)


# n <= 16: the half-warp kernel (8, 12 with padded lanes); 17-32: the warp
# kernel; 128: the block kernel.  B = 7 leaves a block part empty
@pytest.mark.parametrize("B", [7, 10240])
@pytest.mark.parametrize("n,nocc", [(8, 3), (12, 4), (16, 5), (24, 8),
                                    (32, 11), (128, 40)])
def test_kernel_matches_plain_and_exact(cuda, B, n, nocc):
    a, o, P_exact = _gap_case(B, n, nocc, 7, cuda)
    before = sp2_kernel.launches
    P, iters = sp2_kernel.sp2_purify(a, o, 1.0e-5, return_iters=True)
    torch.cuda.synchronize()
    assert sp2_kernel.launches == before + 1
    Pr, iters_r = sp2_kernel.sp2_purify_reference(a, o, 1.0e-5,
                                                  return_iters=True)
    # f32 SP2: the bounds of the JAX kernel's parity tests (5e-5); the
    # kernel and its plain version sum in different orders
    assert (P - Pr).abs().max().item() < 5.0e-5
    Pd = P.double()
    assert (Pd - P_exact).abs().max().item() < 5.0e-5
    half = Pd / 2.0
    assert (half @ half - half).abs().max().item() < 5.0e-5
    trace = torch.diagonal(Pd, dim1=-2, dim2=-1).sum(-1)
    assert (trace - 2.0 * o.double()).abs().max().item() < 1.0e-4
    assert ((iters > 0) & (iters <= sp2_kernel.MAX_ITER)).all()


def _sym_case(B, n, kind):
    rng = np.random.RandomState(n)
    X = rng.randn(B, n, n)
    # dense random as in test_kernels.py (at n = 128 its Gershgorin shift,
    # ~30 max|A|, puts f32 eigenvalues close to the 5e-4 max|A| bound), the
    # diagonally dominant packed-F class of test_torch_sp2, or "mixed":
    # dense with every other matrix cut to its diagonal (one sweep), so
    # molecules that share a warp leave at different sweeps
    X = 6.0 * X - 40.0 * np.eye(n) if kind == "fock" else 5.0 * X
    A = 0.5 * (X + np.swapaxes(X, 1, 2))
    if kind == "mixed":
        A[1::2] *= np.eye(n)
    return A.astype(np.float32)


# the warp kernel at n = 2-32 (n/32 of a warp per molecule; 24 padded to
# 32), the block kernel at 128; B = 7 leaves the last warp part empty
@pytest.mark.parametrize("B,n,kind", [(10240, 16, "dense"), (7, 32, "dense"),
                                      (7, 128, "dense"), (7, 128, "fock"),
                                      (7, 24, "dense"), (7, 2, "dense"),
                                      (7, 4, "dense"), (7, 8, "dense"),
                                      (7, 8, "mixed"), (7, 16, "mixed"),
                                      (7, 32, "mixed")])
def test_eigh_kernel_matches_plain_and_exact(cuda, B, n, kind):
    A = _sym_case(B, n, kind)
    a = torch.from_numpy(A).to(cuda)
    before = eigh_kernel.launches
    e, v, resid, sweeps = eigh_kernel.eigh_jacobi(a, with_resid=True,
                                                  return_sweeps=True)
    torch.cuda.synchronize()
    assert eigh_kernel.launches == before + 1
    er, vr, _, sr = eigh_kernel.eigh_jacobi_reference(
        a, with_resid=True, return_sweeps=True)
    An = A.astype(np.float64)
    nrm = np.abs(An).max()
    en, vn = e.double().cpu().numpy(), v.double().cpu().numpy()
    # the plain version repeats the kernel's operations (FP32 FMA column
    # sums, explicitly rounded rotations): agreement to rounding
    assert (e - er).abs().max().item() <= 1.0e-5 * nrm
    occ = n // 2
    pk = np.einsum('bik,bjk->bij', vn[..., :occ], vn[..., :occ])
    vrn = vr.double().cpu().numpy()
    pr = np.einsum('bik,bjk->bij', vrn[..., :occ], vrn[..., :occ])
    assert np.abs(pk - pr).max() < 5.0e-5
    assert torch.equal(sweeps, sr)
    if kind == "mixed":
        assert (sweeps[1::2] == 1).all() and (sweeps[::2] > 1).all()
    # the bounds of test_kernels.py against exact
    e_ex = np.linalg.eigvalsh(An)
    assert np.abs(en - e_ex).max() <= 5.0e-4 * nrm
    assert np.abs(An @ vn - en[:, None, :] * vn).max() <= 5.0e-4 * nrm
    assert np.abs(np.swapaxes(vn, 1, 2) @ vn - np.eye(n)).max() <= 1.0e-5
    assert (resid <= eigh_kernel.OFF_TOL).all()


def _graph_nodes(fn, path):
    """The device work of one fn() call (after a warm-up that builds and
    loads the kernel outside the capture): one text per node of the CUDA
    graph captured around the call (a torch.profiler session can lose a
    ctypes launch's device events; a captured graph cannot)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)   # kept for the dump
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        fn()
    g.debug_dump(str(path))
    g.reset()
    text = path.read_text()
    starts = [m.start() for m in re.finditer(         # node declarations
        r'^"graph_\d+_node_\d+"\s*\[', text, re.M)]
    return [text[i:j] for i, j in zip(starts, starts[1:] + [len(text)])]


@pytest.mark.parametrize("n", [16, 24, 128])
def test_eigh_jacobi_is_one_launch(cuda, n, tmp_path):
    """On CUDA the shift, padding, sweeps, sort and normalisation are one
    kernel launch: the CUDA graph captured around one call holds one node,
    the eigh kernel."""
    a = torch.from_numpy(_sym_case(64, n, "dense")).to(cuda)
    before = eigh_kernel.launches
    nodes = _graph_nodes(lambda: eigh_kernel.eigh_jacobi(a, with_resid=True),
                         tmp_path / "graph.dot")
    assert (len(nodes) == 1 and "KERNEL" in nodes[0]
            and "eigh" in nodes[0]), [nd[:160] for nd in nodes]
    assert eigh_kernel.launches == before + 2       # warm-up and capture
    assert eigh_kernel.launches_by_n[eigh_kernel.next_pow2(n)] >= 1


@pytest.mark.parametrize("use_sp2", [True, False])
def test_xlbomd_f32_on_card_matches_cpu(cuda, use_sp2):
    sp, co = make_batch(12, 8, jitter=0.02, seed=2)
    K = pt.packed_heavy_count(sp)
    scf = SCFConfig(eps=1.0e-5, converger=(2,), use_sp2=use_sp2,
                    sp2_eps=1.0e-4, pack_heavy=K)
    kernel = sp2_kernel if use_sp2 else eigh_kernel
    out = {}
    for dev in ("cpu", cuda):
        const, tables, cfg = pt.build("AM1", dtype=torch.float32, device=dev,
                                      scf=scf)
        md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
        s = md.initialize(sp, co, velocities=np.zeros_like(co),
                          initial_force=False)
        n0 = kernel.launches
        for _ in range(3):
            s, obs = md.step(sp, s)
        out[str(dev)] = (s, obs, kernel.launches - n0)
    (sc, oc, lc), (sg, og, lg) = out["cpu"], out["cuda"]
    assert lc == 0 and lg == 3          # one kernel launch per XL step
    # f32 on two devices: different summation orders; the f32 bounds of
    # test_torch_slice.py's f32-vs-f64 XL test
    np.testing.assert_allclose(og.Epot.cpu().numpy(), oc.Epot.numpy(),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(sg.coordinates.cpu().numpy(),
                               sc.coordinates.numpy(), rtol=0, atol=2e-6)


def _ulps(a, b):
    """Distance in float32 units in the last place (+0 and -0 alike)."""
    def ordered(x):
        i = x.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _overlap_against_chains(mode, ins, bar=3.0e-7):
    """The kernel's five outputs against the double-float chain on the
    card and the float64 chain.  Each cell lies within 1 float32 ulp of
    the double-float chain, or, where that chain's own error passes an
    ulp (an alternating-sign bracket that cancels), within 1 ulp of the
    float64 value and nearer to it than the chain; those cells are rare.
    Zeros in the same cells.  Each cell no farther from float64 than the
    chain, to an ulp (both share the float32 prefactors, whose rounding
    sets the error), and, with ``bar``, every output within ``bar`` of
    float64 (3e-7, the bar of test_torch_integrals'
    test_precise_overlap_f32_values on its inputs; |S| <= 1)."""
    got = overlap_kernel.s_combinations(mode, *ins)
    chain = tov._s_combinations(*ins, True, mode)
    exact = tov._s_combinations(*[t.double() if t.is_floating_point()
                                  else t for t in ins], False, mode)
    for k, (g, c, e) in enumerate(zip(got, chain, exact)):
        assert bool(torch.isfinite(g).all()), (mode, k)
        near = _ulps(g, c) <= 1
        nearer = (((g.double() - e).abs() <= (c.double() - e).abs())
                  & (_ulps(g, e.float()) <= 1))
        assert bool((near | nearer).all()), (mode, k)
        assert int((~near).sum()) <= max(1, g.numel() // 1000), (mode, k)
        assert torch.equal(g == 0, c == 0), (mode, k)
        err, err_c = (g.double() - e).abs(), (c.double() - e).abs()
        ulp = torch.finfo(torch.float32).eps * e.abs()
        assert bool((err <= err_c + ulp).all()), (mode, k)
        if bar is not None:
            assert float(err.max()) <= bar, (mode, k)


@pytest.mark.parametrize("config", ["small-organics", "nonane"])
def test_overlap_kernel_on_a_real_step(cuda, config, monkeypatch):
    """Every overlap segment of a float32 XL-BOMD bootstrap and step on
    the packed class-segmented grid (the benchmark's XL cells: padding
    atoms and the diagonal cells included), through the kernel, one
    launch per segment, against both chains on the same inputs."""
    if config == "small-organics":
        sp, co = make_batch(2048, 8, jitter=0.02, seed=5)
    else:
        s1, c1 = make_alkane(9)
        rng = np.random.default_rng(5)
        sp = np.repeat(s1[None], 128, 0)
        co = c1[None] + 0.02 * rng.standard_normal((128,) + c1.shape)
    scf = SCFConfig(eps=1.0e-5, converger=(2,), use_sp2=True,
                    sp2_eps=1.0e-4, pack_heavy=pt.packed_heavy_count(sp))
    const, tables, cfg = pt.build("AM1", dtype=torch.float32, device=cuda,
                                  scf=scf)
    calls = []
    launch = overlap_kernel.s_combinations

    def tap(mode, *ins):
        calls.append((mode, [t.detach().clone() for t in ins]))
        return launch(mode, *ins)
    monkeypatch.setattr(overlap_kernel, "s_combinations", tap)
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
    n0 = overlap_kernel.launches
    s = md.initialize(sp, co, velocities=np.zeros_like(co),
                      initial_force=False)
    md.step(sp, s)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert overlap_kernel.launches - n0 == len(calls) > 0
    assert sorted({m for m, _ in calls}) == [2, 3, 4]
    for mode, ins in calls:
        _overlap_against_chains(mode, ins)


def test_overlap_kernel_edge_cells(cuda):
    """Random classes and geometries with padding cells (rij = 1), zero
    exponents (a zero A argument), equal exponents (the B limit) and the
    Taylor regime, at every mode, on contiguous and expanded inputs.  The
    distances (from 0.8 Bohr) and exponents (to 3.5) reach overlaps near
    1, where the float32 prefactors alone put the chain up to ~3e-7 from
    float64, so the kernel is held to the chain's own error there; then
    distances out to the overlap cutoff (40 Bohr) against the float64
    chain alone: there the A argument passes 87, the float32 exp of the
    double-float chain turns subnormal and then 0, and the kernel's FP64
    A integrals do not."""
    g = torch.Generator(device="cpu").manual_seed(9)
    n = 40000
    qni = torch.randint(1, 3, (n,), generator=g)
    qnj = torch.minimum(qni, torch.randint(1, 3, (n,), generator=g))
    r = 0.8 + 11.2 * torch.rand(n, generator=g)
    z = 0.5 + 3.0 * torch.rand(4, n, generator=g)
    r[:1000] = 1.0
    z[:, 1000:2000] = 0.0
    z[2:, 2000:3000] = z[:2, 2000:3000]
    z[2:, 3000:4000] = z[:2, 3000:4000] + 1.0e-3 * torch.rand(
        2, 1000, generator=g)
    ins = [t.to(cuda) for t in (r, *z, (qni == 1) & (qnj == 1),
                                (qni == 2) & (qnj == 1),
                                (qni == 2) & (qnj == 2))]
    for mode in (2, 3, 4):
        _overlap_against_chains(mode, ins, bar=None)
    # expanded per-atom exponents, as the X-H and H-H call sites pass them
    zi = z[0, :64].to(cuda)[:, None].expand(64, 625)
    zj = z[1, :625].to(cuda)[None, :].expand(64, 625)
    grid = [r.to(cuda).view(64, 625), zi, zi, zj, zj] + [
        m.view(64, 625) for m in ins[5:]]
    for mode in (2, 3, 4):
        _overlap_against_chains(mode, grid, bar=None)
    far = [(12.0 + 28.0 * torch.rand(n, generator=g)).to(cuda)] + ins[1:]
    exact = tov._s_combinations(*[t.double() if t.is_floating_point()
                                  else t for t in far], False, 4)
    for got, e in zip(overlap_kernel.s_combinations(4, *far), exact):
        assert bool(torch.isfinite(got).all())
        assert float((got.double() - e).abs().max()) <= 3.0e-7


@pytest.mark.parametrize("mode", [2, 3, 4])
def test_overlap_kernel_is_one_launch(cuda, mode, tmp_path):
    """One segment is one kernel launch: the CUDA graph captured around
    one call holds one node, the overlap kernel, and nothing else (the
    five outputs are allocated without a fill)."""
    nmol, K, AH = 512, 2, 6
    g = torch.Generator(device="cpu").manual_seed(mode)
    zeta = (0.8 + 2.0 * torch.rand(nmol, K + AH, generator=g)).to(cuda)
    r = (1.0 + 8.0 * torch.rand(nmol, K, AH, generator=g)).to(cuda)
    zi = zeta[:, :K, None].expand(nmol, K, AH)
    zj = zeta[:, None, K:].expand(nmol, K, AH)
    j = torch.rand(nmol, K, AH, generator=g).to(cuda)
    ins = (r, zi, zi, zj, zj, j < 0.3, (j >= 0.3) & (j < 0.6), j >= 0.6)
    before = overlap_kernel.launches
    nodes = _graph_nodes(lambda: overlap_kernel.s_combinations(mode, *ins),
                         tmp_path / "graph.dot")
    assert (len(nodes) == 1 and "KERNEL" in nodes[0]
            and "overlap_s_kernel" in nodes[0]), [nd[:160] for nd in nodes]
    assert overlap_kernel.launches == before + 2    # warm-up and capture


def _wapply_case(C, dtype, device, seed, lead=None):
    g = torch.Generator(device="cpu").manual_seed(seed)
    lead = (C,) if lead is None else lead
    mk = lambda *shape: torch.randn(*shape, generator=g,  # noqa: E731
                                    dtype=torch.float64)
    x = mk(*lead, 3)
    U = frame_matrix(x / x.norm(dim=-1, keepdim=True))
    return [t.to(device=device, dtype=dtype) for t in
            (5.0 * mk(*lead, 22), U, mk(*lead, 4, 4), mk(*lead, 4, 4))]


def _grads(fn, ri, U, X, Yb, perm):
    leaves = [t.detach().clone().requires_grad_(True) for t in (ri, U, X)]
    y = fn(*leaves, perm)
    return (y,) + torch.autograd.grad(y, leaves, Yb)


K3_PERMS = [(1, 2, 3, 4), (3, 4, 1, 2), (1, 3, 2, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("perm", K3_PERMS)
@pytest.mark.parametrize("C", [1001, 40960])
def test_wapply_kernel_matches_plain(cuda, dtype, perm, C):
    """Contiguous operands (C = 1001 leaves a ragged last tile), then the
    same count as views one cell into larger tensors: in float32 not
    16-byte aligned, so the kernels take their plain-load path."""
    for offset in (0, 1):
        ri, U, X, Yb = (t[offset:] for t in
                        _wapply_case(C + offset, dtype, cuda, C))
        if offset and dtype == torch.float32:
            assert ri.data_ptr() % 16 != 0
        f0, b0 = wapply_kernel.launches_fwd, wapply_kernel.launches_bwd
        y, dri, dU, dX = _grads(wapply_kernel.w_apply, ri, U, X, Yb, perm)
        torch.cuda.synchronize()
        assert (wapply_kernel.launches_fwd - f0, wapply_kernel.launches_bwd
                - b0) == (1, 1)
        ref = _grads(wapply_kernel.w_apply_reference, ri, U, X, Yb, perm)
        # f32: the bounds of the TPU kernel's own check
        # (tools/wapply_pallas.py check(): 3e-6 of the largest value);
        # f64: rounding
        tol = 3.0e-6 if dtype == torch.float32 else 1.0e-12
        assert (y - ref[0]).abs().max() <= tol * ref[0].abs().max()
        # the kernel returns dU on the 3x3 block only (U's row 0 and
        # column 0 are structural constants)
        assert not dU[..., 0, :].any() and not dU[..., 1:, 0].any()
        for a, b in ((dri, ref[1]), (dU[..., 1:, 1:], ref[2][..., 1:, 1:]),
                     (dX, ref[3])):
            assert (a - b).abs().max() <= tol * max(b.abs().max().item(),
                                                    1.0)


@pytest.mark.parametrize("perm", K3_PERMS)
def test_wapply_is_one_launch(cuda, perm, tmp_path):
    """The K3 forward and backward are one kernel launch each: the CUDA
    graph captured around one call holds one node, the kernel."""
    ri, U, X, Yb = (t.contiguous() for t in
                    _wapply_case(4096, torch.float32, cuda, 11))
    need = (True, True, True)
    for name, fn in (("wapply_fwd",
                      lambda: wapply_kernel._launch_fwd(ri, U, X, perm)),
                     ("wapply_bwd", lambda: wapply_kernel._launch_bwd(
                         ri, U, X, Yb, perm, need))):
        counts = wapply_kernel.launches_fwd, wapply_kernel.launches_bwd
        nodes = _graph_nodes(fn, tmp_path / f"{name}.dot")
        assert (len(nodes) == 1 and "KERNEL" in nodes[0]
                and name in nodes[0]), [nd[:160] for nd in nodes]
        grown = [b - a for a, b in zip(counts, (wapply_kernel.launches_fwd,
                                                 wapply_kernel.launches_bwd))]
        assert grown == ([2, 0] if name == "wapply_fwd" else [0, 2])


@pytest.mark.parametrize("perm", K3_PERMS)
def test_wapply_expanded_x_and_double_backward(cuda, perm):
    """The Coulomb apply of the packed Fock build (X = Pd[:, None]
    broadcast over the row atom; its cotangent is reduced back by
    autograd), then K3's second derivative: double backward through WApply
    and WApplyBwd (the K3 backward kernel, its backward three K3 forward
    applies) against double backward through the plain version, float64:
    the gradients of a linear form of (dri, dU, dX) by ri, U (the 3x3
    block), X and the output cotangent."""
    ri, U, _, Yb = _wapply_case(0, torch.float64, cuda, 3, lead=(64, 5, 5))
    Xb = _wapply_case(0, torch.float64, cuda, 4, lead=(64, 1, 5))[2]
    y, dri, dU, dX = _grads(wapply_kernel.w_apply, ri, U, Xb, Yb,
                            (1, 2, 3, 4))
    ref = _grads(wapply_kernel.w_apply_reference, ri, U, Xb, Yb,
                 (1, 2, 3, 4))
    assert dX.shape == Xb.shape
    assert (y - ref[0]).abs().max() <= 1e-12 * ref[0].abs().max()
    assert (dX - ref[3]).abs().max() <= 1e-12 * ref[3].abs().max()

    blk = torch.zeros(4, 4, dtype=torch.float64, device=cuda)
    blk[1:, 1:] = 1.0
    w = _wapply_case(0, torch.float64, cuda, 5, lead=(64, 5, 5))
    v = [w[0], w[1] * blk, _wapply_case(0, torch.float64, cuda, 6,
                                        lead=(64, 1, 5))[2]]

    def second(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (ri, U, Xb, Yb)]
        g = torch.autograd.grad(fn(*leaves[:3], perm), leaves[:3],
                                leaves[3], create_graph=True)
        return torch.autograd.grad(sum((a * b).sum() for a, b in zip(v, g)),
                                   leaves)
    f0, b0 = wapply_kernel.launches_fwd, wapply_kernel.launches_bwd
    got = second(wapply_kernel.w_apply)
    torch.cuda.synchronize()
    # the forward, WApplyBwd's backward kernel, and its three applies
    assert (wapply_kernel.launches_fwd - f0,
            wapply_kernel.launches_bwd - b0) == (4, 1)
    ref = second(wapply_kernel.w_apply_reference)
    for k, (a, b) in enumerate(zip(got, ref)):
        if k == 1:
            a, b = a[..., 1:, 1:], b[..., 1:, 1:]
        assert (a - b).abs().max() <= 1e-12 * max(b.abs().max().item(), 1.0)


def _learned_grads(device, dtype, cfg_kw):
    """Energy of make_batch(12, 8) with per-atom learned U_ss and zeta_s
    and the gradient of sum(Hf) to them and the coordinates."""
    sp, co = make_batch(12, 8, jitter=0.02, seed=4)
    const, tables, cfg = pt.build("AM1", dtype=dtype, device=device,
                                  **cfg_kw)
    species = torch.as_tensor(sp, device=device)
    learned = {k: tables[k][species].clone().requires_grad_(True)
               for k in ("U_ss", "zeta_s")}
    x = torch.tensor(co, dtype=dtype, device=device, requires_grad=True)
    out = pt.energy(const, tables, cfg, sp, x, learned=learned)
    return [t.detach().double().cpu() for t in (out.Hf,) + torch.autograd.grad(
        out.Hf.sum(), (learned["U_ss"], learned["zeta_s"], x))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("pack", [True, False])
def test_adjoint_grads_on_card_match_cpu(cuda, dtype, pack):
    """Backward mode 1 (the SCF adjoint) on the card, packed and flat:
    Hf and its gradients to U_ss, zeta_s and R against the CPU run.
    float64: rounding (K3 float64 against the plain apply, the same
    torch.linalg.eigh); float32 (K2 and K3 float32 against the plain
    versions): the f32 budgets of phase 19 of chip_smoke.py."""
    K = pt.packed_heavy_count(make_batch(12, 8, jitter=0.02, seed=4)[0])
    eps = 1.0e-10 if dtype == torch.float64 else 1.0e-5
    kw = dict(scf=SCFConfig(eps=eps, converger=(2,), backward=1,
                            pack_heavy=K if pack else None))
    counts = (eigh_kernel.launches, wapply_kernel.launches_fwd,
              wapply_kernel.launches_bwd)
    got = _learned_grads(cuda, dtype, kw)
    grown = [b - a for a, b in zip(counts, (eigh_kernel.launches,
                                            wapply_kernel.launches_fwd,
                                            wapply_kernel.launches_bwd))]
    ref = _learned_grads("cpu", dtype, kw)
    assert grown[1] > 0 and grown[2] > 0
    assert grown[0] > 0 if dtype == torch.float32 else grown[0] == 0
    tols = ((1e-9, 1e-9, 1e-8, 1e-8) if dtype == torch.float64
            else (1.5e-4, 2.0e-4, 2.0e-3, 2.0e-3))
    for a, b, tol in zip(got, ref, tols):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol)


def _water_hessian(device, dtype):
    const, tables, cfg = pt.build(
        "AM1", dtype=dtype, device=device, scf=SCFConfig(
            eps=1.0e-11 if dtype == torch.float64 else 1.0e-5,
            converger=(0, 0.0), backward=2, backward_scan_iters=30))
    c = torch.tensor([[[0.0, 0.0, 0.0], [0.96, 0.07, 0.02],
                       [-0.22, 0.93, -0.05]]], dtype=dtype, device=device,
                     requires_grad=True)
    out = pt.energy(const, tables, cfg, np.array([[8, 1, 1]]), c)
    (g,) = torch.autograd.grad(out.Hf.sum(), c, create_graph=True)
    g = g.reshape(-1)
    return torch.stack([torch.autograd.grad(g[k], c, retain_graph=True)[0]
                        .reshape(-1) for k in range(9)]).double().cpu()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_water_hessian_on_card_matches_cpu(cuda, dtype):
    """The 9x9 water Hessian of tests/test_second_order.py through the
    unrolled SCF on the card (K3 and its second derivative; at float32 K2
    and the double-float overlap's second derivative) against the CPU
    run: float64 rounding, float32 the f32 Hessian budget of
    tests/test_torch_second_order.py (1e-4 of max |H|)."""
    f0, b0 = wapply_kernel.launches_fwd, wapply_kernel.launches_bwd
    H = _water_hessian(cuda, dtype)
    assert wapply_kernel.launches_fwd > f0 and wapply_kernel.launches_bwd > b0
    ref = _water_hessian("cpu", dtype)
    scale = ref.abs().max().item()
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert (H - ref).abs().max().item() <= tol * scale
    if dtype == torch.float64:
        assert (H - H.T).abs().max().item() <= 1e-8 * scale


def test_flat_split_on_card_matches_cpu(cuda):
    """The class-segmented flat pair list (pack_pairs, dense_pair_grid
    False: K3 on the XX slice) on the card against the CPU run, float32:
    the f32 budget of the f32-vs-f64 tests (1.5e-4 eV, 1e-3 eV/A)."""
    sp, co = make_batch(12, 8, jitter=0.02, seed=4)
    K = pt.packed_heavy_count(sp)
    out = {}
    for dev in ("cpu", cuda):
        const, tables, cfg = pt.build(
            "AM1", dtype=torch.float32, device=dev, pack_pairs=True,
            dense_pair_grid=False,
            scf=SCFConfig(eps=1.0e-5, converger=(2,), pack_heavy=K))
        f0 = wapply_kernel.launches_fwd
        f, o = pt.force(const, tables, cfg, sp,
                        torch.tensor(co, dtype=torch.float32, device=dev))
        assert type(o.w).__name__ == "WPackSplit"
        out[str(dev)] = (f.cpu(), o.Hf.cpu(), wapply_kernel.launches_fwd - f0)
    (fc, hc, lc), (fg, hg, lg) = out["cpu"], out["cuda"]
    assert lc == 0 and lg > 0
    np.testing.assert_allclose(hg.numpy(), hc.numpy(), rtol=0, atol=1.5e-4)
    np.testing.assert_allclose(fg.numpy(), fc.numpy(), rtol=0, atol=1e-3)


def test_default_layout_on_card_matches_cpu(cuda):
    """Energy and force with the default SCFConfig (flat pair list, K2 at
    n = 32, K3 in every Fock build and in the backward) on the card against
    the CPU run of the same float32 inputs."""
    sp, co = make_batch(12, 8, jitter=0.02, seed=4)
    out = {}
    for dev in ("cpu", cuda):
        const, tables, cfg = pt.build(
            "AM1", dtype=torch.float32, device=dev,
            scf=SCFConfig(eps=1.0e-5, converger=(2,)))
        f0, b0 = wapply_kernel.launches_fwd, wapply_kernel.launches_bwd
        f, o = pt.force(const, tables, cfg, sp,
                        torch.tensor(co, dtype=torch.float32, device=dev))
        out[str(dev)] = (f.cpu(), o.Hf.cpu(), wapply_kernel.launches_fwd
                         - f0, wapply_kernel.launches_bwd - b0)
    (fc, hc, lfc, lbc), (fg, hg, lfg, lbg) = out["cpu"], out["cuda"]
    assert lfc == 0 and lbc == 0 and lfg > 0 and lbg == 3
    # two f32 runs in different summation orders: the f32 budget of the
    # f32-vs-f64 tests (1.5e-4 eV, 1e-3 eV/A)
    np.testing.assert_allclose(hg.numpy(), hc.numpy(), rtol=0, atol=1.5e-4)
    np.testing.assert_allclose(fg.numpy(), fc.numpy(), rtol=0, atol=1e-3)


def _nvt_run(drv, sp, co, v0, dev, steps=3):
    st = drv.initialize(sp, torch.tensor(co, device=dev),
                        velocities=torch.tensor(v0, device=dev))
    for _ in range(steps):
        st, _ = drv.step(sp, st)
    return st


def test_nvt_drivers_on_card_match_cpu(cuda):
    """Langevin (the same normal draws fed on both devices) and
    Nose-Hoover, 3 steps at float64 (K3 in every Fock build and force
    backward) on the card against the CPU run: 1e-8."""
    from pyseqm_tpu_torch.drivers.md import (LangevinDynamics,
                                             NoseHooverDynamics)
    sp, co = make_batch(6, 8, jitter=0.02, seed=4)
    v0 = np.random.default_rng(1).standard_normal(co.shape) * 0.01
    v0[sp == 0] = 0.0
    noise = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8,) + co.shape))
    out = {}
    for dev in ("cpu", cuda):
        const, tables, cfg = pt.build(
            "AM1", dtype=torch.float64, device=dev,
            scf=SCFConfig(eps=1.0e-10, converger=(2,)))
        lang = LangevinDynamics(const, tables, cfg,
                                MDConfig(timestep=0.5, damp=10.0),
                                generator=torch.Generator(dev))
        lang.random_normal = lambda st, shape, d=dev: noise[st.step].to(d)
        nh = NoseHooverDynamics(const, tables, cfg, MDConfig(timestep=0.4),
                                tau=10.0)
        f0 = wapply_kernel.launches_fwd
        sl = _nvt_run(lang, sp, co, v0, dev)
        sn = _nvt_run(nh, sp, co, v0, dev)
        out[str(dev)] = [t.cpu() for t in (sl.coordinates, sl.velocities,
                                           sn.coordinates, sn.velocities,
                                           sn.vxi, sn.xi)]
        out[str(dev) + "_k3"] = wapply_kernel.launches_fwd - f0
    assert out["cpu_k3"] == 0 and out["cuda_k3"] > 0
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-8)


def test_optimizers_on_card_match_cpu(cuda):
    """Chunked steepest descent (8 evaluations) and one 5-iteration chunk
    of the warm L-BFGS at float64 on the card against the CPU run: the
    geometries to 1e-8, the iteration counts exact."""
    from pyseqm_tpu_torch.drivers.opt import (geometry_optimize_sd,
                                              make_lbfgs_warm)
    sp, co = make_batch(6, 8, jitter=0.05, seed=4)
    out = {}
    for dev in ("cpu", cuda):
        const, tables, cfg = pt.build(
            "AM1", dtype=torch.float64, device=dev,
            scf=SCFConfig(eps=1.0e-10, converger=(2,)))
        x = torch.tensor(co, device=dev)
        xs, _, _ = geometry_optimize_sd(const, tables, cfg, sp, x,
                                        alpha=0.004, force_tol=0.0,
                                        max_evl=8, chunk=4)
        init, run = make_lbfgs_warm(const, tables, cfg, sp, chunk=5)
        st, _, _ = run(init(x))
        out[str(dev)] = (xs.cpu(), st.x.cpu(), st.nit, st.done.cpu())
    (sc, lc, nc, dc), (sg, lg, ng, dg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(sg.numpy(), sc.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(lg.numpy(), lc.numpy(), rtol=0, atol=1e-8)
    assert ng == nc and bool((dg == dc).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_row3_on_card_matches_cpu(cuda, dtype):
    """Row 3 (H2S, CH3SH and the row-3-free rest of ROW3_NAMES) in the
    packed dense, the flat split and the flat layouts on the card against
    the CPU run: 1e-8 eV and 1e-7 eV/A at float64, the f32 budget (1.5e-4
    eV, 1e-3 eV/A) at float32, where the row-3 classes take the
    double-float chain."""
    from pyseqm_tpu_torch.utils.molecules import ROW3_NAMES
    sp, co = make_batch(12, 8, jitter=0.02, seed=4, names=ROW3_NAMES)
    assert (sp == 16).any()
    K = pt.packed_heavy_count(sp)
    tol = ((1e-8, 1e-7) if dtype == torch.float64 else (1.5e-4, 1e-3))
    eps = 1.0e-10 if dtype == torch.float64 else 1.0e-5
    for kw in (dict(scf=SCFConfig(eps=eps, converger=(2,), pack_heavy=K)),
               dict(scf=SCFConfig(eps=eps, converger=(2,), pack_heavy=K),
                    dense_pair_grid=False),
               dict(scf=SCFConfig(eps=eps, converger=(2,)))):
        out = {}
        for dev in ("cpu", cuda):
            const, tables, cfg = pt.build("PM3", dtype=dtype, device=dev,
                                          row3=True, **kw)
            f, o = pt.force(const, tables, cfg, sp,
                            torch.tensor(co, dtype=dtype, device=dev))
            assert not bool(o.notconverged.any())
            out[str(dev)] = (f.cpu(), o.Hf.cpu())
        (fc, hc), (fg, hg) = out["cpu"], out["cuda"]
        np.testing.assert_allclose(hg.numpy(), hc.numpy(), rtol=0,
                                   atol=tol[0])
        np.testing.assert_allclose(fg.numpy(), fc.numpy(), rtol=0,
                                   atol=tol[1])


def test_hipnn_on_card_matches_cpu(cuda):
    """The trained HIP-NN model's parameters and the PM3 force it drives
    (packed SP2: K1, K3) at float64 on the card against the CPU run: the
    parameters to 1e-10, Hf to 1e-8 eV, forces to 1e-7 eV/A; a species
    outside the model raises on the card too."""
    from pyseqm_tpu_torch.models.hipnn import make_hipnn_callable
    sp, co = make_batch(4, 8, jitter=0.02, seed=13)
    K = pt.packed_heavy_count(sp)
    out = {}
    for dev in ("cpu", cuda):
        const, tables, cfg = pt.build(
            "PM3", dtype=torch.float64, device=dev,
            scf=SCFConfig(eps=1.0e-10, converger=(2,), use_sp2=True,
                          sp2_eps=1.0e-7, pack_heavy=K))
        net = make_hipnn_callable(dtype=torch.float64, device=dev)
        species = torch.tensor(sp, dtype=torch.long, device=dev)
        x = torch.tensor(co, device=dev)
        with torch.no_grad():
            p = net(species, x)
        f, o = pt.force(const, tables, cfg, species, x, learned=net)
        assert not bool(o.notconverged.any())
        out[str(dev)] = ({k: v.cpu() for k, v in p.items()}, f.cpu(),
                         o.Hf.cpu())
        with pytest.raises(ValueError, match="HIP-NN"):
            net(torch.tensor([[16, 1, 1, 0]], device=dev), x[:1, :4])
    (pc, fc, hc), (pg, fg, hg) = out["cpu"], out["cuda"]
    for k in pc:
        np.testing.assert_allclose(pg[k].numpy(), pc[k].numpy(), rtol=0,
                                   atol=1e-10, err_msg=k)
    np.testing.assert_allclose(hg.numpy(), hc.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(fg.numpy(), fc.numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("pack", [True, False])
def test_ml_hooks_on_card_match_cpu(cuda, pack):
    """Kbeta and g_ss_nuc on the packed class-segmented grid and the
    default flat layout at float64 on the card against the CPU: Hf and
    Enuc to 1e-8 eV, their gradients to both hooks to 1e-8."""
    sp, co = make_batch(6, 8, jitter=0.02, seed=5)
    K = pt.packed_heavy_count(sp) if pack else None
    rng = np.random.default_rng(17)
    kb = rng.uniform(0.9, 1.1, (6, 28, 4))
    out = {}
    for dev in ("cpu", cuda):
        const, tables, cfg = pt.build(
            "AM1", dtype=torch.float64, device=dev,
            scf=SCFConfig(eps=1.0e-10, converger=(2,), pack_heavy=K))
        species = torch.tensor(sp, dtype=torch.long, device=dev)
        k = torch.tensor(kb, device=dev, requires_grad=True)
        g = (tables["g_ss"][species] * 1.03).requires_grad_(True)
        o = pt.energy(const, tables, cfg, species,
                      torch.tensor(co, device=dev),
                      learned={"Kbeta": k, "g_ss_nuc": g})
        gk, gg = torch.autograd.grad(o.Hf.sum(), (k, g))
        out[str(dev)] = [t.detach().cpu() for t in (o.Hf, o.Enuc, gk, gg)]
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-8)


def test_resume_on_card_is_exact(cuda, tmp_path):
    """Checkpoint and resume on the card at float32: the packed XL-SP2
    driver (K1, K3) and the Langevin driver with a CUDA generator, 4 steps
    straight against 2, a checkpoint, a fresh driver and 2 more: every
    field equal, bit for bit."""
    from pyseqm_tpu_torch.drivers.md import LangevinDynamics
    from pyseqm_tpu_torch.utils.checkpoint import load_state, save_state
    sp, co = make_batch(64, 8, jitter=0.02, seed=3)
    K = pt.packed_heavy_count(sp)
    const, tables, cfg = pt.build(
        "AM1", dtype=torch.float32, device=cuda,
        scf=SCFConfig(eps=1.0e-5, converger=(2,), use_sp2=True,
                      sp2_eps=1.0e-4, pack_heavy=K))
    species = torch.tensor(sp, dtype=torch.long, device=cuda)
    x = torch.tensor(co, dtype=torch.float32, device=cuda)

    def xl(seed):
        md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
        return md, md.initialize(species, x, velocities=torch.zeros_like(x),
                                 initial_force=False)

    def langevin(seed):
        md = LangevinDynamics(const, tables, cfg,
                              MDConfig(timestep=0.4, damp=20.0),
                              generator=torch.Generator(cuda).manual_seed(
                                  seed))
        return md, md.initialize(species, x)

    for build in (xl, langevin):
        md, st = build(0)
        for _ in range(2):
            st, _ = md.step(species, st)
        path = str(tmp_path / f"{build.__name__}.npz")
        save_state(path, st, generator=getattr(md, "generator", None))
        for _ in range(2):
            st, _ = md.step(species, st)
        md2, like = build(7)
        st2 = load_state(path, like, generator=getattr(md2, "generator",
                                                       None))
        for _ in range(2):
            st2, _ = md2.step(species, st2)
        for name in ("coordinates", "velocities", "acc", "P"):
            assert torch.equal(getattr(st, name), getattr(st2, name)), name
