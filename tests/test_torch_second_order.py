"""PyTorch port, second derivatives on the CPU: the 9x9 water Hessian of
tests/test_second_order.py::test_hessian_subblock_symmetry_default
(backward mode 2, the unrolled SCF) against the JAX package's
forward-over-reverse Hessian at f64 (one trace per file), with and
without the integrals' remat, its symmetry, and the float32 Hessian
against it; the double-float overlap's second derivative at f32 against
the plain chain's; rho1/rho2 raising under double backward, as the JAX
package's custom_vjp does; and K3's second derivative: the adjoint-perm
identity of the apply, and ``WApplyBwd``'s second-order terms (on its
plain CPU route) against double backward through ``w_apply_reference``
at f64, for every perm."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu_torch.ops import multipole, overlap
from pyseqm_tpu_torch.ops import wapply_kernel as wk
from pyseqm_tpu_torch.ops.tetci import frame_matrix
from pyseqm_tpu_torch.scf import SCFConfig

torch.set_num_threads(1)
PERMS = [(1, 2, 3, 4), (3, 4, 1, 2), (1, 3, 2, 4)]
WATER_SP = np.array([[8, 1, 1]])
WATER_CO = np.array([[[0.0, 0.0, 0.0], [0.96, 0.07, 0.02],
                      [-0.22, 0.93, -0.05]]])
# the unrolled SCF of test_hessian_subblock_symmetry_default
WATER_SCF = dict(eps=1.0e-11, converger=(0, 0.0), backward=2,
                 backward_scan_iters=30)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


@functools.lru_cache(maxsize=None)
def jax_water_hessian():
    """JAX's 9x9 water Hessian through the mode-2 SCF, forward over
    reverse: the very program of
    tests/test_second_order.py::test_hessian_subblock_symmetry_default
    (jit of jax.jacfwd(jax.grad(Hf)) on the same constants, species and
    configuration), so the persistent compilation cache serves whichever
    of the two runs second: one compile (~280 s cold on the CPU) for both
    files, where a jitted jvp column here (~150 s) came on top of that
    test's."""
    jc = pq.make_constants(dtype=jnp.float64)
    jt = pq.load_element_tables("AM1", dtype=jnp.float64)
    cfg = pq.SEQMConfig(method="AM1", scf=JSCFConfig(**WATER_SCF))
    sp = jnp.asarray(WATER_SP, jnp.int32)

    def hf(c):
        return jnp.sum(pq.energy(jc, jt, cfg, sp, c).Hf)
    H = jax.jit(jax.jacfwd(jax.grad(hf)))(jnp.asarray(WATER_CO))
    return np.asarray(H).reshape(9, 9)


def port_hessian(dtype, remat=None):
    """The port's water Hessian by double backward: the gradient with its
    graph, then one backward per coordinate."""
    const = pt.make_constants(dtype=dtype, device="cpu")
    tables = pt.load_element_tables("AM1", device="cpu", dtype=dtype)
    scf = dict(WATER_SCF)
    if dtype == torch.float32:
        scf["eps"] = 1.0e-5
    cfg = pt.SEQMConfig(method="AM1", scf=SCFConfig(**scf),
                        remat_integrals=remat)
    c = torch.tensor(WATER_CO, dtype=dtype, requires_grad=True)
    out = pt.energy(const, tables, cfg, WATER_SP, c)
    assert not bool(out.notconverged.any())
    (g,) = torch.autograd.grad(out.Hf.sum(), c, create_graph=True)
    g = g.reshape(-1)
    return np.stack([_np(torch.autograd.grad(g[k], c, retain_graph=True)[0])
                     .reshape(-1) for k in range(9)]).astype(np.float64)


@pytest.mark.parametrize("remat", [False, True])
def test_water_hessian_matches_jax(remat):
    """The f64 Hessian against JAX's at 1e-8 of its largest element and
    symmetric as test_second_order.py asks; with remat on, the double
    backward runs through the checkpointed integral build."""
    ref = jax_water_hessian()
    H = port_hessian(torch.float64, remat)
    scale = np.abs(ref).max()
    assert scale > 1.0
    np.testing.assert_allclose(H, ref, rtol=0, atol=1e-8 * scale)
    assert np.abs(H - H.T).max() < 1e-8 * np.abs(H).max()


def test_water_hessian_float32():
    """The f32 Hessian (the Jacobi eigensolver's plain version, the
    double-float overlap with its plain second derivative) against the
    f64 one.  Measured on the CPU: 1.2e-3 eV/A^2 at max |H| 48 eV/A^2;
    bound 1e-4 of max |H| (5e-3 eV/A^2), f32 SCF noise through a second
    derivative of the unrolled fixed point."""
    ref = port_hessian(torch.float64)
    H = port_hessian(torch.float32)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(H, ref, rtol=0, atol=1e-4 * scale)


def test_double_float_overlap_second_derivative():
    """d2S/dr2 and d2S/dr dzeta through the f32 double-float overlap (a
    create_graph backward through _STf) equal the plain chain's, which
    the JAX custom_jvp's tangent is; before the repair the gradient came
    back without a graph."""
    rng = np.random.RandomState(3)
    n = 16
    r0 = torch.tensor(rng.uniform(1.5, 5.0, n), dtype=torch.float32)
    qi = torch.full((n,), 2)
    qj = torch.tensor([2, 1] * (n // 2))
    x = torch.tensor(rng.randn(n, 3), dtype=torch.float32)
    x = x / x.norm(dim=-1, keepdim=True)
    zeta_i = torch.tensor(rng.uniform(1.0, 2.5, (n, 2)), dtype=torch.float32)
    zeta_j = torch.tensor(rng.uniform(1.0, 2.5, (n, 2)), dtype=torch.float32)

    def second(precise):
        r = r0.clone().requires_grad_(True)
        zi = zeta_i.clone().requires_grad_(True)
        S = overlap.diatom_overlap(qi, qj, x, r, zi, zeta_j, precise=precise)
        w = torch.linspace(-1.0, 1.0, 16).reshape(4, 4)
        (g,) = torch.autograd.grad((S * w).sum(), r, create_graph=True)
        assert g.grad_fn is not None
        return [_np(t) for t in torch.autograd.grad(g.sum(), (r, zi))]
    for a, b in zip(second(True), second(False)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(
            b).max())


@pytest.mark.parametrize("which", ["rho1", "rho2"])
def test_rho_double_backward_raises(which):
    """rho1/rho2's implicit derivatives are once differentiable: a second
    derivative raises (the JAX functions are custom_vjp), where the
    derivative read D1/D2 built outside the graph and came back wrong."""
    h = torch.tensor([-2.0, -1.5], dtype=torch.float64, requires_grad=True)
    d = torch.tensor([0.8, 1.1], dtype=torch.float64, requires_grad=True)
    fn = (multipole.rho1_additive if which == "rho1"
          else multipole.rho2_additive)
    rho = fn(h, d, torch.tensor([True, True]))
    (g,) = torch.autograd.grad((rho ** 2).sum(), d, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g.sum().backward()


def _k3_case(C, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(C, 3)
    U = frame_matrix(torch.tensor(x / np.linalg.norm(x, axis=-1,
                                                     keepdims=True)))
    return (torch.tensor(5.0 * rng.randn(C, 22)), U,
            torch.tensor(rng.randn(C, 4, 4)), torch.tensor(rng.randn(C, 4, 4)))


@pytest.mark.parametrize("perm", PERMS)
def test_wapply_adjoint_perm_identity(perm):
    """dX of the apply is the apply at the adjoint perm, for a frame U
    and for a general U."""
    ri, U, X, Yb = _k3_case(40, 5)
    G = torch.tensor(np.random.RandomState(6).randn(40, 4, 4))
    for u in (U, G):
        Xl = X.clone().requires_grad_(True)
        (dX,) = torch.autograd.grad(wk.w_apply_reference(ri, u, Xl, perm),
                                    Xl, Yb)
        ref = wk.w_apply_reference(ri, u, Yb, wk.adjoint_perm(perm))
        np.testing.assert_allclose(_np(dX), _np(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("perm", PERMS)
def test_wapply_second_order_matches_plain(perm):
    """Double backward through WApply / WApplyBwd (their plain CPU route:
    the kernels' formulas, the three K3 applies of the second-order terms
    as plain applies) against double backward through w_apply_reference,
    at f64: the first-order cotangents, then the gradients of a random
    linear form of them by ri, U (the 3x3 block the kernels read), X and
    the output cotangent Yb."""
    ri0, U0, X0, Yb0 = _k3_case(40, 7)
    rng = np.random.RandomState(8)
    blk = torch.zeros(4, 4, dtype=torch.float64)
    blk[1:, 1:] = 1.0
    v = [torch.tensor(rng.randn(40, 22)),
         torch.tensor(rng.randn(40, 4, 4)) * blk,
         torch.tensor(rng.randn(40, 4, 4))]

    def run(fn):
        ri, U, X, Yb = (t.clone().requires_grad_(True)
                        for t in (ri0, U0, X0, Yb0))
        g = torch.autograd.grad(fn(ri, U, X, perm), (ri, U, X), Yb,
                                create_graph=True)
        form = sum((a * b).sum() for a, b in zip(v, g))
        return ([_np(t) for t in g],
                [_np(t) for t in torch.autograd.grad(form, (ri, U, X, Yb))])
    g1, h1 = run(wk.WApply.apply)
    g2, h2 = run(wk.w_apply_reference)
    b = _np(blk)
    for k, (a, r) in enumerate(zip(g1 + h1, g2 + h2)):
        r = r * b if k in (1, 4) else r
        np.testing.assert_allclose(a, r, rtol=0, atol=1e-11 * max(
            np.abs(r).max(), 1.0), err_msg=f"output {k}")
