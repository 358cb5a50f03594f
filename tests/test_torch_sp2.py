"""PyTorch port, SP2 purifier: the kernel's plain version against the JAX
package's Pallas kernel in interpret mode (the cases of test_kernels.py),
the wrapper's checks and CPU dispatch, and the f64 packed sp2 against JAX.
The CUDA kernel itself is held against the plain version in
test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.ops import density as jdens
from pyseqm_tpu.ops.sp2_pallas import sp2_purify_tpu
from pyseqm_tpu.system import make_system as jmake_system
from pyseqm_tpu_torch.ops import density as tdens
from pyseqm_tpu_torch.ops import sp2_kernel
from pyseqm_tpu_torch.ops.sp2_kernel import sp2_purify, sp2_purify_reference
from pyseqm_tpu_torch.system import make_system
from pyseqm_tpu_torch.utils.molecules import make_batch

torch.set_num_threads(1)


def _gap_case(B, n, nocc, seed):
    """Pre-scaled SP2 inputs a0 from symmetric matrices with a clean
    occupied/virtual gap, and the exact density (numpy, f64 eigh)."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(B, n, n))
    evals = np.concatenate([-10.0 + 2.0 * rng.rand(B, nocc),
                            2.0 + 6.0 * rng.rand(B, n - nocc)], axis=1)
    F = np.einsum('bik,bk,bjk->bij', Q, evals, Q)
    F = (0.5 * (F + np.swapaxes(F, -1, -2))).astype(np.float32)
    occ = (np.arange(n) < nocc).astype(np.float64)
    P = 2.0 * np.einsum('bik,k,bjk->bij', Q, occ, Q)
    aii = np.diagonal(F, axis1=-2, axis2=-1)
    ri = np.abs(F).sum(-1) - np.abs(aii)
    h1, hN = (aii - ri).min(-1), (aii + ri).max(-1)
    a0 = ((np.eye(n, dtype=np.float32)[None] * hN[:, None, None] - F)
          / (hN - h1)[:, None, None]).astype(np.float32)
    return a0, np.full((B,), float(nocc), np.float32), P


CASES = [(20, 16, 5, 2), (12, 32, 8, 0), (7, 32, 5, 1)]


@pytest.fixture(scope="module")
def interpret_kernel():
    """The TPU kernel in interpret mode on every case, in one call per
    matrix size: the cases of one n side by side.  Its molecules are
    independent (each stops under its own convergence mask, and another
    molecule's columns enter its block products as exact zeros)."""
    out = {}
    for n in sorted({c[1] for c in CASES}):
        cases = [c for c in CASES if c[1] == n]
        a0, nocc = [np.concatenate(t) for t in
                    zip(*[_gap_case(*c)[:2] for c in cases])]
        P = np.asarray(sp2_purify_tpu(jnp.asarray(a0), jnp.asarray(nocc),
                                      1.0e-5, interpret=True))
        out.update(zip(cases, np.split(P, np.cumsum(
            [c[0] for c in cases])[:-1])))
    return out


@pytest.mark.parametrize("B,n,nocc,seed", CASES)
def test_reference_matches_interpret_kernel(B, n, nocc, seed,
                                            interpret_kernel):
    a0, nocc_f, P_exact = _gap_case(B, n, nocc, seed)
    P = sp2_purify_reference(torch.from_numpy(a0), torch.from_numpy(nocc_f),
                             1.0e-5).numpy()
    Pj = interpret_kernel[(B, n, nocc, seed)]
    # the bounds of test_kernels.py: f32 SP2 against exact, idempotency
    # after the McWeeny polish, trace; the two implementations sum in
    # different orders, so they agree to the same 5e-5
    assert P.shape == (B, n, n)
    assert np.abs(P - Pj).max() < 5.0e-5
    assert np.abs(P - P_exact).max() < 5.0e-5
    half = P.astype(np.float64) / 2.0
    assert np.abs(half @ half - half).max() < 5.0e-5
    np.testing.assert_allclose(np.trace(P, axis1=1, axis2=2), 2.0 * nocc,
                               atol=1e-4)


def test_wrapper_dispatch_and_checks():
    a0, nocc_f, _ = _gap_case(5, 16, 4, 3)
    a, o = torch.from_numpy(a0), torch.from_numpy(nocc_f)
    before = sp2_kernel.launches
    P, it = sp2_purify(a, o, 1.0e-4, return_iters=True)
    Pr, itr = sp2_purify_reference(a, o, 1.0e-4, return_iters=True)
    # a CPU tensor runs the plain version; only kernel launches count
    assert torch.equal(P, Pr) and torch.equal(it, itr)
    assert sp2_kernel.launches == before
    assert (it > 0).all() and (it <= sp2_kernel.MAX_ITER).all()
    with pytest.raises(TypeError):
        sp2_purify(a.double(), o)
    with pytest.raises(ValueError):
        sp2_purify(torch.zeros(2, 130, 130), torch.ones(2))
    with pytest.raises(ValueError):
        sp2_purify(a.transpose(1, 2), o)
    with pytest.raises(ValueError):
        sp2_purify(a, o[:3])


def test_sp2_prepacked_f64_matches_jax():
    sp, co = make_batch(16, 8, jitter=0.05, seed=4)
    K = pt.packed_heavy_count(sp)
    n_st = pt.packed_solver_size(K, sp.shape[1])
    rng = np.random.RandomState(6)
    X = rng.randn(sp.shape[0], n_st, n_st)
    F = 3.0 * (X + np.swapaxes(X, 1, 2)) - 20.0 * np.eye(n_st)
    jsys = jax.jit(lambda x: jmake_system(
        pq.make_constants(dtype=jnp.float64), jnp.asarray(sp), x,
        heavy_count=K))(jnp.asarray(co))
    tsys = make_system(pt.make_constants(dtype=torch.float64, device="cpu"),
                       sp, torch.tensor(co), heavy_count=K)
    Ffull = tdens.static_unpack_mat(torch.tensor(F), K, sp.shape[1]).numpy()
    # the three JAX references in one program
    Pjs = jax.jit(lambda Fp, Ff: [
        jdens.sp2(jsys, Fp, eps, pack_heavy=K, prepacked=True)
        for eps in (1.0e-5, 1.0e-7)] + [
        jdens.sp2(jsys, Ff, 1.0e-7, pack_heavy=K)])(jnp.asarray(F),
                                                    jnp.asarray(Ffull))
    for eps, Pj in zip((1.0e-5, 1.0e-7), Pjs):
        P = tdens.sp2(tsys, torch.tensor(F), eps, pack_heavy=K,
                      prepacked=True)
        # f64, the same XLA-path loop (masks, trace refresh every 16
        # iterations, the f64 stopping rule): agreement to rounding
        np.testing.assert_allclose(P.numpy(), np.asarray(Pj), rtol=0,
                                   atol=1e-10)
    # the pack_heavy route: full (nmol, 4A, 4A) F in, P out, packed inside
    Pj = Pjs[2]
    P = tdens.sp2(tsys, torch.tensor(Ffull), 1.0e-7, pack_heavy=K)
    assert P.shape == Ffull.shape
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), rtol=0, atol=1e-10)
