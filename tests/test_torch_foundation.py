"""PyTorch port, foundation layer: weights, constants, System, make_batch,
compensated arithmetic and accurate exp against the JAX package, plus the
port's default device and its import isolation.  Inputs come from numpy
seeds and go to both packages."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.ops import accmath as jacc
from pyseqm_tpu.ops import xsum as jxs
from pyseqm_tpu.system import make_system as jmake_system
from pyseqm_tpu.utils.molecules import make_batch as jmake_batch
from pyseqm_tpu_torch.ops import accmath as tacc
from pyseqm_tpu_torch.ops import xsum as txs
from pyseqm_tpu_torch.system import make_system
from pyseqm_tpu_torch.utils.molecules import make_batch

torch.set_num_threads(1)
CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("method", ["AM1", "MNDO", "PM3"])
def test_tables_from_numpy_match_own_copy(method):
    jt = pq.load_element_tables(method, dtype=jnp.float64)
    carried = pt.tables_from_numpy({k: np.asarray(v) for k, v in jt.items()},
                                   device=CPU, dtype=torch.float64)
    own = pt.load_element_tables(method, device=CPU, dtype=torch.float64)
    assert carried.keys() == own.keys()
    for k in own:
        assert own[k].dtype == torch.float64
        assert torch.equal(carried[k], own[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_constants_from_numpy_match_make_constants(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jc = pq.make_constants(dtype=jdt)
    carried = pt.constants_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in jc.__dataclass_fields__},
        device=CPU, dtype=dtype)
    own = pt.make_constants(dtype=dtype, device=CPU)
    for f in jc.__dataclass_fields__:
        assert torch.equal(getattr(carried, f), getattr(own, f)), f


@pytest.mark.parametrize("kw", [dict(nmol=7, molsize=8),
                                dict(nmol=13, molsize=6, jitter=0.02, seed=3),
                                dict(nmol=12, molsize=8, jitter=0.05,
                                     sort=True)])
def test_make_batch_identical(kw):
    a = make_batch(**kw)
    b = jmake_batch(**kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("heavy", [False, True])
def test_system_fields_match_jax(golden, heavy):
    g = golden("am1_batch96")
    sp, co = g["species"], g["coordinates"]
    K = pt.packed_heavy_count(sp) if heavy else None
    charges = np.arange(sp.shape[0]) % 3 - 1
    charges = np.where(charges == 0, 0, 2 * charges)   # even: closed shells
    js = jax.jit(lambda c, q: jmake_system(
        pq.make_constants(dtype=jnp.float64), jnp.asarray(sp), c, q,
        heavy_count=K))(jnp.asarray(co), jnp.asarray(charges))
    ts = make_system(pt.make_constants(dtype=torch.float64, device=CPU), sp,
                     torch.tensor(co), charges, heavy_count=K)
    for f in js.__dataclass_fields__:
        a, b = _np(getattr(ts, f)), np.asarray(getattr(js, f))
        assert a.shape == b.shape, f
        # f64 geometry: identical op order, so agreement to rounding
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14, err_msg=f)


def test_pair_helpers_sort_and_validate_match_jax():
    from pyseqm_tpu import system as jsysmod
    from pyseqm_tpu_torch import system as tsysmod
    for A, K in ((8, 2), (8, 0), (6, 6), (13, 5)):
        for a, b in zip(tsysmod.pair_index_packed(A, K),
                        jsysmod.pair_index_packed(A, K)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tsysmod.pair_packed_from_canonical(A, K),
            jsysmod.pair_packed_from_canonical(A, K))
        assert (tsysmod.pair_segment_sizes(A, K)
                == jsysmod.pair_segment_sizes(A, K))
    rng = np.random.RandomState(4)
    sp = rng.choice([0, 1, 6, 7, 8], size=(9, 7))
    co = rng.randn(9, 7, 3)
    for a, b in zip(tsysmod.sort_species(sp, co), jsysmod.sort_species(sp, co)):
        np.testing.assert_array_equal(a, b)
    bad = [(np.array([[1, 6, 1]]), None),          # not sorted
           (np.array([[6, 1, 1, 1]]), None),       # odd electron count
           (np.array([[16, 1, 1]]), None),         # row 3 not enabled
           (np.array([[8, 1]]), np.array([0]))]    # OH radical
    for s, c in bad:
        with pytest.raises(ValueError):
            jsysmod.validate(s, c)
        with pytest.raises(ValueError):
            tsysmod.validate(s, c)
    tsysmod.validate(np.array([[8, 1, 0]]), np.array([-1]))   # OH-


def test_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.build("AM1")
    const, tables, cfg = pt.build("AM1", device=CPU)
    assert const.device.type == "cpu" and tables["U_ss"].device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_port_imports_no_jax():
    """Every module of the port (the learned-parameter models, the
    utilities and the seqm_parameters shim among them), and
    chip_smoke.py, import neither JAX nor the JAX package nor anything
    under tools/."""
    mods = ["pyseqm_tpu_torch." + m for m in (
        "models.ml", "models.hipnn", "utils.check", "utils.checkpoint",
        "utils.io", "utils.timing", "compat", "drivers._lbfgs",
        "parallel.sharding")]
    code = ("import sys, pkgutil, importlib, pyseqm_tpu_torch, chip_smoke;"
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "pyseqm_tpu_torch.__path__, 'pyseqm_tpu_torch.')];"
            f"missing=[m for m in {mods!r} if m not in sys.modules];"
            "bad=[m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pyseqm_tpu', 'tools', 'wapply_pallas')];"
            "print(bad, missing); sys.exit(1 if bad or missing else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    # and no source line of the port or of chip_smoke.py names them
    srcs = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(os.path.join(
            REPO, "pyseqm_tpu_torch")) for f in fs if f.endswith(".py")]
    for path in srcs:
        with open(path) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]):
                    top = words[1].split(".")[0]
                    assert top not in ("jax", "jaxlib", "pyseqm_tpu",
                                       "tools"), (path, line)


@pytest.mark.parametrize("mod", ["pyseqm_tpu_torch.drivers.md",
                                 "pyseqm_tpu_torch.drivers.opt",
                                 "pyseqm_tpu_torch.ops.overlap_general"])
def test_new_modules_import_no_jax(mod):
    """The thermostats, the optimizers and the row-3 overlap import
    neither JAX nor the JAX package, and their entry points refuse to run
    on the default device without a GPU (build's CUDA default)."""
    code = (f"import sys, importlib; importlib.import_module({mod!r});"
            "bad=[m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pyseqm_tpu', 'tools')];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.build("PM3", row3=True)


def test_learned_models_default_to_cuda():
    """The learned-parameter models' entry points (load_hipnn,
    make_hipnn_callable, weights_from_numpy) run on CUDA by default and
    raise without a GPU unless device="cpu" is passed.  Their modules and
    the utilities' are held to the import isolation by
    test_port_imports_no_jax, which imports every module of the port."""
    from pyseqm_tpu_torch.models import hipnn, ml
    w, meta = hipnn.load_hipnn(device=CPU)
    assert w["seqm_p"].device.type == "cpu" and meta["method"] == "PM3"
    assert ml.weights_from_numpy({"w": np.ones(2)}, device=CPU)["w"].sum() == 2
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    for entry in (hipnn.load_hipnn, hipnn.make_hipnn_callable,
                  lambda: ml.weights_from_numpy({"w": np.ones(2)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


def _pairs(dtype, n=4096, seed=0):
    rng = np.random.RandomState(seed)
    a = (rng.randn(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(dtype)
    b = (rng.randn(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(dtype)
    return a, b


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_error_free_transforms_match_jax(dtype):
    a, b = _pairs(dtype)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    # both are exact transforms in eager arithmetic: bitwise agreement
    for jf, tf in ((jxs.two_sum, txs.two_sum), (jxs.two_prod, txs.two_prod)):
        js, je = jf(jnp.asarray(a), jnp.asarray(b))
        s, e = tf(ta, tb)
        np.testing.assert_array_equal(_np(s), np.asarray(js))
        np.testing.assert_array_equal(_np(e), np.asarray(je))
    lo = b * dtype(1e-9)
    tx = txs.TwoFloat(ta, torch.from_numpy(lo))
    jx = jxs.TwoFloat(jnp.asarray(a), jnp.asarray(lo))
    for op in (lambda u, v: u * v, lambda u, v: u / v, lambda u, v: u + v,
               lambda u, v: u - v):
        r = op(tx, tx * 0.5 + 3.0)
        jr = op(jx, jx * 0.5 + 3.0)
        # double-float results agree to ~eps^2 relative
        tol = 1e-12 if dtype == np.float32 else 1e-28
        f64 = lambda t: np.asarray(t, np.float64)  # noqa: E731
        np.testing.assert_allclose(f64(_np(r.hi)) + f64(_np(r.lo)),
                                   f64(jr.hi) + f64(jr.lo), rtol=tol, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csum_matches_jax_and_backward_is_plain_sum(dtype):
    rng = np.random.RandomState(1)
    x = (rng.randn(5, 1001) * 300.0).astype(dtype)
    jt = jax.jit(jxs.csum)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    t = txs.csum(xt)
    exact = x.astype(np.float64).sum(axis=-1)
    # both carry the exact sum to ~eps^2 relative; the hi parts agree
    np.testing.assert_array_equal(_np(t.hi), np.asarray(jt.hi))
    np.testing.assert_allclose(_np(t.hi) + _np(t.lo).astype(np.float64),
                               exact, rtol=1e-12 if dtype == np.float32
                               else 1e-15)
    g = np.random.RandomState(2).randn(5).astype(dtype)
    (gx,) = torch.autograd.grad(t.value(), xt, torch.from_numpy(g))
    np.testing.assert_array_equal(_np(gx), np.repeat(g[:, None], 1001, 1))


def test_accmath_exp_matches_jax():
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.uniform(-110.0, 95.0, 20000),
                        [-104.5, -103.0, 0.0, 88.0, 89.5]]).astype(np.float32)
    y = _np(tacc.exp(torch.from_numpy(x)))
    jy = np.asarray(jacc.exp(jnp.asarray(x)))
    # same Cody-Waite construction in f32 ops: identical to the last ulp
    # except where a platform flushes subnormals
    normal = np.abs(jy) >= np.finfo(np.float32).tiny
    np.testing.assert_array_max_ulp(y[normal], jy[normal], maxulp=1)
    # exp_tf against the exact exponential: double-float accuracy.  The JAX
    # function is held only to the f32 ulp: XLA-CPU compiles exp_tf (a
    # custom_jvp) as one fused program whose FMA contraction breaks the
    # Dekker split, leaving it ~6e-8 relative there (the port's eager ops
    # round one by one and keep ~3e-11)
    tf = tacc.exp_tf(torch.from_numpy(x))
    jtf = jacc.exp_tf(jnp.asarray(x))
    # where lo is representable (hi well above the f32 normal range floor)
    fin = np.isfinite(np.asarray(jtf.hi)) & (x > -60.0)
    v = _np(tf.hi).astype(np.float64) + _np(tf.lo)
    jv = np.asarray(jtf.hi).astype(np.float64) + np.asarray(jtf.lo)
    exact = np.exp(x.astype(np.float64))
    np.testing.assert_allclose(v[fin], exact[fin], rtol=1e-10, atol=0)
    np.testing.assert_allclose(v[fin], jv[fin], rtol=1.2e-7, atol=0)
    # d exp = exp dx, from the accurate value
    xs = torch.from_numpy(x[np.abs(x) < 80]).requires_grad_(True)
    (g,) = torch.autograd.grad(tacc.exp(xs).sum(), xs)
    np.testing.assert_array_equal(_np(g), _np(tacc.exp(xs)))
    (g2,) = torch.autograd.grad(tacc.exp_tf(xs).hi.sum(), xs)
    np.testing.assert_array_equal(_np(g2), _np(tacc.exp_tf(xs).hi))
