"""PyTorch port, data parallelism over molecules on the CPU: a two-rank gloo
group, spawned once for the module (tests/_torch_sharding_ranks.py),
runs the sharded energy, force and XL-BOMD step, a padded ragged batch
on the eigh and SP2 paths, a checkpoint restored and re-sharded, the
species checks of every wrapper and the training step; each is held to
the port's single-process result at the tolerances of
tests/test_sharding.py, the training step to the JAX package's
``make_train_step`` on a 2-device mesh.  Also, in this process: a padding
molecule is inert on the SP2 path (the JAX package's SP2 gives it
Hf = nan) and the mesh refuses a CUDA device without a GPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyseqm_tpu as pq
import pyseqm_tpu_torch as pt
from pyseqm_tpu.parallel import make_train_step as jmake_train_step
from pyseqm_tpu.parallel import molecule_mesh as jmolecule_mesh
from pyseqm_tpu.scf import SCFConfig as JSCFConfig
from pyseqm_tpu_torch.parallel import molecule_mesh, spawn_ranks
from pyseqm_tpu_torch.scf import SCFConfig
from pyseqm_tpu_torch.utils.molecules import make_batch

import _torch_sharding_ranks as ranks

torch.set_num_threads(1)
CPU = "cpu"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """What rank 0 of the two-rank gloo group saved."""
    out = str(tmp_path_factory.mktemp("ranks") / "results.pt")
    spawn_ranks(ranks.run, 2, (out, GOLDEN))
    return torch.load(out, weights_only=False)


@pytest.fixture(scope="module")
def local():
    return ranks.setup()


def test_sharded_energy_and_force_match_local(sharded, local):
    const, tables, cfg, sp, co = local
    f, out = pt.force(const, tables, cfg, sp, co)
    assert sharded["size"] == 2
    np.testing.assert_allclose(_np(sharded["Hf"]), _np(out.Hf), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(_np(sharded["force"]), _np(f), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("path", ["eigh", "sp2"])
def test_padded_batch_sharding(sharded, local, path):
    """pad_to_mesh pads 13 molecules to 14 with an empty one; the real
    molecules' energies and forces match the unpadded single-process
    ones, and the padding's are finite zeros, on the eigh and the SP2
    path."""
    const, tables, cfg, sp, co = local
    n = ranks.NPAD
    assert sharded["pad_shape"] == ((14, 6), (14, 6, 3), None, n)
    c = cfg if path == "eigh" else ranks.sp2_config(sp)
    f, out = pt.force(const, tables, c, sp[:n], co[:n])
    hf, fs = sharded[f"pad_{path}"]
    np.testing.assert_allclose(_np(hf[:n]), _np(out.Hf), rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(fs[:n]), _np(f), rtol=0, atol=1e-9)
    assert _np(hf[n:]).tolist() == [0.0] and not _np(fs[n:]).any()


def test_sharded_xlbomd_step_matches_local(sharded, local):
    """2 XL-BOMD steps with the state split over the ranks (Pt on its
    axis 1) equal 2 single-process steps."""
    const, tables, cfg, sp, co = local
    md = ranks.xl_driver(const, tables, cfg)
    st = ranks.xl_start(md, sp, co)
    for _ in range(2):
        st, _ = md.step(sp, st)
    xl = sharded["xl2"]
    np.testing.assert_allclose(_np(xl.coordinates), _np(st.coordinates),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(_np(xl.P), _np(st.P), rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(xl.Pt), _np(st.Pt), rtol=0, atol=1e-9)
    assert xl.step == st.step == 2


def test_sharded_checkpoint_resume_exact(sharded):
    """The gathered state written after 3 steps, restored and re-sharded,
    runs 2 more steps bit for bit as the live sharded state does."""
    ref, resumed = sharded["ckpt"]
    for f in ("coordinates", "velocities", "acc", "D", "P", "Pt", "E0"):
        assert torch.equal(getattr(ref, f), getattr(resumed, f)), f
    assert ref.step == resumed.step == 5


def test_wrappers_check_species(sharded):
    """Every sharded wrapper checks its block's species on the host: a
    block out of the descending-Z order raises in each."""
    assert [name for name, _ in sharded["raised"]] == [
        "energy", "force", "xl", "train"]


def test_train_step_matches_jax(sharded, golden):
    """One data-parallel training step (U_ss offsets, backward mode 1,
    lr 2e-3) on the ch2o/h2o pair, one molecule a rank, against the JAX
    package's on a 2-device mesh: the loss to 1e-9 relative; the update
    to 1e-9 relative once the JAX one is divided by the mesh size.  The
    JAX step's gradient is the sum over devices, not the mean its
    docstring promises (shard_map's transpose of the replicated deltas
    sums their cotangents before the pmean): its update grows with the
    device count, and on one device equals the port's on any number of
    ranks.  The port averages."""
    g = golden("am1_ch2o_h2o")
    scf = dict(eps=1.0e-10, converger=(1,), backward=1, backward_eps=1.0e-6)
    cfg = pq.SEQMConfig(method="AM1", scf=JSCFConfig(**scf))
    const = pq.make_constants(dtype=jnp.float64)
    tables = pq.load_element_tables("AM1", dtype=jnp.float64)
    step = jmake_train_step(const, tables, cfg,
                            jmolecule_mesh(jax.devices()[:2]),
                            param_names=("U_ss",), lr=ranks.TRAIN_LR)
    deltas, loss = step({"U_ss": jnp.zeros_like(tables["U_ss"])},
                        jnp.asarray(g["species"], jnp.int32),
                        jnp.asarray(g["coordinates"]),
                        jnp.asarray(g["Hf"]) + ranks.TRAIN_SHIFT)
    tdeltas, tloss = sharded["train"]
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-9)
    moved = np.asarray(deltas["U_ss"]) / 2
    assert np.abs(moved).max() > 0
    np.testing.assert_allclose(_np(tdeltas["U_ss"]), moved, rtol=1e-9,
                               atol=1e-9 * np.abs(moved).max())


def test_training_loss_masks_nonconverged(sharded):
    """Targets equal to the model give no loss (test_ml_hooks.py's
    masking case on the port), and molecules whose SCF failed (stopped
    after 2 iterations) are masked out: no loss, no update."""
    assert float(sharded["train_exact"]) < 1e-10
    deltas, loss = sharded["train_masked"]
    assert float(loss) == 0.0 and not deltas["U_ss"].any()


def _padded(nmol, molsize):
    sp, co = make_batch(nmol, molsize)
    return (np.concatenate([sp, np.zeros((1, molsize), sp.dtype)]),
            np.concatenate([co, np.zeros((1, molsize, 3))]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sp2_padding_molecule_is_inert(dtype):
    """An empty molecule (species 0, what pad_to_mesh appends) on the SP2
    paths (packed and unpacked, with and without Gelfand bounds): P = 0,
    Hf = 0 and zero forces, the real molecules bit for bit as without it
    (the JAX package's SP2 gives it Hf = nan, its a0 0/0); and 3 packed
    XL-SP2 steps with it keep every field and observable finite (its
    temperature 0, where the JAX package divides 0 by 0) and its density
    zero."""
    sp, co = _padded(4, 8)
    co = torch.tensor(co, dtype=dtype)
    K = pt.packed_heavy_count(sp)
    for kw in (dict(pack_heavy=K), dict(), dict(sp2_tight_bounds=True)):
        const, tables, cfg = pt.build("AM1", dtype=dtype, device=CPU,
                                      scf=SCFConfig(converger=(2,),
                                                    use_sp2=True, **kw))
        f, out = pt.force(const, tables, cfg, sp, co)
        f4, out4 = pt.force(const, tables, cfg, sp[:4], co[:4])
        assert torch.equal(out.Hf[:4], out4.Hf) and torch.equal(f[:4], f4)
        assert out.Hf[4].item() == 0.0 and not f[4].any()
        assert not out.P[4].any() and not out.notconverged.any()
    md = ranks.xl_driver(const, tables, pt.SEQMConfig(
        method="AM1", scf=SCFConfig(converger=(2,), use_sp2=True,
                                    pack_heavy=K)))
    st = md.initialize(sp, co, velocities=torch.zeros_like(co))
    for _ in range(3):
        st, obs = md.step(sp, st)
    for name in ("coordinates", "velocities", "acc", "D", "P", "Pt", "E0"):
        assert bool(torch.isfinite(getattr(st, name)).all()), name
    assert all(bool(torch.isfinite(o).all()) for o in obs)
    assert obs.T[4].item() == 0.0
    assert not st.P[4].any() and not st.D[4].any()


def test_mesh_refuses_cuda_without_gpu():
    """The default device is cuda:<LOCAL_RANK> with NCCL; without a GPU
    molecule_mesh raises instead of falling back to the CPU or gloo."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        molecule_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        molecule_mesh(devices=["cuda:0"])
