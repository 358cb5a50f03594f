#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero, and no result
line is printed):

1. card and software: nvidia-smi name and power limit, torch/CUDA/nvcc
   versions; TF32 off;
2. build: compile every CUDA kernel (csrc/sp2.cu, csrc/eigh.cu) from the
   sources in the checkout, one nvcc per source, started together;
3. K1 (SP2) against its plain version and the exact density (f64 eigh) on
   the card, at the main path's shape and at ragged/large sizes;
4. the XL-SP2 path at full width: 10,240 molecules x 8 atoms, AM1 float32,
   one bootstrap SCF (DIIS, SP2) then XL-BOMD (k=5, 0.4 fs) through the
   entry points build -> XLBOMD.initialize -> XLBOMD.step: steps/s, kernel
   launches, a one-step CUDA-event breakdown and the energy drift;
5. K1's time on that path's own input against its bound;
6. measurements that say where the step's time goes (not checked): kernel
   launches and device kernel time of one profiled step against the timed
   step, the step without the double-float overlap chain, and the drift of
   an f64 run of the first 256 molecules next to the f32 run's;
7. float32 accuracy of the SP2 path: energy and force of the first 256
   molecules against the port at float64;
8. K2 (one-sided Jacobi eigh) against exact (f64 eigh) and its plain
   version at n = 16, 24, 32, 128; the rescue of molecules forced
   unconverged with MAX_SWEEPS = 1;
9. the eigh SCF at full width (the JAX package's `bench.py --config
   scf-eigh`): molecules/s over 3 chained energy calls, SCF iterations,
   unconverged count, K2 launches against density solves, rescued count;
10. eig=True at full width: orbital energies and per-MO charges, the charge
    invariant, and float32 against float64 on the first 256 molecules
    (Hf, force, orbital energies);
11. XL-BOMD on eigh densities at full width: steps/s, one K2 launch per
    step, energy drift, and one profiled step (launches, device time);
12. K2's time on the eigh path's own inputs (n = 16 and 32): the kernel
    launch alone against its bound and its plain version, the whole
    wrapper against torch.linalg.eigh;
13. a JSON line of every kernel with its launches, error and times against
    its bound; then the card; the elapsed time; then the result line.

Imports torch, numpy and pyseqm_tpu_torch only.  Exits non-zero without a
CUDA device, or when the package is not next to this script.
"""
import concurrent.futures
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
NMOL, MOLSIZE, NSTEPS, WARMUP = 10240, 8, 50, 5
XL_EIGH_STEPS, SCF_REPEATS = 20, 3
DEV = "cuda"
# one H100 SXM, NVIDIA data sheet: FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67.0e12
PEAK_BYTES = 3.35e12
TOL_KERNEL = 5.0e-5         # K1 against exact / plain / idempotency
TOL_DRIFT = 0.01            # eV over the timed steps
# f32 vs f64 on 256 molecules, eV and eV/A.  The Hf bound sits at the f32
# storage floor: casting the exact f64 state to f32 already costs 6.3e-5 eV
# worst, and the JAX package's production f32 SCF measured 1.17e-4 eV
# worst on a 256-molecule batch of the same molecules (benchmarks/README.md,
# "f32 error budget"); see PERF.md.
TOL_HF, TOL_F = 1.5e-4, 1.0e-3
# K2 (times max|A|): the bounds of tests/test_kernels.py against exact, and
# the plain version, which repeats the kernel's operations
TOL_EIG_EXACT, TOL_EIG_PLAIN, TOL_ORTH = 5.0e-4, 1.0e-5, 1.0e-5
TOL_E_ORB, TOL_CHARGE = 2.0e-3, 1.0e-4     # eV; charge invariant


class PhaseError(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseError(msg)


def sync():
    torch.cuda.synchronize()


def event_ms(fn, reps):
    """Mean device time of fn() over reps calls (after one warm-up)."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sync()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / reps


def median_ms(fn, reps):
    """Median device time of one fn() call over reps calls (after one
    warm-up), each call between its own pair of CUDA events."""
    fn()
    sync()
    pairs = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    sync()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def phase_card():
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.ops import cuda_build
    pt.disable_tf32()
    nvcc = cuda_build.nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1]
    card = card_line()
    print(f"[1 card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {ver} | tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    return card


def phase_build():
    from pyseqm_tpu_torch.ops import cuda_build, eigh_kernel, sp2_kernel
    kernels = (sp2_kernel, eigh_kernel)
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(cuda_build.build, [k.SOURCE for k in kernels]))
    for k in kernels:
        k._load()
    print(f"[2 build] {', '.join(k.SOURCE + '.cu' for k in kernels)} -> "
          f"{cuda_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s",
          flush=True)


def gap_case(B, n, nocc, seed):
    """SP2 inputs from symmetric matrices with a clean gap (numpy seed)."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(B, n, n))
    ev = np.concatenate([-10.0 + 2.0 * rng.rand(B, nocc),
                         2.0 + 6.0 * rng.rand(B, n - nocc)], axis=1)
    F = np.einsum('bik,bk,bjk->bij', Q, ev, Q)
    F = 0.5 * (F + np.swapaxes(F, -1, -2))
    aii = np.diagonal(F, axis1=-2, axis2=-1)
    ri = np.abs(F).sum(-1) - np.abs(aii)
    h1, hN = (aii - ri).min(-1), (aii + ri).max(-1)
    a0 = (np.eye(n)[None] * hN[:, None, None] - F) / (hN - h1)[:, None, None]
    return (torch.tensor(a0, dtype=torch.float32, device=DEV),
            torch.full((B,), float(nocc), dtype=torch.float32, device=DEV))


def exact_density(a0, nocc):
    """2 * projector on the nocc largest eigenvalues of a0 (f64 eigh)."""
    e, v = torch.linalg.eigh(a0.double())
    n = a0.shape[-1]
    occ = (torch.arange(n, device=a0.device)[None, :]
           >= n - nocc.long()[:, None]).double()
    return 2.0 * torch.einsum('bik,bk,bjk->bij', v, occ, v)


def sp2_stats(a0, nocc, eps):
    """Kernel against plain version and exact density; returns the worst
    kernel-vs-plain difference."""
    from pyseqm_tpu_torch.ops.sp2_kernel import (sp2_purify,
                                                 sp2_purify_reference)
    P = sp2_purify(a0, nocc, eps)
    Pr = sp2_purify_reference(a0, nocc, eps)
    Px = exact_density(a0, nocc)
    sync()
    d_ex = (P.double() - Px).abs().amax(dim=(1, 2))
    half = P.double() / 2.0
    d_id = (half @ half - half).abs().amax(dim=(1, 2))
    d_tr = (torch.diagonal(P, dim1=1, dim2=2).sum(-1).double()
            - 2.0 * nocc.double()).abs()
    d_pl = (P - Pr).abs().amax(dim=(1, 2)).double()
    return P, {"exact": d_ex, "idem": d_id, "trace": d_tr, "plain": d_pl}


def fmt(d):
    q = torch.quantile(d.float(), torch.tensor([0.5, 0.99], device=d.device))
    return f"p50 {q[0].item():.2e} p99 {q[1].item():.2e} max {d.max().item():.2e}"


def phase_kernel_parity():
    worst = 0.0
    for B, n, nocc, seed in ((NMOL, 16, 5, 0), (7, 16, 5, 1),
                             (7, 32, 11, 2), (7, 128, 40, 3)):
        a0, occ = gap_case(B, n, nocc, seed)
        _, st = sp2_stats(a0, occ, 1.0e-5)
        line = " | ".join(f"{k} {fmt(v)}" for k, v in st.items())
        print(f"[3 K1 sp2 B={B} n={n}] {line}", flush=True)
        for k, lim in (("exact", TOL_KERNEL), ("idem", TOL_KERNEL),
                       ("trace", 1.0e-4), ("plain", TOL_KERNEL)):
            check(st[k].max().item() <= lim,
                  f"K1 {k} bound {lim} missed at B={B} n={n}")
        worst = max(worst, st["plain"].max().item())
    return worst


def headline_setup(nmol, dtype, scf_eps, sp2_eps, use_sp2=True):
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.scf import SCFConfig
    from pyseqm_tpu_torch.utils.molecules import make_batch
    sp, co = make_batch(NMOL, MOLSIZE, jitter=0.02)
    sp, co = sp[:nmol], co[:nmol]
    K = pt.packed_heavy_count(sp)
    const, tables, cfg = pt.build(
        "AM1", dtype=dtype, device=DEV,
        scf=SCFConfig(eps=scf_eps, converger=(2,), use_sp2=use_sp2,
                      sp2_eps=sp2_eps, max_iter=200, pack_heavy=K,
                      raise_on_forward_failure=True))
    species = torch.tensor(sp, dtype=torch.long, device=DEV)
    # both precisions see the same (f32-representable) geometry
    coords = torch.tensor(co.astype(np.float32), dtype=dtype, device=DEV)
    return const, tables, cfg, species, coords


def step_breakdown(md, species, state):
    """One XL step replayed stage by stage (the code of XLBOMD.step and
    models.xlbomd.energy_xl) with CUDA events between the stages."""
    import dataclasses
    from pyseqm_tpu_torch.drivers.md import ACC_SCALE, atom_masses
    from pyseqm_tpu_torch.models.energy import (_atom_parameters,
                                                _integral_stack,
                                                _nuclear_term, _packed_layout)
    from pyseqm_tpu_torch.ops.density import sp2
    from pyseqm_tpu_torch.ops.energy import (assemble_energies,
                                             elec_energy_isolated_atom,
                                             elec_energy_xl_tf)
    from pyseqm_tpu_torch.ops.fock import fock_packed_split
    from pyseqm_tpu_torch.system import make_system
    cfg, const, tables = md.seqm_cfg, md.const, md.tables
    names = ["driver_pre", "hcore", "fock", "sp2", "energy", "backward",
             "driver_post"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    sync()
    ev[0].record()
    dt = md.md_cfg.timestep
    mass = atom_masses(const, species)
    v = state.velocities + 0.5 * state.acc * dt
    x = state.coordinates + v * dt
    cindx = state.step % md.m
    P = md.coeff_D * state.D + torch.einsum(
        'k,knij->nij', md.coeff[cindx:cindx + md.m], state.Pt)
    ev[1].record()
    K, n_st = _packed_layout(cfg, species.shape[1])
    coords = x.detach().requires_grad_(True)
    sys_ = make_system(const, species, coords, None, cfg.pair_outer_cutoff,
                       heavy_count=K)
    p = _atom_parameters(tables, cfg.method, sys_, None, coords)
    M, w = _integral_stack(const, sys_, p, cfg, K, n_st)
    ev[2].record()
    F = fock_packed_split(sys_, P, M, w, p, K, n_st)
    ev[3].record()
    with torch.no_grad():
        D = sp2(sys_, F.detach(), cfg.scf.sp2_eps, pack_heavy=K,
                prepacked=True)
    ev[4].record()
    EnucAB, mask = _nuclear_term(const, sys_, w, cfg, p)
    Eiso = elec_energy_isolated_atom(const, sys_.species, p)
    Hf = assemble_energies(const, sys_, elec_energy_xl_tf(D, P, F, M),
                           EnucAB, Eiso, cfg.hf_flag, pair_mask=mask)[0]
    ev[5].record()
    (g,) = torch.autograd.grad(Hf.sum(), coords)
    ev[6].record()
    acc = -g / mass * ACC_SCALE
    v = v + 0.5 * acc * dt
    _ = dataclasses.replace(state, coordinates=x, velocities=v, acc=acc, D=D,
                            P=P)
    ev[7].record()
    sync()
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def phase_main_path(card):
    from pyseqm_tpu_torch.drivers.md import MDConfig
    from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
    from pyseqm_tpu_torch.ops import sp2_kernel
    const, tables, cfg, species, coords = headline_setup(
        NMOL, torch.float32, 1.0e-5, 1.0e-4)
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)

    sp2_kernel.launches = 0             # counts over the whole main path
    sync()
    t0 = time.perf_counter()
    state = md.initialize(species, coords,
                          velocities=torch.zeros_like(coords),
                          initial_force=False)
    sync()
    t_boot = time.perf_counter() - t0
    boot_solves = sp2_kernel.launches
    polish = 8                           # SCFConfig.polish_iters auto, f32
    print(f"[4 bootstrap] SCF {t_boot:.3f} s, {boot_solves - polish} DIIS "
          f"iterations + {polish} polish (K1 launches {boot_solves}), "
          f"notconverged 0 of {NMOL} (raise_on_forward_failure)", flush=True)

    for _ in range(WARMUP):
        state, obs = md.step(species, state)
    e_ref = (obs.Ek + obs.Epot).double()
    sync()
    n0 = sp2_kernel.launches
    etots = []
    t0 = time.perf_counter()
    for _ in range(NSTEPS):
        state, obs = md.step(species, state)
        etots.append(obs.Ek + obs.Epot)
    sync()
    t_steps = time.perf_counter() - t0
    n_steps_launch = sp2_kernel.launches - n0
    main_launches = sp2_kernel.launches
    per_mol = (torch.stack(etots).double() - e_ref[None]).abs().amax(dim=0)
    drift = per_mol.max().item()
    finite = bool(torch.isfinite(state.coordinates).all()
                  and torch.isfinite(torch.stack(etots)).all())
    sps = NSTEPS / t_steps
    print(f"[4 xlbomd] {NMOL} x {MOLSIZE} AM1 f32 k=5 dt=0.4: "
          f"{sps:.3f} steps/s ({1e3 * t_steps / NSTEPS:.3f} ms/step) on "
          f"{card} | K1 launches over {NSTEPS} steps {n_steps_launch} | "
          f"|Etot - Etot(warm-up end)| per molecule eV {fmt(per_mol)} | "
          f"finite {finite}", flush=True)
    check(finite, "non-finite MD state")
    check(n_steps_launch == NSTEPS, f"K1 launched {n_steps_launch} times "
          f"in {NSTEPS} steps")
    check(drift <= TOL_DRIFT, f"energy drift {drift} > {TOL_DRIFT} eV")

    bd = [step_breakdown(md, species, state) for _ in range(3)]
    parts = {k: float(np.median([b[k] for b in bd])) for k in bd[0]}
    print("[4 breakdown ms] " + " ".join(f"{k} {v:.3f}" for k, v in
                                         parts.items())
          + f" | sum {sum(parts.values()):.3f}", flush=True)
    return md, species, state, main_launches, sps, parts, per_mol


def xl_run(nmol, dtype, precise, steps):
    """(steps/s, per-molecule worst |Etot - Etot(step 5)|) of a short
    XL-BOMD run of the headline configuration (first nmol molecules)."""
    import dataclasses
    from pyseqm_tpu_torch.drivers.md import MDConfig
    from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
    f32 = dtype == torch.float32
    const, tables, cfg, species, coords = headline_setup(
        nmol, dtype, 1.0e-5 if f32 else 1.0e-10, 1.0e-4 if f32 else 1.0e-7)
    cfg = dataclasses.replace(cfg, precise_overlap=precise)
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
    state = md.initialize(species, coords,
                          velocities=torch.zeros_like(coords),
                          initial_force=False)
    for _ in range(WARMUP):
        state, obs = md.step(species, state)
    e_ref = (obs.Ek + obs.Epot).double()
    etots = []
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, obs = md.step(species, state)
        etots.append(obs.Ek + obs.Epot)
    sync()
    sps = steps / (time.perf_counter() - t0)
    return sps, (torch.stack(etots).double() - e_ref[None]).abs().amax(0)


def profile_step(md, species, state):
    """(kernel launches, device kernel ms) of one XL step under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):          # the first session pays the tracer start-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            md.step(species, state)
            sync()
    ka = prof.key_averages()
    launches = sum(e.count for e in ka if e.key.startswith("cudaLaunch"))
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return launches, dev_ms


def phase_diagnostics(md, species, state, per_mol_f32, step_ms):
    launches, dev_ms = profile_step(md, species, state)
    print(f"[6 profile, one XL step] {launches} kernel launches, device "
          f"kernel time {dev_ms:.1f} ms against {step_ms:.1f} ms per timed "
          f"step (device busy share {dev_ms / step_ms:.3f})", flush=True)
    sps_plain, _ = xl_run(NMOL, torch.float32, False, 20)
    sps_prec, _ = xl_run(NMOL, torch.float32, True, 20)
    print(f"[6 overlap chain] 20-step XL timing, same process: double-float "
          f"overlap {sps_prec:.3f} steps/s, plain-f32 overlap "
          f"{sps_plain:.3f} steps/s", flush=True)
    _, per_mol_f64 = xl_run(256, torch.float64, True, NSTEPS)
    print(f"[6 drift, first 256 molecules] f64 max {per_mol_f64.max():.3e} "
          f"eV, f32 max {per_mol_f32[:256].max():.3e} eV", flush=True)


def main_path_sp2_input(md, species, state):
    """The K1 input of the next XL step (a0 and nocc from its Fock)."""
    from pyseqm_tpu_torch.models.energy import (_atom_parameters,
                                                _integral_stack,
                                                _packed_layout)
    from pyseqm_tpu_torch.ops.density import sp2_input
    from pyseqm_tpu_torch.ops.fock import fock_packed_split
    from pyseqm_tpu_torch.system import make_system
    cfg = md.seqm_cfg
    K, n_st = _packed_layout(cfg, species.shape[1])
    with torch.no_grad():
        sys_ = make_system(md.const, species, state.coordinates, None,
                           heavy_count=K)
        p = _atom_parameters(md.tables, cfg.method, sys_, None,
                             state.coordinates)
        M, w = _integral_stack(md.const, sys_, p, cfg, K, n_st)
        F = fock_packed_split(sys_, state.P, M, w, p, K, n_st)
        a0, nocc, _ = sp2_input(sys_, F, K, prepacked=True)
    return a0, nocc, cfg.scf.sp2_eps


def phase_kernel_times(md, species, state, launches, worst_synthetic):
    from pyseqm_tpu_torch.ops.sp2_kernel import (sp2_purify,
                                                 sp2_purify_reference)
    a0, nocc, eps = main_path_sp2_input(md, species, state)
    B, n, _ = a0.shape
    P, iters = sp2_purify(a0, nocc, eps, return_iters=True)
    Pr = sp2_purify_reference(a0, nocc, eps)
    err = (P - Pr).abs().max().item()
    check(err <= TOL_KERNEL, f"K1 vs plain on the main-path input: {err}")
    ms = event_ms(lambda: sp2_purify(a0, nocc, eps), 20)
    plain_ms = event_ms(lambda: sp2_purify_reference(a0, nocc, eps), 3)
    eigh_ms = event_ms(lambda: torch.linalg.eigh(a0), 3)
    it = iters.double()
    # per iteration X^2 (2n^3) + ||X||^2 (2n^2) + update (3n^2); McWeeny
    # 2 products (4n^3) + 3n^2; bytes: a0 and nocc read, P and the
    # iteration counts written, once each
    flops = (it * (2 * n ** 3 + 5 * n ** 2)).sum().item() \
        + B * (4 * n ** 3 + 3 * n ** 2)
    nbytes = 2 * B * n * n * 4 + 2 * B * 4
    t_flop, t_byte = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"[5 K1 timing] main-path input B={B} n={n}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, torch.linalg.eigh (reference point, "
          f"not the same function) {eigh_ms:.3f} ms | iterations mean "
          f"{it.mean().item():.2f} max {int(it.max().item())} | bound "
          f"{max(t_flop, t_byte):.4f} ms (FP32 {t_flop:.4f}, bytes "
          f"{t_byte:.4f}) | kernel vs plain {err:.2e}", flush=True)
    return {"name": "sp2_purify", "route": "cuda",
            "source": "pyseqm_tpu_torch/csrc/sp2.cu",
            "replaces": "pyseqm_tpu/ops/sp2_pallas.py:124",
            "launches": launches,
            "max_abs_err": max(err, worst_synthetic),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_flop, t_byte),
            "bound_by": "operations" if t_flop >= t_byte else "bytes",
            "library_ms": None, "reference_eigh_ms": eigh_ms,
            "mean_iterations": it.mean().item(),
            "phases": ["3 parity", "4 main path", "5 timing",
                       "7 accuracy"]}


def phase_accuracy():
    import pyseqm_tpu_torch as pt
    n = 256
    runs = {}
    for dtype, eps, sp2_eps in ((torch.float32, 1.0e-5, 1.0e-4),
                                (torch.float64, 1.0e-10, 1.0e-7)):
        const, tables, cfg, species, coords = headline_setup(n, dtype, eps,
                                                             sp2_eps)
        f, out = pt.force(const, tables, cfg, species, coords)
        runs[dtype] = (f.double(), out.Hf.double())
    (f32, h32), (f64, h64) = runs[torch.float32], runs[torch.float64]
    dh = (h32 - h64).abs()
    df = (f32 - f64).abs().amax(dim=(1, 2))
    print(f"[7 accuracy f32 vs f64, {n} molecules] |dHf| eV {fmt(dh)} | "
          f"|dF| eV/A {fmt(df)}", flush=True)
    check(bool(torch.isfinite(h32).all() and torch.isfinite(f32).all()),
          "non-finite f32 results")
    check(dh.max().item() <= TOL_HF, f"f32 Hf error {dh.max().item()}")
    check(df.max().item() <= TOL_F, f"f32 force error {df.max().item()}")


class Tap:
    """Counts the calls of ``module.name`` while active and keeps the
    tensor arguments of the last call for each matrix size n (a counting
    wrapper around the package's own function)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls, self.last = 0, {}

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            self.calls += 1
            mats = [a for a in args if torch.is_tensor(a) and a.dim() == 3]
            if mats:    # detached: keep the input, not its autograd graph
                self.last[mats[0].shape[-1]] = mats[0].detach()
            return self.orig(*args, **kwargs)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def sym_case(B, n, seed, kind="dense"):
    """Symmetric f32 test matrices from a numpy seed: "dense" random (the
    class of tests/test_kernels.py), "degenerate" (its n = 24 case, an
    exact double eigenvalue), or "fock" (diagonal -20, off-diagonal
    N(0, 18), the packed-F class of tests/test_torch_sp2.py).  At n = 128
    a dense matrix's Gershgorin shift is ~30 max|A|, and e = sigma - |g|
    carries the f32 rounding of that shift, close to the 5e-4 max|A|
    bound; the Fock class keeps the shift at ~14 max|A|."""
    rng = np.random.RandomState(seed)
    if kind == "degenerate":
        Q, _ = np.linalg.qr(rng.randn(B, n, n))
        ev = np.sort(rng.randn(B, n) * 4.0, axis=-1)
        ev[:, 5] = ev[:, 4]
        A = np.einsum('bik,bk,bjk->bij', Q, ev, Q)
    elif kind == "fock":
        A = 6.0 * rng.randn(B, n, n) - 40.0 * np.eye(n)
    else:
        A = 5.0 * rng.randn(B, n, n)
    A = 0.5 * (A + np.swapaxes(A, 1, 2))
    return torch.tensor(A, dtype=torch.float32, device=DEV)


def occ_projector(v, nocc):
    vo = v[..., :nocc].double()
    return vo @ vo.transpose(1, 2)


def eigh_stats(A):
    """K2 against exact (f64 eigh) and its plain version on A; per-molecule
    errors, each relative to max|A| where it is an eigenvalue error."""
    from pyseqm_tpu_torch.ops.eigh_kernel import (eigh_jacobi,
                                                  eigh_jacobi_reference)
    e, v, resid, sweeps = eigh_jacobi(A, with_resid=True, return_sweeps=True)
    er, vr, _, sr = eigh_jacobi_reference(A, with_resid=True,
                                          return_sweeps=True)
    sync()
    Ad = A.double()
    nrm = Ad.abs().amax(dim=(1, 2)).max()
    ex = torch.linalg.eigvalsh(Ad)
    ed, vd = e.double(), v.double()
    n = A.shape[-1]
    eye = torch.eye(n, dtype=torch.float64, device=A.device)
    occ = max(n // 2, 1)
    st = {
        "exact": (ed - ex).abs().amax(-1) / nrm,
        "resid": (Ad @ vd - vd * ed[:, None, :]).abs().amax((1, 2)) / nrm,
        "orth": (vd.transpose(1, 2) @ vd - eye).abs().amax((1, 2)),
        "plain_e": (e - er).abs().amax(-1).double() / nrm,
        "plain_P": (occ_projector(v, occ)
                    - occ_projector(vr, occ)).abs().amax((1, 2)),
        "off": resid.double(),
    }
    return st, sweeps, bool(torch.equal(sweeps, sr))


def phase_k2_parity():
    from pyseqm_tpu_torch.ops import density, eigh_kernel
    worst = 0.0
    for B, n, seed, kind in ((NMOL, 16, 10, "dense"), (7, 16, 11, "dense"),
                             (NMOL, 32, 12, "dense"), (7, 32, 13, "dense"),
                             (7, 128, 17, "dense"), (7, 128, 14, "fock"),
                             (8, 24, 15, "degenerate")):
        st, sweeps, same = eigh_stats(sym_case(B, n, seed, kind))
        line = " | ".join(f"{k} {fmt(v)}" for k, v in st.items())
        print(f"[8 K2 eigh B={B} n={n} {kind}] "
              f"{line} | sweeps mean {sweeps.double().mean().item():.2f} "
              f"max {int(sweeps.max().item())}, same as plain {same}",
              flush=True)
        for k, lim in (("exact", TOL_EIG_EXACT), ("resid", TOL_EIG_EXACT),
                       ("orth", TOL_ORTH), ("plain_e", TOL_EIG_PLAIN),
                       ("plain_P", TOL_KERNEL),
                       ("off", eigh_kernel.OFF_TOL)):
            check(st[k].max().item() <= lim,
                  f"K2 {k} bound {lim} missed at B={B} n={n}")
        worst = max(worst, st["plain_e"].max().item())

    # MAX_SWEEPS = 1: the kernel must flag molecules, the rescue must give
    # them exact-class results and pass the others through unchanged (every
    # other matrix is diagonal, so one sweep converges it)
    A = sym_case(256, 32, 16)
    A[1::2] = torch.diag_embed(torch.diagonal(A[1::2], dim1=1, dim2=2))
    old = eigh_kernel.MAX_SWEEPS
    eigh_kernel.MAX_SWEEPS = 1
    try:
        e, v, resid = eigh_kernel.eigh_jacobi(A, with_resid=True)
        _, _, resid_r = eigh_kernel.eigh_jacobi_reference(A, with_resid=True)
    finally:
        eigh_kernel.MAX_SWEEPS = old
    bad = resid > eigh_kernel.OFF_TOL
    n_bad = int(bad.sum().item())
    e2, v2, flag = density.rescue_unconverged_panels(A, e, v, resid)
    Ad = A.double()
    nrm = Ad.abs().max()
    ex = torch.linalg.eigvalsh(Ad)
    d_ex = ((e2.double() - ex).abs().amax(-1) / nrm)[bad]
    d_res = ((Ad @ v2.double() - v2.double() * e2.double()[:, None, :])
             .abs().amax((1, 2)) / nrm)[bad]
    keep = ~bad
    same = bool(torch.equal(e2[keep], e[keep]) and torch.equal(v2[keep],
                                                               v[keep]))
    print(f"[8 K2 rescue, MAX_SWEEPS=1, B=256 n=32] flagged {n_bad} of 128 "
          f"dense, {int(bad[1::2].sum())} of 128 diagonal (plain version "
          f"flags {int((resid_r > eigh_kernel.OFF_TOL).sum())}) | "
          f"rescued exact {fmt(d_ex)} | eigen residual {fmt(d_res)} | "
          f"unflagged unchanged {same}", flush=True)
    check(bool(bad[::2].all()) and not bool(bad[1::2].any()),
          "MAX_SWEEPS=1 must flag exactly the dense matrices")
    check(torch.equal(flag, bad), "rescue flag differs from resid > OFF_TOL")
    check(d_ex.max().item() <= TOL_EIG_EXACT
          and d_res.max().item() <= TOL_EIG_EXACT,
          "rescued molecules are not exact-class")
    check(same, "rescue changed unflagged molecules")
    return worst


def phase_scf_eigh(card):
    """bench.py --config scf-eigh through the port: 3 chained energy calls,
    each perturbed by the last (coords + 1e-7 Hf)."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch import scf
    from pyseqm_tpu_torch.ops import density, eigh_kernel
    const, tables, cfg, species, coords = headline_setup(
        NMOL, torch.float32, 1.0e-5, 1.0e-4, use_sp2=False)
    out = pt.energy(const, tables, cfg, species, coords)     # warm-up
    sync()
    eigh_kernel.launches = 0
    density.rescued = 0
    solves, nc = [], 0
    with Tap(scf, "sym_eig") as tap, \
            Tap(density, "eigh_batched_checked") as k2_in:
        c = coords
        sync()
        t0 = time.perf_counter()
        for _ in range(SCF_REPEATS):
            n0 = tap.calls
            out = pt.energy(const, tables, cfg, species, c)
            c = c + 1.0e-7 * out.Hf[:, None, None]
            solves.append(tap.calls - n0)
            nc += int(out.notconverged.sum().item())
        sync()
        dt = time.perf_counter() - t0
    launches, rescued = eigh_kernel.launches, density.rescued
    mps = SCF_REPEATS * NMOL / dt
    polish = 8                           # SCFConfig.polish_iters auto, f32
    print(f"[9 scf-eigh] {NMOL} x {MOLSIZE} AM1 f32 eps 1e-5: {mps:.1f} "
          f"molecules/s ({dt / SCF_REPEATS:.3f} s per call) on {card} | "
          f"SCF iterations per call {[k - polish for k in solves]} + "
          f"{polish} polish | notconverged {nc} | K2 launches {launches} "
          f"for {sum(solves)} density solves | rescued {rescued}",
          flush=True)
    check(bool(torch.isfinite(out.Hf).all()), "non-finite scf-eigh Hf")
    check(nc == 0, f"{nc} scf-eigh molecules not converged")
    check(launches == sum(solves), f"K2 launched {launches} times for "
          f"{sum(solves)} density solves")
    return {"molecules_per_s": mps, "s_per_call": dt / SCF_REPEATS,
            "iterations": [k - polish for k in solves], "rescued": rescued,
            "launches": launches}, k2_in.last[16]


def phase_eig_outputs():
    """eig=True at full width; f32 against f64 on the first 256."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.ops import density, eigh_kernel
    from pyseqm_tpu_torch.system import make_system
    const, tables, cfg, species, coords = headline_setup(
        NMOL, torch.float32, 1.0e-5, 1.0e-4, use_sp2=False)
    cfg = dataclasses.replace(cfg, eig=True)
    eigh_kernel.launches = 0
    with Tap(density, "eigh_batched_checked") as k2_in:
        f, out = pt.force(const, tables, cfg, species, coords)
        sync()
    launches = eigh_kernel.launches
    A = species.shape[1]
    check(tuple(out.e.shape) == (NMOL, 4 * A)
          and tuple(out.charge.shape) == (NMOL, 4 * A, A),
          f"eig outputs e {tuple(out.e.shape)} charge "
          f"{tuple(out.charge.shape)}")
    sys_ = make_system(const, species, coords)
    occ = (torch.arange(4 * A, device=DEV)[None, :]
           < sys_.nocc[:, None]).to(out.charge.dtype)
    q_mo = 2.0 * torch.einsum('nla,nl->na', out.charge, occ)
    q_p = torch.diagonal(out.P, dim1=1, dim2=2).reshape(NMOL, A, 4).sum(-1)
    d_q = (q_mo - q_p).abs().amax(-1).double()
    nc = int(out.notconverged.sum().item())
    print(f"[10 eig=True] {NMOL} molecules: e {tuple(out.e.shape)}, charge "
          f"{tuple(out.charge.shape)} | charge invariant {fmt(d_q)} | "
          f"notconverged {nc} | K2 launches {launches}", flush=True)
    check(nc == 0, f"{nc} eig=True molecules not converged or flagged")
    check(d_q.max().item() <= TOL_CHARGE,
          f"charge invariant {d_q.max().item()}")
    check(bool(torch.isfinite(out.e).all() and torch.isfinite(f).all()),
          "non-finite eig=True outputs")

    m = 256
    c64, t64, cfg64, sp64, co64 = headline_setup(m, torch.float64, 1.0e-10,
                                                 1.0e-7, use_sp2=False)
    f64, o64 = pt.force(c64, t64, dataclasses.replace(cfg64, eig=True),
                        sp64, co64)
    dh = (out.Hf[:m].double() - o64.Hf).abs()
    df = (f[:m].double() - f64).abs().amax(dim=(1, 2))
    de = (out.e[:m].double() - o64.e).abs().amax(-1)
    print(f"[10 eig=True f32 vs f64, {m} molecules] |dHf| eV {fmt(dh)} | "
          f"|dF| eV/A {fmt(df)} | |de_orb| eV {fmt(de)}", flush=True)
    check(dh.max().item() <= TOL_HF, f"eig f32 Hf error {dh.max().item()}")
    check(df.max().item() <= TOL_F, f"eig f32 force error {df.max().item()}")
    check(de.max().item() <= TOL_E_ORB,
          f"f32 orbital energy error {de.max().item()}")
    return launches, k2_in.last[4 * A], {
        "charge_invariant_max": d_q.max().item(),
        "dHf_max": dh.max().item(), "dF_max": df.max().item(),
        "de_orb_max": de.max().item()}


def phase_xl_eigh(card):
    from pyseqm_tpu_torch.drivers.md import MDConfig
    from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
    from pyseqm_tpu_torch.ops import eigh_kernel
    const, tables, cfg, species, coords = headline_setup(
        NMOL, torch.float32, 1.0e-5, 1.0e-4, use_sp2=False)
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
    eigh_kernel.launches = 0
    state = md.initialize(species, coords,
                          velocities=torch.zeros_like(coords),
                          initial_force=False)
    for _ in range(WARMUP):
        state, obs = md.step(species, state)
    e_ref = (obs.Ek + obs.Epot).double()
    sync()
    n0 = eigh_kernel.launches
    etots = []
    t0 = time.perf_counter()
    for _ in range(XL_EIGH_STEPS):
        state, obs = md.step(species, state)
        etots.append(obs.Ek + obs.Epot)
    sync()
    dt = time.perf_counter() - t0
    n_steps = eigh_kernel.launches - n0
    launches = eigh_kernel.launches
    per_mol = (torch.stack(etots).double() - e_ref[None]).abs().amax(dim=0)
    finite = bool(torch.isfinite(state.coordinates).all()
                  and torch.isfinite(torch.stack(etots)).all())
    sps = XL_EIGH_STEPS / dt
    print(f"[11 xlbomd-eigh] {NMOL} x {MOLSIZE} AM1 f32 k=5 dt=0.4: "
          f"{sps:.3f} steps/s ({1e3 * dt / XL_EIGH_STEPS:.3f} ms/step) on "
          f"{card} | K2 launches over {XL_EIGH_STEPS} steps {n_steps} "
          f"(bootstrap + warm-up {n0}) | |Etot - Etot(warm-up end)| per "
          f"molecule eV {fmt(per_mol)} | finite {finite}", flush=True)
    check(finite, "non-finite eigh XL state")
    check(n_steps == XL_EIGH_STEPS, f"K2 launched {n_steps} times in "
          f"{XL_EIGH_STEPS} steps")
    check(per_mol.max().item() <= TOL_DRIFT,
          f"eigh XL drift {per_mol.max().item()} > {TOL_DRIFT} eV")
    n_launch, dev_ms = profile_step(md, species, state)
    print(f"[11 profile, one eigh XL step] {n_launch} kernel launches, "
          f"device kernel time {dev_ms:.1f} ms against {1e3 / sps:.1f} ms "
          f"per timed step (device busy share {dev_ms * sps / 1e3:.3f})",
          flush=True)
    return launches, {"steps_per_s": sps, "drift_max": per_mol.max().item(),
                      "launches_per_step": n_launch,
                      "device_ms_per_step": dev_ms}


def k2_timing(A, tag):
    """K2 on one path input: the kernel launch alone and its plain version
    (the sweeps, from the shifted G0), each against the kernel's bound;
    the whole eigh_jacobi wrapper (shift, padding, kernel, sort and
    normalisation) against torch.linalg.eigh, which computes the same
    function."""
    from pyseqm_tpu_torch.ops import eigh_kernel as ek
    A = A.contiguous()
    B, n0, _ = A.shape
    e, v, resid, sweeps = ek.eigh_jacobi(A, with_resid=True,
                                         return_sweeps=True)
    er, _, _ = ek.eigh_jacobi_reference(A, with_resid=True)
    sync()
    err = (e - er).abs().max().item()
    nrm = A.abs().max().item()
    check(err <= TOL_EIG_PLAIN * nrm, f"K2 vs plain on the {tag} input: "
          f"{err} (max|A| {nrm})")
    G0, _ = ek._shift_and_pad(A)
    ms = median_ms(lambda: ek._sweeps_kernel(G0, ek.OFF_TOL, ek.MAX_SWEEPS,
                                             False), 20)
    plain_ms = median_ms(lambda: ek._sweeps_reference(G0, ek.OFF_TOL,
                                                      ek.MAX_SWEEPS), 3)
    wrapper_ms = median_ms(lambda: ek.eigh_jacobi(A, with_resid=True), 20)
    lib_ms = median_ms(lambda: torch.linalg.eigh(A), 5)
    sw = sweeps.double()
    n = G0.shape[-1]
    # per sweep (n - 1) rounds of n/2 pairs.  A pair needs gamma once (n
    # FMA = 2n), both alphas (4n), both column updates (6n) and one
    # rotation (~20 scalar operations; both members of the pair compute
    # the same gamma and rotation, which counts once); then the final
    # column norms (2n^2 + n).  Bytes: G0 read, G, the norms and resid
    # written, once each
    flops = (sw.sum().item() * (n - 1) * (n // 2) * (12 * n + 20)
             + B * (2 * n * n + n))
    nbytes = 4 * B * (2 * n * n + n + 1)
    t_flop, t_byte = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(t_flop, t_byte)
    print(f"[12 K2 timing, {tag} input B={B} n={n0}] kernel {ms:.4f} ms "
          f"(median of 20, launch alone), plain {plain_ms:.3f} ms | bound "
          f"{bound:.4f} ms (FP32 {t_flop:.4f}, bytes {t_byte:.4f}), kernel "
          f"at {100 * bound / ms:.1f}% of it | wrapper {wrapper_ms:.4f} ms "
          f"against torch.linalg.eigh {lib_ms:.3f} ms | sweeps mean "
          f"{sw.mean().item():.2f} max {int(sw.max().item())} | kernel vs "
          f"plain {err:.2e} | resid max {resid.max().item():.2e}",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "wrapper_ms": wrapper_ms, "bound_ms": bound,
            "bound_by": "operations" if t_flop >= t_byte else "bytes",
            "mean_sweeps": sw.mean().item(), "max_abs_err": err}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import pyseqm_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.abspath(pyseqm_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        print(f"chip_smoke: pyseqm_tpu_torch imported from {pkg}, not from "
              "this checkout", file=sys.stderr)
        return 2
    card = phase_card()
    phase_build()
    worst = phase_kernel_parity()
    md, species, state, launches, sps, parts, per_mol = phase_main_path(card)
    check(launches > 0, "K1 was not launched on the main path")
    k1 = phase_kernel_times(md, species, state, launches, worst)
    phase_diagnostics(md, species, state, per_mol, 1e3 / sps)
    del md, state
    torch.cuda.empty_cache()
    phase_accuracy()

    worst2 = phase_k2_parity()
    scf_eigh, a16 = phase_scf_eigh(card)
    n_eig, a32, eig_acc = phase_eig_outputs()
    n_xl, xl_eigh = phase_xl_eigh(card)
    by_path = {"scf_eigh": scf_eigh["launches"], "eig_true": n_eig,
               "xlbomd_eigh": n_xl}
    for path, n in by_path.items():
        check(n > 0, f"K2 was not launched on the {path} path")
    t16, t32 = k2_timing(a16, "scf-eigh"), k2_timing(a32, "eig=True")
    k2 = {"name": "eigh_jacobi", "route": "cuda",
          "source": "pyseqm_tpu_torch/csrc/eigh.cu",
          "replaces": "pyseqm_tpu/ops/eigh_pallas.py:75",
          "launches": sum(by_path.values()),
          "max_abs_err": max(t16["max_abs_err"], t32["max_abs_err"]),
          "max_rel_err_synthetic": worst2,
          **{k: t16[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "wrapper_ms", "mean_sweeps")},
          "n32": {k: t32[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "wrapper_ms",
                                      "mean_sweeps")},
          "launches_by_path": by_path,
          "phases": ["8 parity", "9 scf-eigh", "10 eig=True",
                     "11 xlbomd-eigh", "12 timing"]}
    k1["launches_by_path"] = {"xlbomd_sp2": launches}
    print(json.dumps({"main_path": {"steps_per_s": sps,
                                    "step_breakdown_ms": parts},
                      "scf_eigh": scf_eigh, "eig_true": eig_acc,
                      "xlbomd_eigh": xl_eigh}), flush=True)
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(card_line(), flush=True)
    print(f"elapsed {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
