#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero, and no result
line is printed):

1. card and software: nvidia-smi name and power limit, torch/CUDA/nvcc
   versions; TF32 off;
2. build: compile every CUDA kernel (csrc/sp2.cu, csrc/eigh.cu,
   csrc/wapply.cu, csrc/overlap.cu) from the sources in the checkout, one
   nvcc per source, started together, and print ptxas's registers and
   spills per kernel (K3: one line per instantiation; the float32 ones
   must not spill); then: eigh_jacobi, sp2_purify, the K3 forward and
   backward (each perm) and the overlap kernel (each segment mode, on
   expanded inputs) on CUDA are one device kernel per call (a captured
   CUDA graph), and the device-only timer against torch.profiler's kernel
   time on a K3 forward;
3. K1 (SP2) against its plain version and the exact density (f64 eigh) on
   the card, at the main path's shape and at n = 8, 12, 16, 24, 32
   (the warp kernel) and 128 (the block kernel);
13. K3 (the fused two-electron apply, forward and backward) against its
    plain version at every path's cell count, a ragged count, an
    expanded X and operands that are views at an odd cell or element
    offset (not 16-byte aligned: the kernels' plain-load path), three
    perms, float32 and float64; then its second derivative: double
    backward through WApply / WApplyBwd against double backward through
    the plain version at 40,960 cells and on an expanded X, and one
    WApplyBwd forward is one K3 backward launch;
4. the XL-SP2 path at full width: 10,240 molecules x 8 atoms, AM1 float32,
   one bootstrap SCF (DIIS, SP2) then XL-BOMD (k=5, 0.4 fs) through the
   entry points build -> XLBOMD.initialize -> XLBOMD.step: steps/s, kernel
   launches (three overlap kernel launches per step, one per pair
   segment), device ms per program span of three profiled steps (the
   port's own span record, read as portbench/pbench/spans.py reads it;
   at least 99% of the device time charged to a span) and the energy
   drift;
5. K1's time on that path's own input against its bound (device time
   alone, ``device_ms``);
6. measurements that say where the step's time goes (not checked): kernel
   launches and device kernel time of one profiled step against the timed
   step, the step with the plain float32 overlap chain instead of the
   double-float one (the overlap kernel), and the drift of an f64 run of
   the first 256 molecules next to the f32 run's;
18. the overlap kernel on the inputs of one Hcore build of each XL
    configuration of the benchmark at its batch (655,360 small organics,
    40,960 nonanes), per pair segment: against the double-float chain
    (within 1 float32 ulp where that chain is itself) and the float64
    chain (3e-7), and its time alone against its bound (the distinct
    bytes of the inputs its mode reads and the outputs at 3.35 TB/s, or
    FP64 operations at 34 TFLOP/s, the larger) and the chain's time;
7. float32 accuracy of the SP2 path: energy and force of the first 256
   molecules against the port at float64;
8. K2 (one-sided Jacobi eigh) against exact (f64 eigh) and its plain
   version (equal sweeps; differing elements counted) at n = 2, 4, 8,
   16, 24, 32 (the warp kernel) and 128 (the block kernel), with
   diagonal and dense matrices alternating; the rescue of molecules
   forced unconverged with MAX_SWEEPS = 1;
9. the eigh SCF at full width (the JAX package's `bench.py --config
   scf-eigh`): molecules/s over 3 chained energy calls, SCF iterations,
   unconverged count, K2 launches against density solves, rescued count;
10. eig=True at full width: orbital energies and per-MO charges, the charge
    invariant, and float32 against float64 on the first 256 molecules
    (Hf, force, orbital energies);
11. XL-BOMD on eigh densities at full width: steps/s, one K2 launch per
    step, energy drift, and one profiled step (launches, device time);
12. K2's time on the eigh path's own inputs (n = 16 and 32): eigh_jacobi
    is one launch (phase 2); its device time alone against its bound and
    its plain version, the whole call with host time against
    torch.linalg.eigh;
14. the default layout at full width (no pack_heavy: flat pairs, the
    block-grid Fock, K2 at n = 32 on the orbital permutation):
    molecules/s over 3 chained energy calls, float32 against float64 on
    the first 256 molecules, and against the packed layout's Hf;
15. the 884-atom nanostar as `bench.py --config nanostar` runs it (the
    class-segmented grid, K3 on the 294^2 heavy sub-grid, SP2 at n = 1792
    with Gelfand bounds): one energy, then 25 chained packed force_xl
    steps: steps/s, SP2 iterations, peak memory;
16. the nanostar on the dense grid with the default layout (hcore_dense,
    K3 on 884^2 cells, eigh at pack_orbitals = 1792): one force call, and
    both nanostar runs held to each other and to a float64 dense run;
17. K3's time on each path's own inputs (device time alone, forward and
    backward, L2-warm and cold after a 256 MiB write, beside the
    host-inclusive reading and the timer's floor, an empty launch) against
    its bound and its plain version;
19. the SCF adjoint (backward mode 1) at full width: the headline batch,
    AM1 float32, eigh SCF on the static packed layout, per-atom learned
    U_ss and zeta_s; energy and one backward to them and the coordinates:
    molecules/s (median of 3 after a warm-up), adjoint iterations,
    molecules masked as backward failures, K2 and K3 launches; float32
    against float64 on the first 256 molecules; then the same in the
    default flat layout;
20. Hessians through the unrolled SCF (backward mode 2, converger 1, 30
    iterations) of 1,024 headline molecules: the full 24x24 coordinate
    Hessian per molecule by double backward, float64 (K3 float64, K3's
    second derivative) and float32 (K2, K3 float32, the double-float
    overlap's second derivative); float64 symmetry, the float64 kernel
    path against the same Hessian with the plain apply, float32 against
    float64; K3 forward and backward launches;
21. the class-segmented flat pair list (pack_pairs, dense_pair_grid
    False) at full width, the scf-eigh configuration: molecules/s over 3
    chained energy calls, K3 launches on the XX slice; Hf and forces
    against the packed dense grid on 256 molecules at float64;
22. the three SCF convergers on 256 headline molecules at float64 reach
    one Hf;
24. bomd (`bench.py --config bomd`): Langevin NVT (dt 0.4 fs, damp 20 fs,
    300 K) at full width, the SCF from the last density every step (SP2,
    eps 1e-4, packed): steps/s, SCF iterations and K1/K3 launches per step,
    and the random force of one step over its per-atom scale, mean 0 and
    variance 1 within 1% over every real component;
25. nvt: Langevin (damp 10 fs, dt 0.5) and Nose-Hoover (tau 10 fs, dt 0.4)
    at 300 K on the headline batch, 5 damping times of equilibration (the
    Nose-Hoover run starts from the Langevin run's end), then the ensemble
    mean T within 15 K of 300 K and its per-molecule spread, Nose-Hoover's
    over one period of its chain's oscillation;
26. opt and opt-conv (`bench.py --config opt`, `opt-conv`): the warm
    batched L-BFGS (chunk 10, force_tol 1e-3) on 2,048 molecules (jitter
    0.05) for its first 20 iterations: molecule-iterations/s, the
    molecules converged by then per second, molecules frozen by forced
    accepts; no molecule's Hf rises;
27. opt-sd (`bench.py --config opt-sd`): chunked steepest descent, 60
    force evaluations on the opt batch: molecule-evaluations/s;
28. scf-row3 (`bench.py --config scf-row3`): the headline batch with 25%
    H2S and CH3SH, AM1 f32 with row3, SP2 at eps 1e-5, packed:
    molecules/s over 3 chained energy calls, float32 against float64 on
    256 molecules, and the launches of one row-3 Hcore build beside a
    row-1/2 one;
29. the row-3 pin at float64 on the card: PM3 H2S at Stewart's published
    geometry (Hf -0.913 kcal/mol, a stationary point), and the warm L-BFGS
    from 1.42 A / 99 deg to it (1.2903 A, 93.51 deg); MNDO and AM1 into
    tests/test_row3.py's windows;
30. xlbomd-ml-trained (`bench.py --config xlbomd-ml-trained`): PM3 with
    the reference's trained HIP-NN model predicting nine parameters of
    every atom inside each XL-BOMD force at full width: bootstrap SCF, 5
    warm-up and 20 timed steps, steps/s, launches and device time of one
    profiled step, drift; then float32 against float64 on 256 molecules:
    the parameters, the float32 network in the float64 force, the whole
    path;
31. xlbomd-ml (`bench.py --config xlbomd-ml`): AM1 with the random-init
    parameter network of models/ml.py: bench.py's learned-vs-table check,
    then the same XL run;
32. ml-hooks: Kbeta and g_ss_nuc on 1,024 molecules on the packed
    class-segmented grid (SP2) and the default flat layout (eigh): the
    identities, a random Kbeta at float32 against float64, energy_xl's
    Enuc against energy()'s;
33. ml-grad: the gradient of a loss to every HIP-NN weight through the
    SCF adjoint on 1,024 molecules, float32 against float64;
34. resume: 10 steps straight against 5, a checkpoint, a fresh driver and
    5 more, bit for bit, on the headline XL-SP2 path and the Langevin
    bomd path (with the generator's state); run(thermo=2, dump=3)'s xyz
    frames and a Timing;
35. lbfgs-optax (`bench.py --config opt`'s default route, the JAX
    package's optax L-BFGS): the zoom host loop on the opt batch, its
    first 10 outer iterations: molecule-iterations/s, value evaluations
    per iteration, line-search failures, K1-K3 launches; sum(Hf) falls
    and no accepted step raises it past the approximate-Wolfe slack;
    then the backtracking and none routes and the chunked route (zoom,
    chunk 5) for 5 iterations on 256 molecules, and 8 molecules at
    float64 for 5 zoom iterations on the card against the same call on
    the CPU;
36. sharded (`parallel/`): an NCCL group of one on the card runs the
    sharded XL-SP2 step on the headline batch (steps/s beside phase 4's),
    the sharded force and 3 data-parallel training steps (1,024
    molecules, eigh, backward 1; its all_reduce calls); then two ranks
    over gloo with CUDA tensors on the same card (NCCL refuses two ranks
    on one device) on 1,023 molecules padded to 1,024: their XL state
    after 5 steps, gathered, bit for bit against one process's run of
    each rank's block and within float32 rounding of its run of the whole
    batch, and the padding finite;
23. a JSON line of every kernel with its launches, error and times against
    its bound (the overlap kernel's times on xl-small's H-H segment, every
    segment's beside them); then the card; the elapsed time; then the
    result line.

Every phase prints its elapsed time.  A kernel "alone" is timed by
``device_ms``: a spin kernel queued ahead of each call keeps the card busy
while the host enqueues the call, so the CUDA events around it read device
time only.

Imports torch, numpy and pyseqm_tpu_torch only.  Exits non-zero without a
CUDA device, or when the package is not next to this script.
"""
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

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
PEAK_FP64 = 34.0e12
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
# K3 against its plain version: the bounds of the TPU kernel's own check
# (tools/wapply_pallas.py check(): 3e-6 of the largest value, cotangents
# at least 3e-6), and rounding in float64
TOL_K3 = {torch.float32: 3.0e-6, torch.float64: 1.0e-12}
K3_PERMS = ((1, 2, 3, 4), (3, 4, 1, 2), (1, 3, 2, 4))
# the overlap kernel (phase 18): the benchmark's XL configurations at
# their batches; FP64 operations per cell of each class as csrc/overlap.cu
# evaluates it in the exact B regime (each add, multiply, divide, negate
# and exp one): 44 per A/B pair, then the brackets and the final product.
# A cell of no class (padding, row 3) only reads and writes
OVERLAP_CASES = (("xl-small", 655360), ("xl-nonane", 40960))
OVERLAP_OPS = {"jcall2": 44 + 4, "jcall3": 2 * 44 + 8 + 8,
               "jcall4": 4 * 44 + 7 + 12 + 12 + 6 + 10}
# cells of one apply on each path, and a count that is no multiple of the
# kernels' blocks
K3_CELLS = {"headline packed XX": NMOL * 2 * 2, "nanostar packed XX": 294 ** 2,
            "flat default": NMOL * 28, "nanostar dense grid": 884 ** 2,
            "ragged": 1001}
# per cell: floats read and written, and floating-point operations
# (csrc/wapply.cu: rotations 240, table 144 forward; 2 rotations in, the
# table passes 432, dX 120, dU 468 backward).  The values the function
# needs; the kernels move U whole (70 read forward, 70 read and 54
# written backward), which this yardstick leaves out, as PR 4's did
K3_IO = {"fwd": (47, 16, 384), "bwd": (63, 47, 1260)}
FLUSH_BYTES = 256 * 2 ** 20     # written before each cold K3 call
NANO_CARBONS, NANO_STEPS = 294, 25
# The nanostar runs against the float64 dense run.  Hf: the float32 error
# grows with the molecule; both configurations run on the CPU against
# float64 on smaller alkanes read |dHf| 5.4e-4 / 7.7e-4 eV at 65 atoms and
# 2.4e-3 / 2.4e-4 eV at 182 atoms (dense eigh / packed SP2), which is
# ~1.2e-2 eV at 884 atoms if the error grows linearly with the atoms; the
# packed run stops on |dE| < 1e-3 eV (SCF eps) and SP2's trace criterion
# at the float32 floor 3e-4.  Bound 0.05 eV, 4x that.  Forces: 1.2e-4 /
# 1.4e-4 eV/A at both sizes, independent of size (a local quantity);
# twice the headline bound (1e-3) for the packed run's 10x looser SCF eps.
# The two float32 runs are held to each other at the same bounds.
TOL_HF_NANO, TOL_F_NANO = 0.05, 2.0e-3
# the SCF adjoint (phase 19): repetitions timed after a warm-up, and float32
# against float64 on the first 256 molecules.  dHf/dR is the force of
# phase 7 (the adjoint adds nothing to a variational Hf) and sits at the
# float32 storage floor there; dHf/dU_ss is an s population (<= 2) and
# dHf/dzeta_s (eV bohr) scales with |dHf/dR|.  This phase read 1.5e-5,
# 4.7e-4 and 6.1e-4 (packed; flat 1.5e-5, 4.8e-4, 6.7e-4) on an H100 80GB
# HBM3 at 700 W; bounds about 13x, 4x and 3x those
ADJ_REPS = 3
TOL_G_USS, TOL_G_ZETA, TOL_G_R = 2.0e-4, 2.0e-3, 2.0e-3
# Hessians (phase 20): molecules, unrolled iterations.  Bounds relative to
# max |H|: symmetry at float64 as tests/test_second_order.py asks; the
# kernels against the plain apply at float64 (rounding of a 30-iteration
# double backward); float32 against float64 per molecule (relative to that
# molecule's max |H|), its 99th percentile and its largest.  A second
# derivative of eigh carries 1/(e_i - e_j) between occupied levels, which
# cancels in exact arithmetic and leaves float32 rounding over the gap:
# the jittered CH4 molecules, whose t2 levels split by meV, read the
# largest errors (the phase prints the worst molecules and their gaps).
# On an H100 80GB HBM3 at 700 W it read p99 1.8e-3 and worst 3.8e-2;
# bounds p99 5e-3 and worst 0.1
HESS_NMOL, HESS_ITERS = 1024, 30
TOL_HESS_SYM, TOL_HESS_KERNEL = 1.0e-8, 1.0e-10
TOL_HESS_F32_P99, TOL_HESS_F32_MAX = 5.0e-3, 0.1
# the split flat pair list against the packed dense grid at float64 (eV,
# eV/A), and the three convergers' common Hf (tests/test_aux.py)
TOL_SPLIT_HF, TOL_SPLIT_F, TOL_CONV = 1.0e-8, 1.0e-7, 1.0e-8
# bomd (phase 24): steps after a warm-up; nvt (25): molecules and sampled
# steps after 5 damping times; opt and opt-sd (26, 27): molecules (the
# bench's opt batch).  Bounds: the nvt ensemble mean T against 300 K, and
# the largest rise of a molecule's Hf over the L-BFGS run at float32
BOMD_WARMUP, BOMD_STEPS = 2, 8
# Nose-Hoover samples one period of its chain's oscillation, 2 pi tau /
# sqrt(2) = 44.4 fs at tau 10 fs (111 steps of 0.4 fs): every molecule's
# chain starts at rest, so the ensemble mean T swings by ~25 K at that
# period (phase 25's docstring)
NVT_NMOL, NVT_SAMPLE, NH_SAMPLE = NMOL, 40, 111
OPT_NMOL = 2048
# the L-BFGS runs its first OPT_ITERS iterations: run to every molecule
# done (106 iterations) it took 272-446 s of this script's time limit on
# a host-bound H100 step, 60 iterations 199-270 s, 40 iterations 118-318 s
OPT_ITERS = 20
# the optax-routed L-BFGS (phase 35): outer iterations of the zoom host
# loop on the opt batch; molecules and iterations of the other routes;
# molecules of the float64 card-against-CPU check and its bound (A)
OPTAX_ITERS, OPTAX_SMALL_NMOL, OPTAX_SMALL_ITERS = 10, 256, 5
OPTAX_F64_NMOL, TOL_OPTAX_F64 = 8, 1.0e-8
# sharded (phase 36): timed XL steps of the NCCL group of one; molecules
# and steps of its training step; molecules (real) and steps of the two
# gloo ranks on one card.  Their gathered state equals one process's run
# of the same blocks bit for bit (the packed path is reproducible for a
# given batch).  One process's run of the whole batch (another batch
# size: cuBLAS may pick other kernels for the batched products) differs
# by float32 rounding carried through 5 XL steps, where SP2 amplifies
# it: on an H100 80GB HBM3 at 700 W up to 9.1e-5 of the largest |acc|,
# 2.5e-7 in the coordinates, 8.9e-7 in the densities, 0 in E0 (1.4e-4 of
# |acc| with 1,021 molecules on another host).  Bound: 1e-3 of each
# field's largest value, the scale of the float32 force budget (TOL_F,
# 1e-3 eV/A, on forces of ~1-10 eV/A); a molecule in the wrong rank or
# slot would differ by O(1)
SHARD_STEPS, SHARD_TRAIN_NMOL, SHARD_TRAIN_STEPS = 10, 1024, 3
SHARD_REAL, SHARD_RANKS, SHARD_GLOO_STEPS = 1023, 2, 5
TOL_SHARD_REL = 1.0e-3
TOL_NVT_T, TOL_OPT_RISE = 15.0, 1.0e-5
# the learned-parameter paths (phases 30-34): timed XL steps after WARMUP;
# molecules of the hook and weight-gradient phases; steps of the resume
# check.  Bounds, from float32 against float64 on the CPU (256 headline
# molecules, PM3): the HIP-NN parameters read 8.2e-8 of each parameter's
# largest value, bound 1e-6; the float32 network inside the float64 force
# read 8.5e-6 eV and 3.5e-5 eV/A, held to the headline bounds TOL_HF and
# TOL_F; the whole float32 PM3 path with the network read 1.58e-4 eV and
# 5.8e-3 eV/A, and without it (the PM3 table) 1.1e-4 eV and 3.8e-3 eV/A
# (a CH2O, in its electronic gradient; AM1 reads 6.6e-4 eV/A there), so
# the whole path is held to about twice its reading, TOL_HF_PM3 and
# TOL_F_PM3.  The weight gradient read 7.5e-5 of each tensor's largest
# value at worst, bound 1e-3.  The XL energy drift of the trained-model
# path (PM3 + HIP-NN, dt 0.4 fs) read 2.87e-2 eV on the CPU over 2,048
# headline molecules at float32 (a water; p99 1.7e-2) and the same at
# float64 (2.87e-2 over 256 molecules, each molecule's float32 drift
# within 3.0e-4 eV of its float64 drift); the float64 Born-Oppenheimer
# dynamics of that water read 2.0e-2 eV at 0.4 fs and 4.5e-3 at 0.2 fs:
# the Verlet error (dt^2) of the model's surface, not float32 and not the
# XL integrator.  So that path is held to TOL_DRIFT_HIPNN absolutely and
# to TOL_DRIFT_F32 against its own float64 drift
TOL_DRIFT_HIPNN, TOL_DRIFT_F32 = 0.05, 3.0e-3
ML_STEPS, ML_HOOK_NMOL, RESUME_STEPS = 20, 1024, 10
TOL_ML_PARAM, TOL_ML_GRAD = 1.0e-6, 1.0e-3
TOL_HF_PM3, TOL_F_PM3 = 3.0e-4, 1.2e-2
TOL_ENUC = TOL_HF


class PhaseError(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise PhaseError(msg)


def sync():
    torch.cuda.synchronize()


def median_ms(fn, reps):
    """Median time of one fn() call over reps calls (after one warm-up),
    each call between its own pair of CUDA events with nothing queued
    ahead: the host's time to enqueue the call falls between the events
    too (the reading for a whole wrapper)."""
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


_CYCLES_PER_MS = []


def cycles_per_ms():
    """GPU clock cycles per ms of torch.cuda._sleep, measured once."""
    if not _CYCLES_PER_MS:
        cycles = 2_000_000
        torch.cuda._sleep(cycles // 10)             # warm-up
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(cycles)
        stop.record()
        sync()
        _CYCLES_PER_MS.append(cycles / start.elapsed_time(stop))
    return _CYCLES_PER_MS[0]


def device_ms(fn, reps, before=None):
    """Median device time of one fn() call over reps calls (after one
    warm-up).  Before each call the stream gets a spin kernel
    (torch.cuda._sleep) that outlasts twice the host's time to enqueue fn()
    plus 0.2 ms, then start.record(); fn(); stop.record(): fn()'s launches
    are queued before the start event fires, so the events read the
    device alone, not the wrapper's host time.  Inputs stay in L2 between
    calls where they fit, unless ``before`` (queued ahead of the spin
    kernel, outside the events) evicts them."""
    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    sync()
    cycles = int((2.0 * host_ms + 0.2) * cycles_per_ms())
    pairs = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if before is not None:
            before()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    sync()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def profiler_kernel_ms(fn, reps):
    """(device kernel ms per fn() call, the device kernels' names) under
    torch.profiler over reps calls (after one warm-up): the sum of the
    device kernels' durations, and one name per launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.device_time_total for e in kern) / 1e3 / reps,
            [e.name for e in kern])


# a node's declaration starts a line; an edge's target follows "->"
_GRAPH_NODE = re.compile(r'^"graph_\d+_node_\d+"\s*\[', re.M)


def graph_nodes(fn):
    """The device work one fn() call enqueues (after one warm-up), read
    from a CUDA graph captured around the call: one text per graph node
    (a kernel, memset, copy ...), its part of cudaGraphDebugDotPrint's
    verbose dump, which names the node's type and a kernel's function.
    Unlike a torch.profiler session it cannot miss a launch: an op that
    enqueues device work on the stream becomes a node."""
    fn()
    sync()
    g = torch.cuda.CUDAGraph(keep_graph=True)   # kept for the dump
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        fn()
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="DEBUG: calling")
        path = os.path.join(tmp, "graph.dot")
        g.debug_dump(path)
        with open(path) as f:
            text = f.read()
    g.reset()
    starts = [m.start() for m in _GRAPH_NODE.finditer(text)]
    return [text[a:b] for a, b in zip(starts, starts[1:] + [len(text)])]


def check_one_kernel(fn, name, what):
    nodes = graph_nodes(fn)
    check(len(nodes) == 1 and "KERNEL" in nodes[0] and name in nodes[0],
          f"{what} enqueued {len(nodes)} device operations, expected one "
          f"{name} kernel: {[n[:160] for n in nodes]}")


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
    from pyseqm_tpu_torch.ops import (cuda_build, eigh_kernel,
                                      overlap_kernel, sp2_kernel,
                                      wapply_kernel)
    kernels = (sp2_kernel, eigh_kernel, wapply_kernel, overlap_kernel)
    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(cuda_build.build, [k.SOURCE for k in kernels]))
    sp2_kernel._load()
    eigh_kernel._load()
    wapply_kernel._load_all()
    overlap_kernel._load()
    print(f"[2 build] {', '.join(k.SOURCE + '.cu' for k in kernels)} -> "
          f"{cuda_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    reports = {}
    for k in (sp2_kernel, eigh_kernel, overlap_kernel):
        reports[k.SOURCE] = [
            ln.strip() for ln in cuda_build.ptxas_report(k.SOURCE).splitlines()
            if "Compiling entry" in ln or "Used" in ln or "spill" in ln
            or "stack frame" in ln]
        print(f"[2 ptxas {k.SOURCE}.cu] " + " | ".join(reports[k.SOURCE]),
              flush=True)
    k3 = k3_ptxas(cuda_build.ptxas_report(wapply_kernel.SOURCE))
    for name, e in k3.items():
        print(f"[2 ptxas wapply.cu {name}] {e['registers']} registers, "
              f"{e['spill_stores']} bytes spill stores, {e['spill_loads']} "
              f"bytes spill loads, {e['stack']} bytes stack, {e['smem']} "
              f"bytes smem", flush=True)
    check(len(k3) == 2 * 2 * len(K3_PERMS), f"K3 instantiations in the "
          f"ptxas report: {sorted(k3)}")
    spills = [n for n, e in k3.items() if "f32" in n
              and (e["spill_stores"] or e["spill_loads"] or e["stack"])]
    check(not spills, f"K3 float32 kernels spill or use a stack: {spills}")
    reports[wapply_kernel.SOURCE] = k3
    return reports


# a K3 kernel's mangled name: wapply_<kind> on <f|d> and the perm
_K3_ENTRY = re.compile(
    r"wapply_(fwd|bwd)I([fd])Li(\d)ELi(\d)ELi(\d)ELi(\d)E")


def k3_ptxas(report):
    """ptxas's numbers for each K3 instantiation in a -Xptxas -v report,
    keyed '<fwd|bwd> <f32|f64> (p0, p1, p2, p3)'."""
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", ln.strip())
        if m:
            k = _K3_ENTRY.search(m.group(1))
            name = (f"{k.group(1)} {'f32' if k.group(2) == 'f' else 'f64'} "
                    f"({', '.join(k.group(3, 4, 5, 6))})") if k else None
            if name:
                out.setdefault(name, {"registers": None, "spill_stores": None,
                                      "spill_loads": None, "stack": None,
                                      "smem": 0})
            continue
        if name is None:
            continue
        e = out[name]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            e["stack"], e["spill_stores"], e["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            e["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            e["smem"] = int(m.group(1)) if m else 0
    return out


def phase_profiler():
    """eigh_jacobi and sp2_purify on CUDA tensors are one device kernel
    each, at every kernel variant, and so are the K3 forward and backward
    at each perm and the overlap kernel at each segment mode (read from a
    captured CUDA graph); the
    device-only timer read against torch.profiler's kernel time, and
    against median_ms, on a K3 forward at the headline's cell count.  A
    torch.profiler session can lose a ctypes launch's device events (a
    lone K2 call after the XL runs in one run, a lone K1 call in another;
    PERF.md), so the profiler reads only the timer's cross-check, from
    the first of up to three sessions that recorded every launch."""
    from pyseqm_tpu_torch.ops import eigh_kernel as ek, sp2_kernel as sk
    from pyseqm_tpu_torch.ops import overlap_kernel as ok_
    from pyseqm_tpu_torch.ops import wapply_kernel as wk
    for n in (2, 16, 24, 32, 128):
        A = sym_case(64, n, 30 + n)
        check_one_kernel(lambda: ek.eigh_jacobi(A, True), "eigh",
                         f"eigh_jacobi at n={n}")
    for n in (12, 16, 24, 32, 128):
        a0, occ = gap_case(64, n, n // 3, 40 + n)
        check_one_kernel(lambda: sk.sp2_purify(a0, occ), "sp2",
                         f"sp2_purify at n={n}")
    print("[2 one launch] eigh_jacobi (n = 2, 16, 24, 32, 128) and "
          "sp2_purify (n = 12, 16, 24, 32, 128) on CUDA: one kernel node "
          "in the CUDA graph of one call", flush=True)
    C = K3_CELLS["headline packed XX"]
    ri, U, X, Yb = (t.contiguous() for t in k3_case(C, torch.float32, 77))
    need = (True, True, True)
    for perm in K3_PERMS:
        check_one_kernel(lambda: wk._launch_fwd(ri, U, X, perm),
                         "wapply_fwd", f"K3 forward at C={C} perm {perm}")
        check_one_kernel(lambda: wk._launch_bwd(ri, U, X, Yb, perm, need),
                         "wapply_bwd", f"K3 backward at C={C} perm {perm}")
    print(f"[2 one launch] K3 forward and backward at C={C}, perms "
          f"{', '.join(map(str, K3_PERMS))}: one kernel node each",
          flush=True)
    ins = overlap_grid_case(4096, 2, 6, 78)
    for mode in (2, 3, 4):
        check_one_kernel(lambda: ok_.s_combinations(mode, *ins),
                         "overlap_s_kernel", f"overlap kernel mode {mode}")
    print("[2 one launch] overlap kernel, modes 2, 3, 4 on expanded "
          "(4096, 2, 6) inputs: one kernel node each", flush=True)
    perm = (1, 3, 2, 4)

    def fwd():
        return wk._launch_fwd(ri, U, X, perm)
    dev = device_ms(fwd, 20)
    recorded = []
    for _ in range(3):
        prof, names = profiler_kernel_ms(fwd, 20)
        recorded.append(len(names))
        if len(names) == 20:
            break
    else:
        prof = None
    host = median_ms(fwd, 20)
    seen = ("torch.profiler kernel time "
            f"{prof:.4f} ms per call" if prof is not None else
            "torch.profiler lost launches in every session, no reading")
    print(f"[2 timer cross-check, K3 fwd C={C} perm {perm}] device_ms "
          f"{dev:.4f} ms, {seen} (launches recorded per session of 20 "
          f"calls: {recorded}), median_ms (host time included) "
          f"{host:.4f} ms", flush=True)
    return {"cells": C, "device_ms": dev, "profiler_ms": prof,
            "profiler_launches_per_20_calls": recorded, "median_ms": host}


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
    # n <= 16: the half-warp kernel (8, 12: padded lanes), 17-32 the warp
    # kernel, 128 the block kernel; B = 7 leaves a block part empty
    for B, n, nocc, seed in ((NMOL, 16, 5, 0), (7, 16, 5, 1),
                             (7, 8, 3, 4), (7, 12, 4, 5), (7, 24, 8, 6),
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


def headline_setup(nmol, dtype, scf_eps, sp2_eps, use_sp2=True, pack=True,
                   device=None):
    """The headline batch (first nmol molecules) and its configuration:
    the static packed layout (pack_heavy), or with ``pack=False`` the
    default layout (flat pair list, full 4A electronic state), on
    ``device`` (DEV unless given)."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.scf import SCFConfig
    from pyseqm_tpu_torch.utils.molecules import make_batch
    device = device or DEV
    sp, co = make_batch(NMOL, MOLSIZE, jitter=0.02)
    sp, co = sp[:nmol], co[:nmol]
    K = pt.packed_heavy_count(sp) if pack else None
    const, tables, cfg = pt.build(
        "AM1", dtype=dtype, device=device,
        scf=SCFConfig(eps=scf_eps, converger=(2,), use_sp2=use_sp2,
                      sp2_eps=sp2_eps, max_iter=200, pack_heavy=K,
                      raise_on_forward_failure=True))
    species = torch.tensor(sp, dtype=torch.long, device=device)
    # both precisions see the same (f32-representable) geometry
    coords = torch.tensor(co.astype(np.float32), dtype=dtype, device=device)
    return const, tables, cfg, species, coords


def span_breakdown(md, species, state):
    """(device ms, idle ms) per program span of one XL step under
    torch.profiler, and the share of the device time charged to a span:
    each kernel charged to the innermost span of the port's record open
    when it was launched (portbench/pbench/spans.py).  The step runs on a
    copy of the history, which it updates in place."""
    sys.path.insert(0, os.path.join(HERE, "portbench"))
    from pbench import spans, trace
    from pyseqm_tpu_torch.utils import timing
    state = dataclasses.replace(state, Pt=state.Pt.clone())
    timing.reset()
    sess = trace.record(lambda: (md.step(species, state), sync()), 1)
    table = spans.Attribution(sess, timing.spans()).table()
    timing.reset()
    return table


def phase_main_path(card):
    from pyseqm_tpu_torch.drivers.md import MDConfig
    from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
    from pyseqm_tpu_torch.ops import overlap_kernel, sp2_kernel
    const, tables, cfg, species, coords = headline_setup(
        NMOL, torch.float32, 1.0e-5, 1.0e-4)
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)

    sp2_kernel.launches = 0             # counts over the whole main path
    k3_reset()
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
    k0 = k3_counts()
    ov0 = overlap_kernel.launches
    etots = []
    t0 = time.perf_counter()
    for _ in range(NSTEPS):
        state, obs = md.step(species, state)
        etots.append(obs.Ek + obs.Epot)
    sync()
    t_steps = time.perf_counter() - t0
    n_steps_launch = sp2_kernel.launches - n0
    k3_step = [(b - a) / NSTEPS for a, b in zip(k0, k3_counts())]
    ov_step = (overlap_kernel.launches - ov0) / NSTEPS
    main_launches = sp2_kernel.launches
    k3_main = k3_counts()
    per_mol = (torch.stack(etots).double() - e_ref[None]).abs().amax(dim=0)
    drift = per_mol.max().item()
    finite = bool(torch.isfinite(state.coordinates).all()
                  and torch.isfinite(torch.stack(etots)).all())
    sps = NSTEPS / t_steps
    print(f"[4 xlbomd] {NMOL} x {MOLSIZE} AM1 f32 k=5 dt=0.4: "
          f"{sps:.3f} steps/s ({1e3 * t_steps / NSTEPS:.3f} ms/step) on "
          f"{card} | K1 launches over {NSTEPS} steps {n_steps_launch} | "
          f"K3 launches per step fwd {k3_step[0]:g} bwd {k3_step[1]:g} | "
          f"overlap kernel launches per step {ov_step:g} | "
          f"|Etot - Etot(warm-up end)| per molecule eV {fmt(per_mol)} | "
          f"finite {finite}", flush=True)
    check(finite, "non-finite MD state")
    check(n_steps_launch == NSTEPS, f"K1 launched {n_steps_launch} times "
          f"in {NSTEPS} steps")
    check(drift <= TOL_DRIFT, f"energy drift {drift} > {TOL_DRIFT} eV")
    check(k3_step == [2.0, 2.0], f"K3 launches per XL step {k3_step}, "
          "expected 2 forward (Coulomb, exchange) and 2 backward")
    check(ov_step == 3.0, f"overlap kernel launches per XL step {ov_step}, "
          "expected 3 (the XX, XH and HH segments)")

    bd = [span_breakdown(md, species, state) for _ in range(3)]
    names = sorted({k for b in bd for k in b if k != "total"})
    parts = {k: float(np.median([b.get(k, {}).get("device_ms", 0.0)
                                 for b in bd])) for k in names}
    idle = {k: float(np.median([b.get(k, {}).get("idle_ms", 0.0)
                                for b in bd])) for k in names}
    share = min(b["total"]["attributed_share"] or 0.0 for b in bd)
    print("[4 breakdown ms] " + " ".join(f"{k} {v:.3f}" for k, v in
                                         parts.items())
          + f" | sum {sum(parts.values()):.3f} of "
          f"{np.median([b['total']['device_ms'] for b in bd]):.3f} device "
          f"ms, charged share {share:.4f} | idle ms "
          + " ".join(f"{k} {v:.3f}" for k, v in idle.items() if v),
          flush=True)
    check(share >= 0.99, f"only {share:.4f} of a step's device time was "
          "charged to a program span")
    return (md, species, state, main_launches, sps, parts, per_mol, k3_main,
            k3_step)


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
          f"overlap (the overlap kernel) {sps_prec:.3f} steps/s, plain-f32 "
          f"overlap chain {sps_plain:.3f} steps/s", flush=True)
    _, per_mol_f64 = xl_run(256, torch.float64, True, NSTEPS)
    print(f"[6 drift, first 256 molecules] f64 max {per_mol_f64.max():.3e} "
          f"eV, f32 max {per_mol_f32[:256].max():.3e} eV", flush=True)


def overlap_grid_case(nmol, K, AH, seed):
    """Overlap inputs of an X-H-shaped segment (nmol, K, AH) on the card,
    as hcore_dense_split passes them: per-atom exponents expanded over the
    grid, distances from 1 to 9 Bohr, the three classes at random."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    zeta = (0.8 + 2.0 * torch.rand(nmol, K + AH, generator=g)).to(DEV)
    r = (1.0 + 8.0 * torch.rand(nmol, K, AH, generator=g)).to(DEV)
    zi = zeta[:, :K, None].expand(nmol, K, AH)
    zj = zeta[:, None, K:].expand(nmol, K, AH)
    j = torch.rand(nmol, K, AH, generator=g).to(DEV)
    return (r, zi, zi, zj, zj, j < 0.3, (j >= 0.3) & (j < 0.6), j >= 0.6)


def overlap_segments(name, nmol):
    """(mode, inputs) of each overlap kernel call of one float32 Hcore
    build (``_integral_stack``, as the XL step runs it) of the benchmark's
    configuration ``name`` at ``nmol`` molecules, jittered by 0.02 A."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.models.energy import (_atom_parameters,
                                                _integral_stack,
                                                _packed_layout)
    from pyseqm_tpu_torch.ops import overlap_kernel
    from pyseqm_tpu_torch.scf import SCFConfig
    from pyseqm_tpu_torch.system import make_system
    from pyseqm_tpu_torch.utils.molecules import make_alkane, make_batch
    rng = np.random.default_rng(18)
    if name == "xl-small":
        sp, co = make_batch(nmol, MOLSIZE, jitter=0.02)
    else:
        s1, c1 = make_alkane(9)
        sp = np.repeat(s1[None], nmol, 0)
        co = c1[None] + 0.02 * rng.standard_normal((nmol,) + c1.shape)
    const, tables, cfg = pt.build(
        "AM1", dtype=torch.float32, device=DEV,
        scf=SCFConfig(pack_heavy=pt.packed_heavy_count(sp)))
    species = torch.tensor(sp, dtype=torch.long, device=DEV)
    coords = torch.tensor(co.astype(np.float32), device=DEV)
    K, n_st = _packed_layout(cfg, species.shape[1])
    calls = []
    launch = overlap_kernel.s_combinations

    def tap(mode, *ins):
        calls.append((mode, ins))
        return launch(mode, *ins)
    with torch.no_grad(), patched(overlap_kernel, "s_combinations", tap):
        sys_ = make_system(const, species, coords, None, heavy_count=K)
        p = _atom_parameters(tables, cfg.method, sys_, None, coords)
        _integral_stack(const, sys_, p, cfg, packed_m=n_st)
    return calls


def overlap_errors(mode, ins, out):
    """(cells beyond 1 ulp of the double-float chain, those not nearer to
    float64 than the chain or beyond 1 ulp of it, the largest |kernel -
    float64|, zero patterns equal) over the five outputs."""
    from pyseqm_tpu_torch.ops import overlap as tov

    def ordered(x):
        i = x.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    chain = tov._s_combinations(*ins, True, mode)
    exact = tov._s_combinations(*[t.double() if t.is_floating_point()
                                  else t for t in ins], False, mode)
    beyond = bad = 0
    worst, zeros = 0.0, True
    for g, c, e in zip(out, chain, exact):
        far = (ordered(g) - ordered(c)).abs() > 1
        nearer = (((g.double() - e).abs() <= (c.double() - e).abs())
                  & ((ordered(g) - ordered(e.float())).abs() <= 1))
        beyond += int(far.sum())
        bad += int((far & ~nearer).sum())
        worst = max(worst, float((g.double() - e).abs().max()))
        zeros = zeros and torch.equal(g == 0, c == 0)
    return beyond, bad, worst, zeros


# the inputs (rij, zsi, zpi, zsj, zpj, jcall2, jcall3, jcall4) a segment's
# combinations read: H-H only rij, zsi, zsj and jcall2; X-H no zpj, jcall4
OVERLAP_READS = {2: (0, 1, 3, 5), 3: (0, 1, 2, 3, 5, 6), 4: tuple(range(8))}


def overlap_bound(mode, ins):
    """(bound ms, bound by, bytes, FP64 operations) of one call: each
    distinct element of the inputs the mode reads, once (an expanded input
    counts its own elements), the five float32 outputs written once, FP64
    operations by the class of each cell."""
    views = torch.broadcast_tensors(*ins)
    n = views[0].numel()
    nbytes = 5 * 4 * n
    for k in OVERLAP_READS[mode]:
        v = views[k]
        nbytes += v.element_size() * math.prod(
            sz for sz, st in zip(v.shape, v.stride()) if st != 0)
    j2, j3, j4 = (v.bool() for v in views[5:])
    j3 = j3 & ~j2 if mode >= 3 else torch.zeros_like(j3)
    j4 = j4 & ~j2 & ~j3 if mode >= 4 else torch.zeros_like(j4)
    ops = (int(j2.sum()) * OVERLAP_OPS["jcall2"]
           + int(j3.sum()) * OVERLAP_OPS["jcall3"]
           + int(j4.sum()) * OVERLAP_OPS["jcall4"])
    t_op, t_byte = ops / PEAK_FP64 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_op, t_byte), "FP64 operations" if t_op > t_byte
            else "bytes", nbytes, ops)


def phase_overlap():
    from pyseqm_tpu_torch.ops import overlap as tov
    from pyseqm_tpu_torch.ops import overlap_kernel
    seg = {4: "XX", 3: "XH", 2: "HH"}
    out = {}
    for name, nmol in OVERLAP_CASES:
        calls = overlap_segments(name, nmol)
        check(sorted(m for m, _ in calls) == [2, 3, 4],
              f"{name}: overlap kernel calls of one Hcore build by mode "
              f"{[m for m, _ in calls]}, expected one per segment")
        for mode, ins in calls:
            fn = lambda: overlap_kernel.s_combinations(mode, *ins)  # noqa: E731
            beyond, bad, worst, zeros = overlap_errors(mode, ins, fn())
            n = math.prod(torch.broadcast_shapes(*(t.shape for t in ins)))
            check(bad == 0 and beyond <= max(1, 5 * n // 1000) and zeros
                  and worst <= 3.0e-7,
                  f"{name} {seg[mode]}: {beyond} cells beyond 1 ulp of the "
                  f"chain, {bad} of them not nearer to float64, float64 "
                  f"error {worst:.2e}, zeros equal {zeros}")
            ms = device_ms(fn, 20)
            plain = median_ms(lambda: tov._s_combinations(*ins, True, mode),
                              3)
            bound, by, nbytes, ops = overlap_bound(mode, ins)
            key = f"{name} {seg[mode]}"
            out[key] = {"cells": n, "shape": list(torch.broadcast_shapes(
                *(t.shape for t in ins))), "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                "fp64_ops": ops, "cells_beyond_1ulp": beyond,
                "max_abs_err_f64": worst}
            print(f"[18 overlap {key}] {n} cells {out[key]['shape']}: "
                  f"kernel {ms:.4f} ms (median of 20, device time alone), "
                  f"double-float chain {plain:.2f} ms | bound {bound:.4f} ms "
                  f"({by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G FP64 "
                  f"operations), {100 * bound / ms:.1f}% of it | cells "
                  f"beyond 1 ulp of the chain {beyond} (each nearer to "
                  f"float64), |kernel - float64| {worst:.2e}", flush=True)
        del calls
        torch.cuda.empty_cache()
    return out


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
        M, w, _ = _integral_stack(md.const, sys_, p, cfg, packed_m=n_st)
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
    ms = device_ms(lambda: sp2_purify(a0, nocc, eps), 20)
    plain_ms = median_ms(lambda: sp2_purify_reference(a0, nocc, eps), 3)
    eigh_ms = median_ms(lambda: torch.linalg.eigh(a0), 3)
    it = iters.double()
    # per iteration X^2 (2n^3) + ||X||^2 (2n^2) + update (3n^2); McWeeny
    # 2 products (4n^3) + 3n^2; bytes: a0 and nocc read, P and the
    # iteration counts written, once each
    flops = (it * (2 * n ** 3 + 5 * n ** 2)).sum().item() \
        + B * (4 * n ** 3 + 3 * n ** 2)
    nbytes = 2 * B * n * n * 4 + 2 * B * 4
    t_flop, t_byte = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"[5 K1 timing] main-path input B={B} n={n}: kernel {ms:.4f} ms "
          f"(median of 20, device time alone), "
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
    """Counts the calls of ``module.name`` while active and keeps, detached,
    the tensor arguments of the last call for each key: by default the
    first 3-D tensor under its matrix size n; with ``key`` given, every
    tensor argument under ``key(*args)``."""

    def __init__(self, module, name, key=None):
        self.module, self.name, self.key = module, name, key
        self.calls, self.last = 0, {}

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            self.calls += 1
            # detached: keep the input, not its autograd graph
            if self.key is not None:
                self.last[self.key(*args)] = tuple(
                    a.detach() for a in args if torch.is_tensor(a))
            else:
                mats = [a for a in args
                        if torch.is_tensor(a) and a.dim() == 3]
                if mats:
                    self.last[mats[0].shape[-1]] = mats[0].detach()
            return self.orig(*args, **kwargs)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def sym_case(B, n, seed, kind="dense"):
    """Symmetric f32 test matrices from a numpy seed: "dense" random (the
    class of tests/test_kernels.py), "mixed" (dense, every other matrix
    cut to its diagonal: one sweep converges those, so molecules that
    share a warp leave at different sweeps), "degenerate" (its n = 24
    case, an exact double eigenvalue), or "fock" (diagonal -20,
    off-diagonal N(0, 18), the packed-F class of tests/test_torch_sp2.py).
    At n = 128 a dense matrix's Gershgorin shift is ~30 max|A|, and e =
    sigma - |g| carries the f32 rounding of that shift, close to the 5e-4
    max|A| bound; the Fock class keeps the shift at ~14 max|A|."""
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
    if kind == "mixed":
        A[1::2] *= np.eye(n)
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
    n_diff = int((e != er).sum().item() + (v != vr).sum().item())
    return st, sweeps, bool(torch.equal(sweeps, sr)), n_diff


def phase_k2_parity():
    from pyseqm_tpu_torch.ops import density, eigh_kernel
    worst = 0.0
    # the warp kernel at n = 2, 4, 8, 16 (several molecules per warp), 24
    # (padded to 32) and 32; the block kernel at 128; B = 7 leaves the
    # last warp or block part empty
    for B, n, seed, kind in ((NMOL, 16, 10, "dense"), (7, 16, 11, "dense"),
                             (7, 2, 20, "dense"), (7, 4, 21, "dense"),
                             (7, 8, 22, "dense"), (7, 8, 23, "mixed"),
                             (7, 16, 24, "mixed"), (7, 24, 25, "dense"),
                             (NMOL, 32, 12, "dense"), (7, 32, 13, "dense"),
                             (7, 32, 26, "mixed"),
                             (7, 128, 17, "dense"), (7, 128, 14, "fock"),
                             (8, 24, 15, "degenerate")):
        st, sweeps, same, n_diff = eigh_stats(sym_case(B, n, seed, kind))
        line = " | ".join(f"{k} {fmt(v)}" for k, v in st.items())
        print(f"[8 K2 eigh B={B} n={n} {kind}] "
              f"{line} | sweeps mean {sweeps.double().mean().item():.2f} "
              f"max {int(sweeps.max().item())} min "
              f"{int(sweeps.min().item())}, same as plain {same} | "
              f"elements of e, v differing from plain {n_diff} of "
              f"{B * n * (n + 1)}", flush=True)
        check(same, f"K2 sweeps differ from the plain version at B={B} "
              f"n={n} {kind}")
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
    k2_reset()
    density.rescued = 0
    k3_reset()
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
    K2_BY_N["scf_eigh"] = dict(eigh_kernel.launches_by_n)
    k3 = k3_counts()
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
            "launches": launches, "k3_launches": k3}, k2_in.last[16]


def phase_eig_outputs():
    """eig=True at full width; f32 against f64 on the first 256."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.ops import density, eigh_kernel
    from pyseqm_tpu_torch.system import make_system
    const, tables, cfg, species, coords = headline_setup(
        NMOL, torch.float32, 1.0e-5, 1.0e-4, use_sp2=False)
    cfg = dataclasses.replace(cfg, eig=True)
    k2_reset()
    k3_reset()
    with Tap(density, "eigh_batched_checked") as k2_in:
        f, out = pt.force(const, tables, cfg, species, coords)
        sync()
    launches = eigh_kernel.launches
    K2_BY_N["eig_true"] = dict(eigh_kernel.launches_by_n)
    k3 = k3_counts()
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
    return launches, k3, k2_in.last[4 * A], {
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
    k2_reset()
    k3_reset()
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
    K2_BY_N["xlbomd_eigh"] = dict(eigh_kernel.launches_by_n)
    k3 = k3_counts()
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
    return launches, k3, {"steps_per_s": sps,
                          "drift_max": per_mol.max().item(),
                      "launches_per_step": n_launch,
                      "device_ms_per_step": dev_ms}


def k2_timing(A, tag):
    """K2 on one path input: the kernel alone (device time; eigh_jacobi is
    one launch, phase 2) against its bound, which counts the folded shift,
    sort and normalisation too; the whole eigh_jacobi call with its host
    time (median_ms) and the plain version beside torch.linalg.eigh, which
    computes the same function, timed the same way."""
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
    ms = device_ms(lambda: ek.eigh_jacobi(A, with_resid=True), 20)
    wrapper_ms = median_ms(lambda: ek.eigh_jacobi(A, with_resid=True), 20)
    plain_ms = median_ms(lambda: ek.eigh_jacobi_reference(A, with_resid=True),
                         3)
    lib_ms = median_ms(lambda: torch.linalg.eigh(A), 5)
    sw = sweeps.double()
    n = ek.next_pow2(n0)
    # per sweep (n - 1) rounds of n/2 pairs.  A pair needs gamma once (n
    # FMA = 2n), both alphas (4n), both column updates (6n) and one
    # rotation (~20 scalar operations; both members of the pair compute
    # the same gamma and rotation, which counts once).  Folded around the
    # sweeps: the shift (n0^2 additions, ~8 n0 per column and molecule),
    # the final column norms (2n^2 + n), e (n), the rank (n^2
    # comparisons) and the normalisation (n0^2 divisions).  Bytes: A
    # read, e, v and resid written, once each
    flops = (sw.sum().item() * (n - 1) * (n // 2) * (12 * n + 20)
             + B * (n0 * n0 + 8 * n0 + 3 * n * n + 2 * n + n0 * n0))
    nbytes = 4 * B * (2 * n0 * n0 + n0 + 1)
    t_flop, t_byte = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    bound = max(t_flop, t_byte)
    print(f"[12 K2 timing, {tag} input B={B} n={n0}] kernel {ms:.4f} ms "
          f"(median of 20, device time alone), "
          f"plain {plain_ms:.3f} ms | bound {bound:.4f} ms (FP32 "
          f"{t_flop:.4f}, bytes {t_byte:.4f}), kernel at "
          f"{100 * bound / ms:.1f}% of it | whole call with host time "
          f"{wrapper_ms:.4f} ms against torch.linalg.eigh {lib_ms:.3f} ms "
          f"| sweeps mean {sw.mean().item():.2f} max "
          f"{int(sw.max().item())} | kernel vs plain {err:.2e} | resid max "
          f"{resid.max().item():.2e}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "wrapper_ms": wrapper_ms, "bound_ms": bound,
            "bound_by": "operations" if t_flop >= t_byte else "bytes",
            "mean_sweeps": sw.mean().item(), "max_abs_err": err}


# K2 launches of each path by padded matrix size (the kernel variant)
K2_BY_N = {}


def k2_reset():
    from pyseqm_tpu_torch.ops import eigh_kernel
    eigh_kernel.launches = 0
    eigh_kernel.launches_by_n = {}


def k3_counts():
    from pyseqm_tpu_torch.ops import wapply_kernel
    return wapply_kernel.launches_fwd, wapply_kernel.launches_bwd


def k3_reset():
    from pyseqm_tpu_torch.ops import wapply_kernel
    wapply_kernel.launches_fwd = wapply_kernel.launches_bwd = 0


def k3_tap():
    """A Tap on tetci's w_apply keeping the operands (ri, U, X) of the
    last K3 apply of each perm."""
    from pyseqm_tpu_torch.ops import tetci
    return Tap(tetci, "w_apply", key=lambda ri, U, X, perm: tuple(perm))


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms while active (warnings only for
    an op without a deterministic version)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic")
            yield
    finally:
        torch.use_deterministic_algorithms(prev)


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` replaced by ``value`` while active."""
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


def k3_case(C, dtype, seed):
    """K3 operands from a seed: 22 integrals, a frame from a random bond
    direction (frame_matrix, so U has the structure the kernel assumes),
    a density block and an output cotangent per cell."""
    from pyseqm_tpu_torch.ops.tetci import frame_matrix
    g = torch.Generator(device=DEV).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=DEV,
                           dtype=torch.float64)
    x = rnd(C, 3)
    U = frame_matrix(x / x.norm(dim=-1, keepdim=True))
    return [t.to(dtype) for t in (5.0 * rnd(C, 22), U, rnd(C, 4, 4),
                                  rnd(C, 4, 4))]


def k3_errors(ri, U, X, Yb, perm):
    """K3 (through w_apply and its autograd.Function) against the plain
    version and autograd through it: the forward's error relative to its
    largest value, each cotangent's relative to max(its largest value, 1)
    (dU on the 3x3 block the kernel returns), the largest absolute error,
    and whether dU is zero outside the block."""
    from pyseqm_tpu_torch.ops import wapply_kernel as wk

    def run(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in (ri, U, X)]
        y = fn(*leaves, perm)
        return (y,) + torch.autograd.grad(y, leaves, Yb)
    got, ref = run(wk.w_apply), run(wk.w_apply_reference)
    sync()
    block = bool(not got[2][..., 0, :].any() and not got[2][..., 1:, 0].any())
    pairs = [(got[0], ref[0]), (got[1], ref[1]),
             (got[2][..., 1:, 1:], ref[2][..., 1:, 1:]), (got[3], ref[3])]
    rel, absmax = [], 0.0
    for k, (a, b) in enumerate(pairs):
        d = (a - b).abs().max().item()
        scale = b.abs().max().item()
        rel.append(d / (scale if k == 0 else max(scale, 1.0)))
        absmax = max(absmax, d)
    return rel, absmax, block


def phase_k3_parity():
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for dtype in (torch.float32, torch.float64):
        for seed, (tag, C) in enumerate(K3_CELLS.items()):
            ri, U, X, Yb = k3_case(C, dtype, seed)
            lines = []
            for perm in K3_PERMS:
                rel, absmax, block = k3_errors(ri, U, X, Yb, perm)
                lines.append(f"{perm}: " + " ".join(
                    f"{n} {e:.1e}" for n, e in zip(("y", "dri", "dU", "dX"),
                                                  rel)))
                check(max(rel) <= TOL_K3[dtype] and block,
                      f"K3 {tag} {dtype} {perm}: relative errors {rel}, "
                      f"dU block only {block}")
                worst[dtype] = max(worst[dtype], absmax)
            print(f"[13 K3 {tag} C={C} {str(dtype)[6:]}] " + " | ".join(lines),
                  flush=True)
            del ri, U, X, Yb
        # the Coulomb apply of the packed Fock: X broadcast over the row atom
        ri, U, _, Yb = k3_case(NMOL * 4, dtype, 99)
        shape = (NMOL, 2, 2)
        ri, U, Yb = ri.reshape(shape + (22,)), U.reshape(shape + (4, 4)), \
            Yb.reshape(shape + (4, 4))
        Xb = k3_case(NMOL * 2, dtype, 98)[2].reshape(NMOL, 1, 2, 4, 4)
        rel, absmax, block = k3_errors(ri, U, Xb, Yb, (1, 2, 3, 4))
        print(f"[13 K3 expanded X ({NMOL}, 1, 2) -> ({NMOL}, 2, 2) "
              f"{str(dtype)[6:]}] y {rel[0]:.1e} dri {rel[1]:.1e} dU "
              f"{rel[2]:.1e} dX {rel[3]:.1e}", flush=True)
        check(max(rel) <= TOL_K3[dtype] and block,
              f"K3 expanded X {dtype}: {rel}")
        # operands that are views into larger buffers, one cell or one
        # element in: not all 16-byte aligned, so the kernels take their
        # plain loads (a float64 cell is 176 bytes, so its odd cell offset
        # stays aligned and takes the bulk copies)
        C = K3_CELLS["ragged"]
        for how in ("cell", "element"):
            if how == "cell":
                ri, U, X, Yb = (t[1:] for t in k3_case(C + 1, dtype, 97))
            else:
                ops = []
                for t in k3_case(C, dtype, 96):
                    buf = torch.empty(t.numel() + 1, dtype=dtype, device=DEV)
                    buf[1:].copy_(t.reshape(-1))
                    ops.append(buf[1:].view(t.shape))
                ri, U, X, Yb = ops
            unaligned = any(t.data_ptr() % 16 for t in (ri, U, X))
            check(unaligned or (how == "cell" and dtype == torch.float64),
                  f"K3 {how}-offset case is aligned in {dtype}")
            lines = []
            for perm in K3_PERMS:
                rel, absmax, block = k3_errors(ri, U, X, Yb, perm)
                lines.append(f"{perm}: " + " ".join(
                    f"{n} {e:.1e}" for n, e in zip(("y", "dri", "dU", "dX"),
                                                  rel)))
                check(max(rel) <= TOL_K3[dtype] and block,
                      f"K3 odd {how} offset {dtype} {perm}: {rel}")
                worst[dtype] = max(worst[dtype], absmax)
            print(f"[13 K3 views at an odd {how} offset C={C} "
                  f"{str(dtype)[6:]}, 16-byte aligned "
                  f"{not unaligned}] " + " | ".join(lines), flush=True)
    return worst[torch.float32]


def k3_second_errors(ri, U, X, Yb, perm, v):
    """Double backward through K3 (WApply, then WApplyBwd under
    create_graph) against double backward through the plain version: the
    gradients of the linear form sum(v * (dri, dU, dX)) by ri, U (the 3x3
    block), X and Yb, each relative to max(its largest value, 1); and the
    largest absolute error.  v[1] lies on the block the kernels read."""
    from pyseqm_tpu_torch.ops import wapply_kernel as wk

    def run(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (ri, U, X, Yb)]
        g = torch.autograd.grad(fn(*leaves[:3], perm), leaves[:3],
                                leaves[3], create_graph=True)
        form = sum((a * b).sum() for a, b in zip(v, g))
        return torch.autograd.grad(form, leaves)
    got, ref = run(wk.w_apply), run(wk.w_apply_reference)
    sync()
    rel, absmax = [], 0.0
    for k, (a, b) in enumerate(zip(got, ref)):
        if k == 1:
            a, b = a[..., 1:, 1:], b[..., 1:, 1:]
        d = (a - b).abs().max().item()
        rel.append(d / max(b.abs().max().item(), 1.0))
        absmax = max(absmax, d)
    return rel, absmax


def phase_k3_second_order():
    """K3's second derivative at the headline flat layout's cell count
    and on the expanded X of the packed Coulomb apply, each perm, float32
    and float64; one WApplyBwd forward is one K3 backward launch."""
    from pyseqm_tpu_torch.ops import wapply_kernel as wk
    C = K3_CELLS["flat default"]
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for dtype in (torch.float32, torch.float64):
        blk = torch.zeros(4, 4, dtype=dtype, device=DEV)
        blk[1:, 1:] = 1.0
        ri, U, X, Yb = k3_case(C, dtype, 31)
        v = [t for t in k3_case(C, dtype, 32)]
        v = [v[0], v[2] * blk, v[3]]
        lines = []
        for perm in K3_PERMS:
            rel, absmax = k3_second_errors(ri, U, X, Yb, perm, v)
            lines.append(f"{perm}: " + " ".join(
                f"{n} {e:.1e}" for n, e in zip(("ri", "U", "X", "Yb"), rel)))
            check(max(rel) <= TOL_K3[dtype], f"K3 double backward {dtype} "
                  f"{perm}: relative errors {rel}")
            worst[dtype] = max(worst[dtype], absmax)
        print(f"[13 K3 double backward C={C} {str(dtype)[6:]}] "
              + " | ".join(lines), flush=True)
        # the expanded X of the packed Coulomb apply
        shape = (NMOL, 2, 2)
        ri, U, _, Yb = (t.reshape(shape + t.shape[1:]) for t in
                        k3_case(NMOL * 4, dtype, 33))
        Xb = k3_case(NMOL * 2, dtype, 34)[2].reshape(NMOL, 1, 2, 4, 4)
        w = k3_case(NMOL * 4, dtype, 35)
        v = [w[0].reshape(shape + (22,)), (w[1] * blk).reshape(
            shape + (4, 4)), k3_case(NMOL * 2, dtype, 36)[2].reshape(
            NMOL, 1, 2, 4, 4)]
        rel, absmax = k3_second_errors(ri, U, Xb, Yb, (1, 2, 3, 4), v)
        print(f"[13 K3 double backward, expanded X ({NMOL}, 1, 2) -> "
              f"({NMOL}, 2, 2) {str(dtype)[6:]}] " + " ".join(
                  f"{n} {e:.1e}" for n, e in zip(("ri", "U", "X", "Yb"), rel)),
              flush=True)
        check(max(rel) <= TOL_K3[dtype], f"K3 double backward expanded X "
              f"{dtype}: {rel}")
        worst[dtype] = max(worst[dtype], absmax)
    ri, U, X, Yb = (t.contiguous() for t in k3_case(4096, torch.float32, 37))
    for perm in K3_PERMS:
        check_one_kernel(lambda: wk.WApplyBwd.apply(ri, U, X, Yb, perm),
                         "wapply_bwd", f"WApplyBwd forward {perm}")
    print("[13 K3 double backward] one WApplyBwd forward is one wapply_bwd "
          "kernel (captured CUDA graph), every perm", flush=True)
    return worst


def phase_flat_default(card):
    """The default layout (no pack_heavy) at full width: flat hcore,
    fock(WPack) with three K3 applies per build, sym_eig on the orbital
    permutation (K2 at n = 32); 3 chained energy calls as phase 9."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch import scf
    from pyseqm_tpu_torch.ops import eigh_kernel
    const, tables, cfg, species, coords = headline_setup(
        NMOL, torch.float32, 1.0e-5, 1.0e-4, use_sp2=False, pack=False)
    out = pt.energy(const, tables, cfg, species, coords)     # warm-up
    check(type(out.w).__name__ == "WPack", f"default layout ran on "
          f"{type(out.w).__name__}, not the flat pair list")
    hf_first = out.Hf
    sync()
    k2_reset()
    k3_reset()
    solves, nc = [], 0
    with Tap(scf, "sym_eig") as tap, k3_tap() as k3_in:
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
    launches, k3 = eigh_kernel.launches, k3_counts()
    K2_BY_N["flat_default"] = dict(eigh_kernel.launches_by_n)
    mps = SCF_REPEATS * NMOL / dt
    polish = 8
    print(f"[14 flat default] {NMOL} x {MOLSIZE} AM1 f32 eps 1e-5, no "
          f"pack_heavy: {mps:.1f} molecules/s ({dt / SCF_REPEATS:.3f} s per "
          f"call) on {card} | SCF iterations per call "
          f"{[k - polish for k in solves]} + {polish} polish | notconverged "
          f"{nc} | K2 launches {launches} for {sum(solves)} density solves "
          f"| K3 launches fwd {k3[0]} bwd {k3[1]}", flush=True)
    check(bool(torch.isfinite(out.Hf).all()), "non-finite flat Hf")
    check(nc == 0, f"{nc} flat-layout molecules not converged")
    check(launches == sum(solves), f"K2 launched {launches} times for "
          f"{sum(solves)} density solves")
    check(k3[0] > 0, "K3 was not launched on the flat default path")

    m = 256
    runs = {}
    for dtype, eps in ((torch.float32, 1.0e-5), (torch.float64, 1.0e-10)):
        c_, t_, cfg_, sp_, co_ = headline_setup(m, dtype, eps, 1.0e-7,
                                                use_sp2=False, pack=False)
        f, o = pt.force(c_, t_, cfg_, sp_, co_)
        runs[dtype] = (f.double(), o.Hf.double())
    (f32, h32), (f64, h64) = runs[torch.float32], runs[torch.float64]
    dh = (h32 - h64).abs()
    df = (f32 - f64).abs().amax(dim=(1, 2))
    c_, t_, cfg_, sp_, co_ = headline_setup(m, torch.float32, 1.0e-5, 1.0e-4,
                                            use_sp2=False)
    dpk = (pt.energy(c_, t_, cfg_, sp_, co_).Hf.double()
           - hf_first[:m].double()).abs()
    print(f"[14 flat default f32 vs f64, {m} molecules] |dHf| eV {fmt(dh)} "
          f"| |dF| eV/A {fmt(df)} | |Hf(flat) - Hf(packed)| f32 eV "
          f"{fmt(dpk)}", flush=True)
    check(dh.max().item() <= TOL_HF, f"flat f32 Hf error {dh.max().item()}")
    check(df.max().item() <= TOL_F, f"flat f32 force error {df.max().item()}")
    return {"molecules_per_s": mps, "s_per_call": dt / SCF_REPEATS,
            "iterations": [k - polish for k in solves], "k2_launches":
            launches, "k3_launches": k3, "dHf_max": dh.max().item(),
            "dF_max": df.max().item(), "dHf_vs_packed_max":
            dpk.max().item()}, k3_in.last


def nanostar_setup(dtype, packed):
    """make_alkane(294), 884 atoms, AM1: the configuration of `bench.py
    --config nanostar` (packed) or the default layout with only
    pack_orbitals (float64: eps 1e-8)."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.scf import SCFConfig
    from pyseqm_tpu_torch.utils.molecules import make_alkane
    z, x = make_alkane(NANO_CARBONS)
    sp = z[None]
    n_orb = pt.packed_orbital_size(sp)
    if packed:
        scf_cfg = SCFConfig(eps=1.0e-3, converger=(2,), use_sp2=True,
                            sp2_eps=1.0e-4, sp2_tight_bounds=True,
                            max_iter=400, pack_orbitals=n_orb,
                            pack_heavy=pt.packed_heavy_count(sp))
    elif dtype == torch.float32:
        scf_cfg = SCFConfig(pack_orbitals=n_orb)
    else:
        scf_cfg = SCFConfig(eps=1.0e-8, converger=(2,), pack_orbitals=n_orb)
    const, tables, cfg = pt.build("AM1", dtype=dtype, device=DEV,
                                  scf=scf_cfg)
    species = torch.tensor(sp, dtype=torch.long, device=DEV)
    coords = torch.tensor(x[None].astype(np.float32), dtype=dtype,
                          device=DEV)
    return const, tables, cfg, species, coords


def phase_nanostar_packed(card):
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch import scf
    from pyseqm_tpu_torch.models.energy import _packed_layout
    from pyseqm_tpu_torch.models.xlbomd import force_xl
    from pyseqm_tpu_torch.ops import density
    from pyseqm_tpu_torch.ops.density import static_pack_mat
    const, tables, cfg, species, coords = nanostar_setup(torch.float32, True)
    K, n_st = _packed_layout(cfg, species.shape[1])
    torch.cuda.reset_peak_memory_stats()
    k3_reset()
    density.sp2_iterations = 0
    with Tap(scf, "sp2") as tap, k3_tap() as k3_in:
        sync()
        t0 = time.perf_counter()
        out = pt.energy(const, tables, cfg, species, coords)
        sync()
        t_scf = time.perf_counter() - t0
        scf_it, solves = density.sp2_iterations, tap.calls
        hf_scf, nc = out.Hf.detach(), bool(out.notconverged.any())
        P0 = static_pack_mat(out.P.detach(), K, n_st)
        del out
        # the first force step at the SCF geometry (cross-checked in 16)
        f0, hf0, _ = force_xl(const, tables, cfg, species, coords, P0,
                              packed_io=True)
        density.sp2_iterations = 0
        c = coords
        sync()
        t0 = time.perf_counter()
        for _ in range(NANO_STEPS):
            frc, hf, D = force_xl(const, tables, cfg, species, c, P0,
                                  packed_io=True)
            c = c + 1.0e-7 * frc
        sync()
        dt = time.perf_counter() - t0
    sps = NANO_STEPS / dt
    it_step = density.sp2_iterations / NANO_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k3 = k3_counts()
    finite = bool(torch.isfinite(c).all() and torch.isfinite(hf).all())
    print(f"[15 nanostar packed] C{NANO_CARBONS}H{2 * NANO_CARBONS + 2} "
          f"({species.shape[1]} atoms) AM1 f32, K={K} n_st={n_st}: SCF "
          f"{t_scf:.2f} s, "
          f"{solves} SP2 solves, {scf_it} SP2 iterations, notconverged {nc} "
          f"| {NANO_STEPS} chained force_xl: {sps:.3f} steps/s "
          f"({1e3 / sps:.1f} ms/step) on {card}, {it_step:.1f} SP2 "
          f"iterations per step | peak memory {peak:.2f} GiB | K3 launches "
          f"fwd {k3[0]} bwd {k3[1]} | finite {finite}", flush=True)
    check(finite and not nc, "nanostar packed run not finite or converged")
    check(k3[0] > 0 and k3[1] > 0, "K3 not launched on the nanostar packed "
          "path (forward and backward)")
    return ({"steps_per_s": sps, "scf_s": t_scf, "scf_sp2_iterations": scf_it,
             "sp2_iterations_per_step": it_step, "peak_gib": peak,
             "k3_launches": k3},
            (hf_scf.double(), f0.double(), hf0.double()), k3_in.last)


def phase_nanostar_dense(card, packed_ref):
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch import scf
    polish = 8
    const, tables, cfg, species, coords = nanostar_setup(torch.float32,
                                                         False)
    torch.cuda.reset_peak_memory_stats()
    k3_reset()
    with Tap(scf, "sym_eig") as tap, k3_tap() as k3_in:
        sync()
        t0 = time.perf_counter()
        f, out = pt.force(const, tables, cfg, species, coords)
        sync()
        dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k3 = k3_counts()
    layout = type(out.w).__name__
    nc = bool(out.notconverged.any())
    print(f"[16 nanostar dense] {species.shape[1]} atoms AM1 f32, default "
          f"layout ({layout}, pack_orbitals {cfg.scf.pack_orbitals}): one "
          f"force call {dt:.2f} s on "
          f"{card} | SCF iterations {tap.calls - polish} + {polish} polish, "
          f"notconverged {nc} | peak memory {peak:.2f} GiB | K3 launches fwd "
          f"{k3[0]} bwd {k3[1]}", flush=True)
    check(layout == "WPackGrid", f"the nanostar default ran on {layout}")
    check(not nc and bool(torch.isfinite(f).all()),
          "nanostar dense run not finite or converged")
    check(k3[0] > 0 and k3[1] > 0, "K3 not launched on the nanostar dense "
          "path (forward and backward)")
    f32d, h32d = f.double(), out.Hf.double()
    del f, out
    torch.cuda.empty_cache()

    c64 = nanostar_setup(torch.float64, False)
    t0 = time.perf_counter()
    f64, o64 = pt.force(*c64)
    sync()
    t64 = time.perf_counter() - t0
    h64 = o64.Hf.double()
    hpk, fpk, hpk_xl = packed_ref
    dh = {"packed-f64": (hpk - h64).abs().item(),
          "packed XL-f64": (hpk_xl - h64).abs().item(),
          "dense-f64": (h32d - h64).abs().item(),
          "packed-dense": (hpk - h32d).abs().item()}
    df = {"packed XL-f64": (fpk - f64).abs().max().item(),
          "dense-f64": (f32d - f64).abs().max().item(),
          "packed XL-dense": (fpk - f32d).abs().max().item()}
    print(f"[16 nanostar cross-check] f64 dense run {t64:.2f} s, Hf "
          f"{h64.item():.6f} eV | |dHf| eV " + " ".join(
              f"{k} {v:.2e}" for k, v in dh.items()) + " | max |dF| eV/A "
          + " ".join(f"{k} {v:.2e}" for k, v in df.items()), flush=True)
    check(max(dh.values()) <= TOL_HF_NANO, f"nanostar Hf cross-check {dh}")
    check(max(df.values()) <= TOL_F_NANO, f"nanostar force cross-check {df}")
    return {"force_s": dt, "scf_iterations": tap.calls - polish,
            "peak_gib": peak, "k3_launches": k3, "f64_force_s": t64,
            "dHf": dh, "dF": df}, k3_in.last


def adjoint_setup(nmol, dtype, eps, pack):
    """The headline batch with the eigh SCF and backward mode 1."""
    const, tables, cfg, species, coords = headline_setup(
        nmol, dtype, eps, 1.0e-4, use_sp2=False, pack=pack)
    return (const, tables, dataclasses.replace(cfg, scf=dataclasses.replace(
        cfg.scf, backward=1)), species, coords)


def adjoint_step(const, tables, cfg, species, coords):
    """Energy with per-atom learned U_ss and zeta_s (built from the
    tables), then one backward of sum(Hf) to them and the coordinates."""
    import pyseqm_tpu_torch as pt
    learned = {k: tables[k][species].clone().requires_grad_(True)
               for k in ("U_ss", "zeta_s")}
    x = coords.detach().clone().requires_grad_(True)
    out = pt.energy(const, tables, cfg, species, x, learned=learned)
    grads = torch.autograd.grad(out.Hf.sum(), (learned["U_ss"],
                                               learned["zeta_s"], x))
    return out, grads


def phase_scf_adjoint(card, pack):
    """Backward mode 1 at full width: energy + gradient to the learned
    parameters and the coordinates, median of ADJ_REPS after a warm-up;
    float32 against float64 on the first 256 molecules."""
    from pyseqm_tpu_torch import scf
    from pyseqm_tpu_torch.ops import eigh_kernel
    tag = "scf_adjoint" if pack else "scf_adjoint_flat"
    label = "19 scf-adjoint" + ("" if pack else " flat")
    setup = adjoint_setup(NMOL, torch.float32, 1.0e-5, pack)
    adjoint_step(*setup)                                    # warm-up
    sync()
    k2_reset()
    k3_reset()
    scf.adjoint_iterations = scf.backward_failures = 0
    times = []
    for _ in range(ADJ_REPS):
        sync()
        t0 = time.perf_counter()
        out, grads = adjoint_step(*setup)
        sync()
        times.append(time.perf_counter() - t0)
    k2, k3 = eigh_kernel.launches, k3_counts()
    iters, fails = scf.adjoint_iterations, scf.backward_failures
    K2_BY_N[tag] = dict(eigh_kernel.launches_by_n)
    med = float(np.median(times))
    print(f"[{label}] {NMOL} x {MOLSIZE} AM1 f32 eps 1e-5, backward 1, "
          f"{'pack_heavy' if pack else 'default flat layout'}: energy + "
          f"gradient to U_ss, zeta_s, R {NMOL / med:.1f} molecules/s "
          f"(median {med:.3f} s of {[round(t, 3) for t in times]}) on "
          f"{card} | adjoint iterations {iters} over {ADJ_REPS} backwards | "
          f"backward failures {fails} | K2 launches {k2} | K3 launches fwd "
          f"{k3[0]} bwd {k3[1]}", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          f"{tag}: non-finite gradients")
    check(fails == 0, f"{tag}: {fails} molecules masked as backward failures")
    check(k2 > 0 and k3[0] > 0 and k3[1] > 0, f"{tag}: K2 {k2}, K3 {k3} "
          "launches")

    m = 256
    res = {}
    for dtype, eps in ((torch.float32, 1.0e-5), (torch.float64, 1.0e-10)):
        _, g = adjoint_step(*adjoint_setup(m, dtype, eps, pack))
        res[dtype] = [t.double() for t in g]
    err = [(a - b).abs().max().item() for a, b in
           zip(res[torch.float32], res[torch.float64])]
    print(f"[{label} f32 vs f64, {m} molecules] |d dHf/dU_ss| {err[0]:.2e} "
          f"| |d dHf/dzeta_s| eV bohr {err[1]:.2e} | |d dHf/dR| eV/A "
          f"{err[2]:.2e}", flush=True)
    for e, tol, what in zip(err, (TOL_G_USS, TOL_G_ZETA, TOL_G_R),
                            ("U_ss", "zeta_s", "R")):
        check(e <= tol, f"{tag} f32 gradient by {what}: error {e} > {tol}")
    return {"molecules_per_s": NMOL / med, "s_per_step": med,
            "adjoint_iterations": iters, "backward_failures": fails,
            "k2_launches": k2, "k3_launches": k3,
            "f32_vs_f64_max_abs": dict(zip(("dU_ss", "dzeta_s", "dR"),
                                           err))}


def hessian_batch(dtype, eps):
    """HESS_NMOL headline molecules (jitter 0.02: exact symmetric
    geometries, CH4 or NH3, have degenerate occupied levels, across which
    a second derivative of eigh divides by their rounding, as
    tests/test_second_order.py notes), backward mode 2 on converger 1."""
    const, tables, cfg, species, coords = headline_setup(
        HESS_NMOL, dtype, eps, 1.0e-4, use_sp2=False)
    return (const, tables, dataclasses.replace(cfg, scf=dataclasses.replace(
        cfg.scf, converger=(1,), backward=2, backward_scan_iters=HESS_ITERS,
        raise_on_forward_failure=False)), species, coords)


def coordinate_hessians(const, tables, cfg, species, coords):
    """(nmol, 24, 24) d2Hf/dR2 per molecule: the gradient with its graph,
    then one backward per coordinate of every molecule at once."""
    import pyseqm_tpu_torch as pt
    x = coords.detach().clone().requires_grad_(True)
    out = pt.energy(const, tables, cfg, species, x)
    (g,) = torch.autograd.grad(out.Hf.sum(), x, create_graph=True)
    n = 3 * x.shape[1]
    g = g.reshape(x.shape[0], n)
    H = torch.stack([torch.autograd.grad(g[:, k].sum(), x,
                                         retain_graph=True)[0].reshape(-1, n)
                     for k in range(n)], dim=1)
    return H.double(), int(out.notconverged.sum().item())


def occupied_gaps(const, tables, cfg, species, coords, idx):
    """The smallest gap between occupied orbital energies (eV) of the
    molecules ``idx``: a second derivative of eigh divides by it."""
    import pyseqm_tpu_torch as pt
    cfg = dataclasses.replace(cfg, eig=True, scf=dataclasses.replace(
        cfg.scf, backward=0))
    out = pt.energy(const, tables, cfg, species[idx], coords[idx])
    nocc = pt.make_system(const, species[idx], coords[idx]).nocc
    return [torch.diff(torch.sort(e[:n]).values).min().item()
            for e, n in zip(out.e, nocc.tolist())]


def phase_hessian(card):
    """Mode-2 Hessians at float64 (K3 float64 and its second derivative)
    and float32 (K2, K3 float32), the float64 one again with the plain
    apply in place of the kernels."""
    from pyseqm_tpu_torch.ops import eigh_kernel, tetci
    from pyseqm_tpu_torch.ops import wapply_kernel as wk
    runs, counts = {}, {}
    for dtype, eps in ((torch.float64, 1.0e-10), (torch.float32, 1.0e-5)):
        setup = hessian_batch(dtype, eps)
        sync()
        k2_reset()
        k3_reset()
        t0 = time.perf_counter()
        H, nc = coordinate_hessians(*setup)
        sync()
        dt = time.perf_counter() - t0
        counts[dtype] = (eigh_kernel.launches, k3_counts())
        if dtype == torch.float32:
            K2_BY_N["hessian"] = dict(eigh_kernel.launches_by_n)
        runs[dtype] = H
        print(f"[20 hessian {str(dtype)[6:]}] {HESS_NMOL} x {MOLSIZE} AM1, "
              f"converger 1, {HESS_ITERS} unrolled iterations: 24x24 "
              f"Hessians in {dt:.2f} s per batch on {card} | unconverged "
              f"{nc} | K2 launches {counts[dtype][0]} | K3 launches fwd "
              f"{counts[dtype][1][0]} bwd {counts[dtype][1][1]}",
              flush=True)
        check(bool(torch.isfinite(H).all()), f"non-finite {dtype} Hessian")
    H64, H32 = runs[torch.float64], runs[torch.float32]
    with patched(tetci, "w_apply", wk.w_apply_reference):
        k3_reset()
        Hp, _ = coordinate_hessians(*hessian_batch(torch.float64, 1.0e-10))
        sync()
        check(k3_counts() == (0, 0), "the plain-apply Hessian launched K3")
    scale = H64.abs().max().item()
    asym = (H64 - H64.transpose(1, 2)).abs().max().item() / scale
    kern = (H64 - Hp).abs().max().item() / Hp.abs().max().item()
    per_mol = H64.abs().amax(dim=(1, 2))
    f32 = ((H32 - H64).abs().amax(dim=(1, 2)) / per_mol)
    worst = torch.argsort(f32, descending=True)[:3]
    gaps = occupied_gaps(*hessian_batch(torch.float64, 1.0e-10), worst)
    sp = hessian_batch(torch.float64, 1.0e-10)[3][worst].cpu().numpy()
    p99 = torch.quantile(f32, 0.99).item()
    print(f"[20 hessian checks] max|H| {scale:.2f} eV/A^2 | f64 asymmetry "
          f"{asym:.1e} of max|H| | f64 kernels vs plain apply {kern:.1e} "
          f"| f32 vs f64 per molecule, of its max|H|: {fmt(f32)} | worst "
          f"molecules (index, Z, error, smallest gap between occupied "
          f"levels in eV): " + ", ".join(
              f"{i} {z[z > 0].tolist()} {f32[i].item():.1e} {g:.2e}"
              for i, z, g in zip(worst.tolist(), sp, gaps)), flush=True)
    check(asym <= TOL_HESS_SYM, f"f64 Hessian asymmetry {asym}")
    check(kern <= TOL_HESS_KERNEL, f"f64 Hessian kernels vs plain {kern}")
    check(p99 <= TOL_HESS_F32_P99 and f32.max().item() <= TOL_HESS_F32_MAX,
          f"f32 Hessian error p99 {p99}, max {f32.max().item()}")
    k3 = tuple(a + b for a, b in zip(counts[torch.float64][1],
                                     counts[torch.float32][1]))
    check(k3[0] > 0 and k3[1] > 0, f"K3 launches on the Hessian path {k3}")
    check(counts[torch.float32][0] > 0, "K2 was not launched on the f32 "
          "Hessian path")
    return {"nmol": HESS_NMOL, "max_abs_H": scale, "f64_asymmetry": asym,
            "f64_kernel_vs_plain": kern, "f32_vs_f64_max": f32.max().item(),
            "f32_vs_f64_p99": p99, "f32_vs_f64_median": f32.median().item(),
            "worst_occupied_gap_eV": gaps[0],
            "k2_launches": counts[torch.float32][0], "k3_launches": k3}


def phase_flat_split(card):
    """The class-segmented flat pair list at full width (hcore_split,
    fock(WPackSplit): K3 on the XX slice, the XH and HH slices plain), the
    scf-eigh configuration; 3 chained energy calls as phase 9."""
    import pyseqm_tpu_torch as pt
    const, tables, cfg, species, coords = headline_setup(
        NMOL, torch.float32, 1.0e-5, 1.0e-4, use_sp2=False)
    cfg = dataclasses.replace(cfg, pack_pairs=True, dense_pair_grid=False)
    out = pt.energy(const, tables, cfg, species, coords)     # warm-up
    check(type(out.w).__name__ == "WPackSplit", f"flat-split ran on "
          f"{type(out.w).__name__}")
    n_xx = out.w.xx.ri.shape[1]
    sync()
    k3_reset()
    nc = 0
    c = coords
    sync()
    t0 = time.perf_counter()
    for _ in range(SCF_REPEATS):
        out = pt.energy(const, tables, cfg, species, c)
        c = c + 1.0e-7 * out.Hf[:, None, None]
        nc += int(out.notconverged.sum().item())
    sync()
    dt = time.perf_counter() - t0
    k3 = k3_counts()
    mps = SCF_REPEATS * NMOL / dt
    print(f"[21 flat-split] {NMOL} x {MOLSIZE} AM1 f32 eps 1e-5, pack_pairs "
          f"with the flat pair list ({n_xx} XX pairs per molecule through "
          f"K3): {mps:.1f} molecules/s ({dt / SCF_REPEATS:.3f} s per call) "
          f"on {card} | notconverged {nc} | K3 launches fwd {k3[0]} bwd "
          f"{k3[1]}", flush=True)
    check(nc == 0, f"{nc} flat-split molecules not converged")
    check(k3[0] > 0, "K3 was not launched on the flat-split path")

    m = 256
    res = {}
    for split in (True, False):
        c_, t_, cfg_, sp_, co_ = headline_setup(m, torch.float64, 1.0e-10,
                                                1.0e-7, use_sp2=False)
        if split:
            cfg_ = dataclasses.replace(cfg_, pack_pairs=True,
                                       dense_pair_grid=False)
        f, o = pt.force(c_, t_, cfg_, sp_, co_)
        check(type(o.w).__name__ == ("WPackSplit" if split
                                     else "WPackGridSplit"),
              f"layout {type(o.w).__name__}")
        res[split] = (o.Hf, f)
    dh = (res[True][0] - res[False][0]).abs().max().item()
    df = (res[True][1] - res[False][1]).abs().max().item()
    print(f"[21 flat-split vs packed dense grid, {m} molecules f64] |dHf| "
          f"{dh:.2e} eV | |dF| {df:.2e} eV/A", flush=True)
    check(dh <= TOL_SPLIT_HF and df <= TOL_SPLIT_F,
          f"flat-split vs dense grid: |dHf| {dh}, |dF| {df}")
    return {"molecules_per_s": mps, "s_per_call": dt / SCF_REPEATS,
            "k3_launches": k3, "xx_pairs": n_xx, "dHf_vs_dense": dh,
            "dF_vs_dense": df}


def phase_convergers():
    """Converger (0, 0.0), (1,) and (2,) on 256 headline molecules at
    float64 reach one Hf (tests/test_aux.py)."""
    import pyseqm_tpu_torch as pt
    hf = {}
    for conv in ((0, 0.0), (1,), (2,)):
        const, tables, cfg, species, coords = headline_setup(
            256, torch.float64, 1.0e-10, 1.0e-7, use_sp2=False)
        cfg = dataclasses.replace(cfg, scf=dataclasses.replace(
            cfg.scf, converger=conv, max_iter=1000))
        hf[conv] = pt.energy(const, tables, cfg, species, coords).Hf
    d = {str(c): (h - hf[(2,)]).abs().max().item() for c, h in hf.items()
         if c != (2,)}
    print(f"[22 convergers, 256 molecules f64] max |Hf - Hf(2,)| eV: "
          + " | ".join(f"{c} {e:.1e}" for c, e in d.items()), flush=True)
    check(max(d.values()) <= TOL_CONV, f"convergers disagree: {d}")
    return d


def kernel_counts():
    """(K1, K2, K3 forward, K3 backward) launch counters."""
    from pyseqm_tpu_torch.ops import eigh_kernel, sp2_kernel
    return (sp2_kernel.launches, eigh_kernel.launches) + k3_counts()


def kernels_reset():
    from pyseqm_tpu_torch.ops import sp2_kernel
    sp2_kernel.launches = 0
    k2_reset()
    k3_reset()


def bomd_setup(nmol, dtype, names=None, jitter=0.02, eps=1.0e-4,
               row3=False, strict=True, sp2_eps=1.0e-4, device=None):
    """``bench.py --config bomd``'s batch and configuration (also opt's,
    with jitter 0.05, and scf-row3's, with the row-3 names and eps 1e-5):
    AM1, SP2 at sp2_eps 1e-4 (float64 references: 1e-7, as phase 7) on
    the static packed layout.  ``strict``: an
    unconverged SCF raises (the optimizers' trial steps may not converge
    and are rejected by the line search instead).  ``device``: DEV unless
    given."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.scf import SCFConfig
    from pyseqm_tpu_torch.utils.molecules import make_batch
    device = device or DEV
    sp, co = make_batch(nmol, MOLSIZE, jitter=jitter, names=names)
    const, tables, cfg = pt.build(
        "AM1", dtype=dtype, device=device, row3=row3,
        scf=SCFConfig(eps=eps, converger=(2,), use_sp2=True, sp2_eps=sp2_eps,
                      max_iter=200, pack_heavy=pt.packed_heavy_count(sp),
                      raise_on_forward_failure=strict))
    species = torch.tensor(sp, dtype=torch.long, device=device)
    coords = torch.tensor(co.astype(np.float32), dtype=dtype, device=device)
    return const, tables, cfg, species, coords


def langevin_noise(md, species, state):
    """The random force of one Langevin step at ``state`` divided by its
    per-atom scale, on the real atoms: the force with the step's draw less
    the force with a zero draw.  Also returns the draw itself."""
    from pyseqm_tpu_torch.drivers.md import FR_SCALE, atom_masses
    draws = []
    orig = md.random_normal

    def keep(st, shape):
        draws.append(orig(st, shape))
        return draws[-1]
    with patched(md, "random_normal", keep):
        F, _, _ = md.compute_force(species, state)
    with patched(md, "random_normal",
                 lambda st, shape: torch.zeros_like(draws[0])):
        F0, _, _ = md.compute_force(species, state)
    cfg = md.md_cfg
    scale = FR_SCALE * torch.sqrt(2.0 * cfg.temperature
                                  * atom_masses(md.const, species)
                                  / cfg.timestep / cfg.damp)
    real = (species > 0)[..., None].expand_as(F)
    return ((F - F0) / scale)[real].double(), draws[0][real].double()


def phase_bomd(card):
    """``bench.py --config bomd``: Langevin NVT at full width, one SCF (K1
    in every iteration, K3 in every Fock) and one force backward (K3) per
    step; steps/s over BOMD_STEPS timed steps after BOMD_WARMUP."""
    from pyseqm_tpu_torch.drivers.md import LangevinDynamics, MDConfig
    const, tables, cfg, species, coords = bomd_setup(NMOL, torch.float32)
    md = LangevinDynamics(const, tables, cfg,
                          MDConfig(timestep=0.4, damp=20.0,
                                   temperature=300.0),
                          generator=torch.Generator(DEV).manual_seed(0))
    state = md.initialize(species, coords, Temp=300.0)
    for _ in range(BOMD_WARMUP):
        state, obs = md.step(species, state)
    sync()
    kernels_reset()
    t0 = time.perf_counter()
    for _ in range(BOMD_STEPS):
        state, obs = md.step(species, state)
    sync()
    dt = time.perf_counter() - t0
    n = kernel_counts()
    k1, k3 = n[0] / BOMD_STEPS, [c / BOMD_STEPS for c in n[2:]]
    polish = 8                           # SCFConfig.polish_iters auto, f32
    finite = bool(torch.isfinite(state.coordinates).all()
                  and torch.isfinite(state.velocities).all()
                  and torch.isfinite(obs.Epot).all())
    z, draw = langevin_noise(md, species, state)
    mean, var = z.mean().item(), z.var().item()
    dz = (z - draw).abs().max().item()
    sps = BOMD_STEPS / dt
    print(f"[24 bomd] {NMOL} x {MOLSIZE} AM1 f32 Langevin dt 0.4 damp 20 "
          f"300 K, SCF eps 1e-4 SP2 packed: {sps:.3f} steps/s "
          f"({1e3 * dt / BOMD_STEPS:.1f} ms/step) on {card} | SCF "
          f"iterations per step {k1 - polish:g} + {polish} polish | K1 "
          f"launches per step {k1:g} | K3 per step fwd {k3[0]:g} bwd "
          f"{k3[1]:g} | notconverged 0 (raise_on_forward_failure) | finite "
          f"{finite} | mean T {obs.T.mean().item():.1f} K", flush=True)
    print(f"[24 bomd random force / scale] {z.numel()} real components: "
          f"mean {mean:.2e} variance {var:.4f} | against the draw max "
          f"{dz:.1e}", flush=True)
    check(finite, "bomd: non-finite state")
    check(n[0] > 0 and n[2] > 0 and n[3] > 0, f"bomd launches {n}")
    check(abs(mean) <= 0.01 and abs(var - 1.0) <= 0.01,
          f"bomd random force: mean {mean}, variance {var}")
    return {"steps_per_s": sps, "ms_per_step": 1e3 * dt / BOMD_STEPS,
            "scf_iterations_per_step": k1 - polish,
            "k1_launches": n[0], "k1_per_step": k1, "k3_launches": n[2:],
            "k3_per_step": k3, "noise_mean": mean, "noise_var": var,
            "noise_components": z.numel()}


def nvt_run(card, md, species, coords, velocities, gen, equil, sample, tag):
    """Equilibrate ``equil`` steps (from Maxwell-Boltzmann velocities at
    300 K unless ``velocities`` are given), then the ensemble mean T over
    ``sample`` steps and its per-molecule spread; returns the result and
    the final state."""
    state = md.initialize(species, coords, velocities, generator=gen,
                          Temp=300.0)
    sync()
    kernels_reset()
    t0 = time.perf_counter()
    Ts = []
    for i in range(equil + sample):
        state, obs = md.step(species, state)
        if i >= equil:
            Ts.append(obs.T)
    sync()
    dt = time.perf_counter() - t0
    n = kernel_counts()
    T = torch.stack(Ts).double()
    mean = T.mean().item()
    per_mol = T.mean(dim=0)
    q = torch.quantile(per_mol, torch.tensor([0.05, 0.5, 0.95],
                                             dtype=T.dtype, device=T.device))
    finite = bool(torch.isfinite(state.coordinates).all()
                  and torch.isfinite(T).all())
    print(f"[25 nvt {tag}] {species.shape[0]} molecules, {equil} steps "
          f"then {sample} sampled: ensemble mean T {mean:.2f} K | "
          f"per-molecule mean T p5 / p50 / p95 "
          f"{' / '.join(f'{v:.1f}' for v in q.tolist())} K | "
          f"{(equil + sample) / dt:.3f} steps/s on {card} | K1 {n[0]} K3 "
          f"fwd {n[2]} bwd {n[3]} | finite {finite}", flush=True)
    check(finite, f"nvt {tag}: non-finite state")
    check(abs(mean - 300.0) <= TOL_NVT_T, f"nvt {tag}: mean T {mean} K")
    check(n[0] > 0 and n[2] > 0 and n[3] > 0, f"nvt {tag} launches {n}")
    return {"mean_T": mean, "per_molecule_T_p5_p50_p95": q.tolist(),
            "steps_per_s": (equil + sample) / dt, "k1_launches": n[0],
            "k3_launches": n[2:]}, state


def phase_nvt(card):
    """Langevin (damp 10 fs, dt 0.5) and Nose-Hoover (tau 10 fs, dt 0.4)
    at 300 K on NVT_NMOL headline molecules, the bomd SCF: 5 damping
    times (5 tau) of equilibration, then the ensemble mean T
    (tests/test_md.py::test_langevin_and_thermostats and
    tests/test_aux.py::test_nose_hoover_nvt at full width).  Langevin
    starts from Maxwell-Boltzmann velocities at the optimized geometries;
    Nose-Hoover from the end of the Langevin run, an ensemble at 300 K,
    and samples one period of its chains' oscillation.  Every chain
    starts at rest, so the chains of all molecules move in phase and the
    ensemble mean T swings at the chain's period, 2 pi tau / sqrt(2):
    started cold it read 261.5 K over steps 126-165 (a card run), and
    from the Langevin ensemble still +-25 K over 40-step windows (a CPU
    run of 256 molecules), 285.4 K over steps 126-165 (a card run)."""
    from pyseqm_tpu_torch.drivers.md import (LangevinDynamics, MDConfig,
                                             NoseHooverDynamics)
    const, tables, cfg, species, coords = bomd_setup(NVT_NMOL, torch.float32)
    lang = LangevinDynamics(const, tables, cfg,
                            MDConfig(timestep=0.5, damp=10.0,
                                     temperature=300.0))
    nh = NoseHooverDynamics(const, tables, cfg,
                            MDConfig(timestep=0.4, temperature=300.0),
                            tau=10.0)
    out, st = nvt_run(card, lang, species, coords, None,
                      torch.Generator(DEV).manual_seed(1), 100, NVT_SAMPLE,
                      "langevin")
    out_nh, _ = nvt_run(card, nh, species, st.coordinates, st.velocities,
                        None, 125, NH_SAMPLE, "nose-hoover")
    return {"langevin": out, "nose_hoover": out_nh}


def phase_opt(card):
    """``bench.py --config opt`` and ``opt-conv`` in one run: the warm
    batched L-BFGS (chunk 10, force_tol 1e-3) on OPT_NMOL molecules
    (jitter 0.05) for its first OPT_ITERS iterations: molecule-iterations/s,
    and the molecules converged by then per second; no molecule's Hf
    rises."""
    from pyseqm_tpu_torch.drivers.opt import make_lbfgs_warm
    const, tables, cfg, species, coords = bomd_setup(OPT_NMOL, torch.float32,
                                                     jitter=0.05,
                                                     strict=False)
    import pyseqm_tpu_torch as pt
    E0 = pt.energy(const, tables, cfg, species, coords).Hf
    init, run = make_lbfgs_warm(const, tables, cfg, species, chunk=10,
                                force_tol=1.0e-3)
    state = init(coords)
    sync()
    kernels_reset()
    t0 = time.perf_counter()
    while state.nit < OPT_ITERS and not bool(state.done.all()):
        state, _, _ = run(state)
    sync()
    dt = time.perf_counter() - t0
    n = kernel_counts()
    gerr = state.g.abs().amax(dim=-1)
    ncv = int((gerr <= 1.0e-3).sum())
    frozen = int(state.done.sum()) - ncv
    rise = (state.E - E0).max().item()
    finite = bool(torch.isfinite(state.x).all() and torch.isfinite(state.E)
                  .all())
    mips = OPT_NMOL * state.nit / dt
    print(f"[26 opt] {OPT_NMOL} x {MOLSIZE} AM1 f32 warm L-BFGS chunk 10 "
          f"force_tol 1e-3: {mips:.1f} molecule-iterations/s over the first "
          f"{state.nit} iterations ({dt:.2f} s) on {card}", flush=True)
    print(f"[26 opt-conv] {state.nit} iterations in {dt:.2f} s: "
          f"{ncv} converged to max|g| <= 1e-3 ({ncv / dt:.1f} converged "
          f"molecules/s), {frozen} frozen by forced accepts, "
          f"{OPT_NMOL - ncv - frozen} still running | largest Hf rise "
          f"{rise:.2e} eV | K1 {n[0]} K3 fwd {n[2]} bwd {n[3]} | finite "
          f"{finite}", flush=True)
    check(finite, "opt: non-finite state")
    check(rise <= TOL_OPT_RISE, f"opt: an Hf rose by {rise} eV")
    check(n[0] > 0 and n[2] > 0 and n[3] > 0, f"opt launches {n}")
    return {"molecule_iterations_per_s": mips, "iterations_timed": state.nit,
            "converged_molecules_per_s": ncv / dt, "iterations": state.nit,
            "converged": ncv, "frozen_forced": frozen, "s": dt,
            "largest_hf_rise": rise, "k1_launches": n[0],
            "k3_launches": n[2:]}


def phase_opt_sd(card):
    """``bench.py --config opt-sd``: chunked steepest descent (chunk 20,
    alpha 0.004, force_tol 0), 60 force evaluations on the opt batch."""
    from pyseqm_tpu_torch.drivers.opt import geometry_optimize_sd
    const, tables, cfg, species, coords = bomd_setup(OPT_NMOL, torch.float32,
                                                     jitter=0.05,
                                                     strict=False)
    sync()
    kernels_reset()
    t0 = time.perf_counter()
    x, ferr, dE = geometry_optimize_sd(const, tables, cfg, species, coords,
                                       alpha=0.004, force_tol=0.0,
                                       max_evl=60, chunk=20)
    sync()
    dt = time.perf_counter() - t0
    n = kernel_counts()
    mes = OPT_NMOL * 60 / dt
    finite = bool(torch.isfinite(x).all())
    print(f"[27 opt-sd] {OPT_NMOL} x {MOLSIZE} AM1 f32 SD chunk 20, 60 "
          f"evaluations: {mes:.1f} molecule-evaluations/s ({dt:.2f} s) on "
          f"{card} | final max|F| {float(ferr):.3e} eV/A, mean dE "
          f"{float(dE):.2e} eV | K1 {n[0]} K3 fwd {n[2]} bwd {n[3]} | finite "
          f"{finite}", flush=True)
    check(finite, "opt-sd: non-finite geometry")
    check(n[0] > 0 and n[2] > 0 and n[3] > 0, f"opt-sd launches {n}")
    return {"molecule_evaluations_per_s": mes, "s": dt,
            "final_max_force": float(ferr), "k1_launches": n[0],
            "k3_launches": n[2:]}


def hcore_launches(const, tables, cfg, species, coords):
    """Kernel launches of one Hcore build (the integral stack's forward)
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from pyseqm_tpu_torch.models.energy import (_atom_parameters,
                                                _integral_stack,
                                                _packed_layout,
                                                _resolve_pair_layout,
                                                check_species)
    from pyseqm_tpu_torch.system import make_system
    sp = check_species(cfg, tables, species)
    A = species.shape[1]
    _, K = _resolve_pair_layout(cfg, A)
    n_st = _packed_layout(cfg, A)[1]
    for _ in range(2):          # the first profile pays the tracer start-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                torch.no_grad():
            s = make_system(const, species, coords, None,
                            cfg.pair_outer_cutoff, heavy_count=K,
                            species_host=sp)
            p = _atom_parameters(tables, cfg.method, s, None, coords)
            _integral_stack(const, s, p, cfg, packed_m=n_st)
            sync()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cudaLaunch"))


def phase_scf_row3(card):
    """``bench.py --config scf-row3``: the headline batch with 25% H2S and
    CH3SH (ROW3_NAMES), AM1 f32 with row3, SP2 at eps 1e-5, packed;
    molecules/s over 3 chained energy calls, float32 against float64 on
    the first 256 molecules, and the launches of one row-3 Hcore build
    beside a row-1/2 one."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.utils.molecules import ROW3_NAMES
    setup = bomd_setup(NMOL, torch.float32, names=ROW3_NAMES, eps=1.0e-5,
                       row3=True)
    nsulfur = int((setup[3] == 16).any(dim=1).sum())

    def chained(const, tables, cfg, species, coords):
        out = pt.energy(const, tables, cfg, species, coords)     # warm-up
        sync()
        kernels_reset()
        nc, c = 0, coords
        t0 = time.perf_counter()
        for _ in range(SCF_REPEATS):
            out = pt.energy(const, tables, cfg, species, c)
            c = c + 1.0e-7 * out.Hf[:, None, None]
            nc += int(out.notconverged.sum().item())
        sync()
        dt = time.perf_counter() - t0
        check(bool(torch.isfinite(out.Hf).all()), "non-finite scf Hf")
        return SCF_REPEATS * NMOL / dt, dt, nc, kernel_counts()

    # the same SCF on the row-1/2 headline batch, for comparison
    head = bomd_setup(NMOL, torch.float32, eps=1.0e-5)
    mps_row12 = chained(*head)[0]
    mps, dt, nc, n = chained(*setup)
    ln_row3 = hcore_launches(*setup)
    ln_row12 = hcore_launches(*head)
    print(f"[28 scf-row3] {NMOL} x {MOLSIZE} AM1 f32 row3 ({nsulfur} "
          f"molecules with S), SP2 eps 1e-5 packed: {mps:.1f} molecules/s "
          f"({dt / SCF_REPEATS:.3f} s per call) on {card} | the row-1/2 "
          f"headline batch {mps_row12:.1f} | notconverged {nc} | K1 {n[0]} "
          f"K3 fwd {n[2]} | launches of one Hcore build: row 3 {ln_row3}, "
          f"row 1-2 {ln_row12}", flush=True)
    check(nc == 0, f"{nc} scf-row3 molecules not converged")
    check(n[0] > 0 and n[2] > 0, f"scf-row3 launches {n}")

    m = 256
    res = {}
    for dtype, eps, sp2_eps in ((torch.float32, 1.0e-5, 1.0e-4),
                                (torch.float64, 1.0e-10, 1.0e-7)):
        c_, t_, cfg_, sp_, co_ = bomd_setup(m, dtype, names=ROW3_NAMES,
                                            eps=eps, row3=True,
                                            sp2_eps=sp2_eps)
        f, o = pt.force(c_, t_, cfg_, sp_, co_)
        res[dtype] = (o.Hf.double(), f.double())
    dh = (res[torch.float32][0] - res[torch.float64][0]).abs().max().item()
    df = (res[torch.float32][1] - res[torch.float64][1]).abs().max().item()
    print(f"[28 scf-row3 f32 vs f64, {m} molecules] |dHf| {dh:.2e} eV | "
          f"|dF| {df:.2e} eV/A", flush=True)
    check(dh <= TOL_HF and df <= TOL_F, f"scf-row3 f32: |dHf| {dh}, |dF| "
          f"{df}")
    return {"molecules_per_s": mps, "s_per_call": dt / SCF_REPEATS,
            "row12_molecules_per_s": mps_row12,
            "k1_launches": n[0], "k3_launches": n[2:],
            "hcore_launches_row3": ln_row3,
            "hcore_launches_row12": ln_row12, "f32_vs_f64_dHf": dh,
            "f32_vs_f64_dF": df}


def h2s(bond, angle_deg):
    ang = np.deg2rad(angle_deg)
    co = np.zeros((1, 4, 3))
    co[0, 1] = [bond, 0.0, 0.0]
    co[0, 2] = [bond * np.cos(ang), bond * np.sin(ang), 0.0]
    return (torch.tensor([[16, 1, 1, 0]], device=DEV),
            torch.tensor(co, dtype=torch.float64, device=DEV))


def phase_row3_pin(card):
    """Stewart's published PM3 H2S at float64 on the card: Hf at the
    published geometry, then the warm L-BFGS from (1.42 A, 99 deg) to the
    published geometry; MNDO and AM1 into tests/test_row3.py's windows."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.drivers.opt import geometry_optimize_lbfgs
    from pyseqm_tpu_torch.scf import SCFConfig
    kernels_reset()
    out = {}
    for method in ("PM3", "MNDO", "AM1"):
        const, tables, cfg = pt.build(
            method, dtype=torch.float64, device=DEV, row3=True,
            scf=SCFConfig(eps=1.0e-10, converger=(2,)))
        if method == "PM3":
            f, o = pt.force(const, tables, cfg, *h2s(1.2903, 93.51))
            out["hf_kcal"] = float(o.Hf[0]) * 23.060907
            out["max_force"] = float(f.abs().max())
        x, ferr, nit = geometry_optimize_lbfgs(
            const, tables, cfg, *h2s(1.42, 99.0), force_tol=2.0e-4,
            max_evl=120, chunk=10)
        x = x[0].double().cpu().numpy()
        r = [float(np.linalg.norm(x[k] - x[0])) for k in (1, 2)]
        ang = float(np.rad2deg(np.arccos(np.dot(x[1] - x[0], x[2] - x[0])
                                         / (r[0] * r[1]))))
        out[method] = {"r": r, "angle": ang, "iterations": nit,
                       "max_grad": float(ferr)}
    n = kernel_counts()
    pm3 = out["PM3"]
    print(f"[29 row3 pin, f64] PM3 H2S at 1.2903 A / 93.51 deg: Hf "
          f"{out['hf_kcal']:.4f} kcal/mol (published -0.913), max|F| "
          f"{out['max_force']:.1e} | L-BFGS from 1.42 A / 99 deg: "
          + " | ".join(f"{m} r {v['r'][0]:.4f} {v['r'][1]:.4f} A angle "
                       f"{v['angle']:.2f} deg ({v['iterations']} iterations)"
                       for m, v in out.items() if isinstance(v, dict))
          + f" | K3 fwd {n[2]} bwd {n[3]}", flush=True)
    check(abs(out["hf_kcal"] + 0.913) < 0.05 and out["max_force"] < 5.0e-3,
          f"PM3 H2S at the published geometry: {out['hf_kcal']} kcal/mol, "
          f"max|F| {out['max_force']}")
    check(all(abs(v - 1.2903) < 2.0e-3 for v in pm3["r"])
          and abs(pm3["angle"] - 93.51) < 0.2, f"PM3 H2S optimum {pm3}")
    for m in ("MNDO", "AM1"):
        v = out[m]
        check(all(1.28 < r < 1.40 for r in v["r"])
              and 89.0 < v["angle"] < 100.0, f"{m} H2S optimum {v}")
    check(n[2] > 0 and n[3] > 0, f"row3 pin launches {n}")
    out["k3_launches"] = n[2:]
    return out


def ml_setup(method, nmol, dtype, eps, sp2_eps, use_sp2=True, **scf):
    """``bench.py --config xlbomd-ml(-trained)``'s batch and configuration
    (the first nmol molecules): the headline SCF and layout with
    ``method``; float64 references at eps 1e-10 and sp2_eps 1e-7."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.scf import SCFConfig
    from pyseqm_tpu_torch.utils.molecules import make_batch
    sp, co = make_batch(NMOL, MOLSIZE, jitter=0.02)
    sp, co = sp[:nmol], co[:nmol]
    const, tables, cfg = pt.build(
        method, dtype=dtype, device=DEV,
        scf=SCFConfig(eps=eps, converger=(2,), use_sp2=use_sp2,
                      sp2_eps=sp2_eps, max_iter=200,
                      pack_heavy=pt.packed_heavy_count(sp),
                      raise_on_forward_failure=True, **scf))
    species = torch.tensor(sp, dtype=torch.long, device=DEV)
    coords = torch.tensor(co.astype(np.float32), dtype=dtype, device=DEV)
    return const, tables, cfg, species, coords


def ml_xl_drift(const, tables, cfg, species, coords, learned):
    """Per-molecule max |Etot - Etot(warm-up end)| over ML_STEPS XL steps
    after the bootstrap and WARMUP steps (no timing)."""
    from pyseqm_tpu_torch.drivers.md import MDConfig
    from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5,
                learned=learned)
    state = md.initialize(species, coords,
                          velocities=torch.zeros_like(coords),
                          initial_force=False)
    etots = []
    for _ in range(WARMUP + ML_STEPS):
        state, obs = md.step(species, state)
        etots.append((obs.Ek + obs.Epot).double())
    e = torch.stack(etots)
    return (e[WARMUP:] - e[WARMUP - 1][None]).abs().amax(dim=0)


def ml_xl_run(card, label, const, tables, cfg, species, coords, learned,
              tol_drift=TOL_DRIFT):
    """XL-BOMD (k=5, 0.4 fs) with per-atom parameters from ``learned``
    evaluated inside every force: the bootstrap SCF, WARMUP steps, then
    ML_STEPS timed; steps/s, the launches and device kernel time of one
    profiled step against the timed step, K1/K3 launches, and the energy
    drift over the timed steps (at most ``tol_drift``).  Returns the
    results and the per-molecule drift.  The counters are reset first and
    read last."""
    from pyseqm_tpu_torch.drivers.md import MDConfig
    from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5,
                learned=learned)
    kernels_reset()
    sync()
    t0 = time.perf_counter()
    state = md.initialize(species, coords,
                          velocities=torch.zeros_like(coords),
                          initial_force=False)
    sync()
    t_boot = time.perf_counter() - t0
    boot = kernel_counts()
    for _ in range(WARMUP):
        state, obs = md.step(species, state)
    e_ref = (obs.Ek + obs.Epot).double()
    etots = []
    sync()
    n0 = kernel_counts()
    t0 = time.perf_counter()
    for _ in range(ML_STEPS):
        state, obs = md.step(species, state)
        etots.append(obs.Ek + obs.Epot)
    sync()
    dt = time.perf_counter() - t0
    per_step = [(b - a) / ML_STEPS for a, b in zip(n0, kernel_counts())]
    per_mol = (torch.stack(etots).double() - e_ref[None]).abs().amax(dim=0)
    drift = per_mol.max().item()
    finite = bool(torch.isfinite(state.coordinates).all()
                  and torch.isfinite(torch.stack(etots)).all())
    step_ms = 1e3 * dt / ML_STEPS
    launches, dev_ms = profile_step(md, species, state)
    n = kernel_counts()
    sps = ML_STEPS / dt
    print(f"[{label}] {species.shape[0]} x {MOLSIZE} {cfg.method} f32 k=5 "
          f"dt=0.4, learned parameters every step: bootstrap SCF "
          f"{t_boot:.3f} s (K1 {boot[0]}), notconverged 0 "
          f"(raise_on_forward_failure) | {sps:.3f} steps/s ({step_ms:.1f} "
          f"ms/step) on {card} | per step K1 {per_step[0]:g} K3 fwd "
          f"{per_step[2]:g} bwd {per_step[3]:g} | one profiled step: "
          f"{launches} kernel launches, device kernel time {dev_ms:.1f} ms "
          f"(device busy share {dev_ms / step_ms:.3f}) | |Etot - "
          f"Etot(warm-up end)| per molecule eV {fmt(per_mol)} | finite "
          f"{finite}", flush=True)
    check(finite, f"{label}: non-finite MD state")
    check(drift <= tol_drift, f"{label}: energy drift {drift} > {tol_drift}")
    check(n[0] > 0 and n[2] > 0 and n[3] > 0, f"{label}: launches {n}")
    return {"steps_per_s": sps, "ms_per_step": step_ms,
            "bootstrap_s": t_boot, "drift_max_eV": drift,
            "launches_per_step": launches, "device_ms_per_step": dev_ms,
            "device_busy_share": dev_ms / step_ms,
            "k1_per_step": per_step[0], "k3_per_step": per_step[2:],
            "k1_launches": n[0], "k2_launches": n[1], "k3_launches": n[2:]}, \
        per_mol


def phase_xlbomd_ml_trained(card):
    """``bench.py --config xlbomd-ml-trained`` at full width: PM3 with the
    reference's trained HIP-NN model predicting nine parameters of every
    atom inside each force (autograd carries dp/dx into the force); then
    float32 against float64 on the first 256 molecules: the network's
    parameters, the float32 network inside the float64 force, and the
    whole float32 path (beside the PM3 table's own float32 path), and the
    XL drift of the same molecules at float64 against the float32 run's.

    The drift bound is TOL_DRIFT_HIPNN, not the headline's TOL_DRIFT: the
    trained model's surface carries a Verlet error at dt 0.4 fs that the
    float64 dynamics show too (see the bounds' comment)."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.models.hipnn import make_hipnn_callable
    setup = ml_setup("PM3", NMOL, torch.float32, 1.0e-5, 1.0e-4)
    res, drift32 = ml_xl_run(
        card, "30 xlbomd-ml-trained", *setup,
        make_hipnn_callable(dtype=torch.float32, device=DEV),
        TOL_DRIFT_HIPNN)
    n = 256
    drift64 = ml_xl_drift(*ml_setup("PM3", n, torch.float64, 1.0e-10,
                                    1.0e-7),
                          make_hipnn_callable(dtype=torch.float64,
                                              device=DEV))
    ddrift = (drift32[:n] - drift64).abs().max().item()
    print(f"[30 drift f32 vs f64, {n} molecules] f64 max "
          f"{drift64.max().item():.3e} eV, f32 max "
          f"{drift32[:n].max().item():.3e} eV, per molecule max |d32 - d64| "
          f"{ddrift:.2e} eV", flush=True)
    check(ddrift <= TOL_DRIFT_F32, f"xlbomd-ml-trained: the f32 drift "
          f"departs from the f64 drift by {ddrift} > {TOL_DRIFT_F32}")
    res.update(drift_f64_max_eV=drift64.max().item(),
               drift_f32_vs_f64_max_eV=ddrift)
    runs = {}
    for dtype, eps, sp2_eps in ((torch.float32, 1.0e-5, 1.0e-4),
                                (torch.float64, 1.0e-10, 1.0e-7)):
        const, tables, cfg, species, coords = ml_setup("PM3", n, dtype, eps,
                                                       sp2_eps)
        net = make_hipnn_callable(dtype=dtype, device=DEV)
        with torch.no_grad():
            p = net(species, coords)
        f, out = pt.force(const, tables, cfg, species, coords, learned=net)
        ft, outt = pt.force(const, tables, cfg, species, coords)
        runs[dtype] = (p, f.double(), out.Hf.double(), ft.double(),
                       outt.Hf.double())
    # the float32 network inside the float64 force (the setup of the last,
    # float64, run)
    net32 = make_hipnn_callable(dtype=torch.float32, device=DEV)
    fm, outm = pt.force(const, tables, cfg, species, coords,
                        learned=lambda s, c: {k: v.double() for k, v in
                                              net32(s, c.float()).items()})
    (p32, f32, h32, ft32, ht32), (p64, f64, h64, ft64, ht64) = (
        runs[torch.float32], runs[torch.float64])
    perr = {k: (p32[k].double() - p64[k]).abs().max().item() for k in p64}
    prel = max(perr[k] / p64[k].abs().max().item() for k in p64)
    err = {"net_in_f64_dHf": (outm.Hf - h64).abs().max().item(),
           "net_in_f64_dF": (fm - f64).abs().max().item(),
           "dHf": (h32 - h64).abs().max().item(),
           "dF": (f32 - f64).abs().max().item(),
           "table_dHf": (ht32 - ht64).abs().max().item(),
           "table_dF": (ft32 - ft64).abs().max().item()}
    print(f"[30 accuracy f32 vs f64, {n} molecules] HIP-NN parameters max "
          f"abs error " + " ".join(f"{k} {v:.2e}" for k, v in perr.items())
          + f" (largest relative {prel:.2e}) | the f32 network in the f64 "
          f"force: |dHf| {err['net_in_f64_dHf']:.2e} eV |dF| "
          f"{err['net_in_f64_dF']:.2e} eV/A | the whole f32 path: |dHf| "
          f"{err['dHf']:.2e} eV |dF| {err['dF']:.2e} eV/A | the PM3 table's "
          f"f32 path: |dHf| {err['table_dHf']:.2e} eV |dF| "
          f"{err['table_dF']:.2e} eV/A", flush=True)
    check(bool(torch.isfinite(h32).all() and torch.isfinite(f32).all()),
          "xlbomd-ml-trained: non-finite f32 results")
    check(prel <= TOL_ML_PARAM, f"HIP-NN f32 parameters: relative error "
          f"{prel} > {TOL_ML_PARAM}")
    check(err["net_in_f64_dHf"] <= TOL_HF and err["net_in_f64_dF"] <= TOL_F,
          f"the f32 HIP-NN in the f64 force: {err}")
    check(err["dHf"] <= TOL_HF_PM3 and err["dF"] <= TOL_F_PM3,
          f"the f32 HIP-NN PM3 path against f64: {err}")
    res.update(param_max_abs_err=perr, param_max_rel_err=prel,
               f32_vs_f64=err)
    return res


def phase_xlbomd_ml(card):
    """``bench.py --config xlbomd-ml`` at full width: AM1 with the
    random-init parameter network (models/ml.py, a generator seeded 7);
    first bench.py's own check (learned against table Hf on 64 molecules,
    bench.py:89-98), then the XL run."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.models.ml import (init_param_model,
                                            make_learned_callable)
    const, tables, cfg, species, coords = ml_setup("AM1", NMOL, torch.float32,
                                                   1.0e-5, 1.0e-4)
    weights = init_param_model(tables, torch.Generator(DEV).manual_seed(7))
    learned = make_learned_callable(weights, tables)
    with torch.no_grad():
        e_tab = pt.energy(const, tables, cfg, species[:64], coords[:64]).Hf
        e_ml = pt.energy(const, tables, cfg, species[:64], coords[:64],
                         learned=learned).Hf
    d = (e_tab - e_ml).abs().max().item()
    print(f"[31 xlbomd-ml] learned-vs-table max |dHf| = {d:.4f} eV over 64 "
          f"molecules", flush=True)
    check(bool(torch.isfinite(e_ml).all()) and d > 1.0e-4,
          f"xlbomd-ml: the learned parameters had no effect (max dHf {d})")
    res, _ = ml_xl_run(card, "31 xlbomd-ml", const, tables, cfg, species,
                       coords, learned)
    res["learned_vs_table_max_dHf"] = d
    return res


def phase_ml_hooks(card):
    """The Kbeta and g_ss_nuc hooks on ML_HOOK_NMOL headline molecules
    (AM1), on the packed class-segmented dense grid (hcore_dense_split,
    SP2) and on the default flat layout (eigh): Kbeta = 1 reproduces the
    hook-free Hf; a random Kbeta in [0.9, 1.1] (numpy seed 5) at float32
    against float64; the table's g_ss as g_ss_nuc reproduces the default
    Enuc; energy_xl at the converged density with both hooks gives
    energy()'s Enuc.

    The flat layout's Hcore and Fock builds sum per atom with index_add,
    whose CUDA version adds in an order that changes from run to run: two
    runs of one float32 SCF of these molecules differ by up to ~1.75e-4
    eV there on an H100.  The identities and the Kbeta runs are computed
    under torch.use_deterministic_algorithms (a deterministic index_add),
    so each reading repeats from run to run; the run-to-run difference of
    the ordinary mode is printed beside them."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.models.xlbomd import energy_xl
    from pyseqm_tpu_torch.ops.density import static_pack_mat
    from pyseqm_tpu_torch.ops import eigh_kernel
    n = ML_HOOK_NMOL
    kernels_reset()
    out = {}
    rng = np.random.default_rng(5)
    kb_np = rng.uniform(0.9, 1.1, (n, MOLSIZE * (MOLSIZE - 1) // 2, 4))
    for layout, pack in (("packed", True), ("flat", False)):
        runs = {}
        for dtype, eps, sp2_eps in ((torch.float32, 1.0e-5, 1.0e-4),
                                    (torch.float64, 1.0e-10, 1.0e-7)):
            const, tables, cfg, species, coords = headline_setup(
                n, dtype, eps, sp2_eps, use_sp2=pack, pack=pack)
            kb = torch.tensor(kb_np, dtype=dtype, device=DEV)
            with deterministic():
                f, o = pt.force(const, tables, cfg, species, coords,
                                learned={"Kbeta": kb})
            runs[dtype] = (f.double(), o.Hf.double())
        # float32 from here on: the setup of the last float32 run
        const, tables, cfg, species, coords = headline_setup(
            n, torch.float32, 1.0e-5, 1.0e-4, use_sp2=pack, pack=pack)
        kb = torch.tensor(kb_np, dtype=torch.float32, device=DEV)
        with torch.no_grad():
            again = pt.energy(const, tables, cfg, species, coords)
            with deterministic():
                base = pt.energy(const, tables, cfg, species, coords)
                ones = pt.energy(const, tables, cfg, species, coords,
                                 learned={"Kbeta": torch.ones_like(kb)})
                gss = pt.energy(
                    const, tables, cfg, species, coords,
                    learned={"g_ss_nuc": tables["g_ss"][species]})
            hooks = {"Kbeta": kb, "g_ss_nuc": tables["g_ss"][species]
                     * (1.0 + 0.05 * torch.cos(coords[..., 0]))}
            full = pt.energy(const, tables, cfg, species, coords,
                             learned=hooks)
            P = full.P
            K = cfg.scf.pack_heavy
            if pack:
                P = static_pack_mat(P, K, pt.packed_solver_size(K, MOLSIZE))
            xl = energy_xl(const, tables, cfg, species, coords, P,
                           learned=hooks, packed_io=pack)
        (f32, h32), (f64, h64) = runs[torch.float32], runs[torch.float64]
        e = {"ones_dHf": (ones.Hf - base.Hf).abs().max().item(),
             "rerun_dHf": (again.Hf - base.Hf).abs().max().item(),
             "kbeta_f32_dHf": (h32 - h64).abs().max().item(),
             "kbeta_f32_dF": (f32 - f64).abs().max().item(),
             "kbeta_shift_Hf": (h64 - base.Hf.double()).abs().max().item(),
             "gss_dEnuc": (gss.Enuc - base.Enuc).abs().max().item(),
             "xl_dEnuc": (xl.Enuc - full.Enuc).abs().max().item(),
             "hook_shift_Enuc": (full.Enuc - base.Enuc).abs().max().item()}
        print(f"[32 ml-hooks {layout}] {n} molecules AM1 f32: Kbeta = 1 "
              f"|dHf| {e['ones_dHf']:.2e} eV (deterministic mode; the "
              f"ordinary mode's run-to-run |dHf| {e['rerun_dHf']:.2e} eV) | "
              f"random Kbeta (shifts Hf up "
              f"to {e['kbeta_shift_Hf']:.3f} eV) f32 vs f64 |dHf| "
              f"{e['kbeta_f32_dHf']:.2e} eV |dF| {e['kbeta_f32_dF']:.2e} "
              f"eV/A | table g_ss as g_ss_nuc |dEnuc| {e['gss_dEnuc']:.2e} "
              f"eV | energy_xl vs energy Enuc with both hooks (which shift "
              f"Enuc up to {e['hook_shift_Enuc']:.3f} eV) |dEnuc| "
              f"{e['xl_dEnuc']:.2e} eV", flush=True)
        check(e["ones_dHf"] <= TOL_HF, f"ml-hooks {layout}: Kbeta = 1 {e}")
        check(e["kbeta_f32_dHf"] <= TOL_HF and e["kbeta_f32_dF"] <= TOL_F,
              f"ml-hooks {layout}: Kbeta f32 against f64 {e}")
        check(e["kbeta_shift_Hf"] > 1.0e-2 and e["hook_shift_Enuc"] > 1.0e-2,
              f"ml-hooks {layout}: the hooks had no effect {e}")
        check(e["gss_dEnuc"] <= TOL_ENUC and e["xl_dEnuc"] <= TOL_ENUC,
              f"ml-hooks {layout}: Enuc {e}")
        out[layout] = e
    K2_BY_N["ml_hooks"] = dict(eigh_kernel.launches_by_n)
    nk = kernel_counts()
    print(f"[32 ml-hooks] launches K1 {nk[0]} K2 {nk[1]} K3 fwd {nk[2]} bwd "
          f"{nk[3]}", flush=True)
    check(all(c > 0 for c in nk), f"ml-hooks launches {nk}")
    out.update(k1_launches=nk[0], k2_launches=nk[1], k3_launches=nk[2:])
    return out


def ml_grad_step(dtype, eps, target, n):
    """sum((Hf - target)^2) of PM3 with the HIP-NN model on the first n
    headline molecules (eigh SCF, packed, backward mode 1) and its
    gradient to every weight tensor of the network."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch.models.hipnn import make_hipnn_callable
    const, tables, cfg, species, coords = ml_setup(
        "PM3", n, dtype, eps, 1.0e-4, use_sp2=False, backward=1)
    net = make_hipnn_callable(dtype=dtype, device=DEV)
    names = list(net.w)
    for k in names:
        net.w[k].requires_grad_(True)
    out = pt.energy(const, tables, cfg, species, coords, learned=net)
    loss = ((out.Hf - target.to(dtype)) ** 2).sum()
    grads = torch.autograd.grad(loss, [net.w[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def phase_ml_grad(card):
    """The gradient of sum((Hf - target)^2) to every HIP-NN weight through
    the SCF adjoint (backward mode 1) on ML_HOOK_NMOL headline molecules,
    the target the PM3 table's Hf: float32 on the card (timed after a
    warm-up) against float64 on the card, relative error per weight
    tensor (the contract of models/ml.py: gradient flow into network
    weights)."""
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch import scf
    from pyseqm_tpu_torch.ops import eigh_kernel
    n = ML_HOOK_NMOL
    const, tables, cfg, species, coords = ml_setup(
        "PM3", n, torch.float64, 1.0e-10, 1.0e-7, use_sp2=False)
    with torch.no_grad():
        target = pt.energy(const, tables, cfg, species, coords).Hf
    ml_grad_step(torch.float32, 1.0e-5, target, n)          # warm-up
    sync()
    kernels_reset()
    scf.adjoint_iterations = scf.backward_failures = 0
    t0 = time.perf_counter()
    l32, g32 = ml_grad_step(torch.float32, 1.0e-5, target, n)
    sync()
    dt = time.perf_counter() - t0
    iters, fails = scf.adjoint_iterations, scf.backward_failures
    l64, g64 = ml_grad_step(torch.float64, 1.0e-10, target, n)
    K2_BY_N["ml_grad"] = dict(eigh_kernel.launches_by_n)
    nk = kernel_counts()
    rel = {k: ((g32[k].double() - g64[k]).abs().max()
               / g64[k].abs().max()).item() for k in g64}
    finite = all(bool(torch.isfinite(g).all()) for g in g32.values())
    worst = max(rel, key=rel.get)
    print(f"[33 ml-grad] {n} molecules PM3 + HIP-NN, eigh packed, backward "
          f"1: f32 loss and gradient to {len(g32)} weight tensors in "
          f"{dt:.3f} s ({n / dt:.1f} molecules/s) on {card} | adjoint "
          f"iterations {iters}, backward failures {fails} | loss f32 "
          f"{l32.item():.6f} f64 {l64.item():.6f} | relative error per "
          f"tensor max {rel[worst]:.2e} ({worst}) median "
          f"{float(np.median(list(rel.values()))):.2e} | finite {finite} | "
          f"launches K2 {nk[1]} K3 fwd {nk[2]} bwd {nk[3]}", flush=True)
    print("[33 ml-grad relative error] " + " ".join(
        f"{k} {v:.2e}" for k, v in rel.items()), flush=True)
    check(finite, "ml-grad: non-finite float32 gradients")
    check(fails == 0, f"ml-grad: {fails} backward failures")
    check(rel[worst] <= TOL_ML_GRAD, f"ml-grad: {worst} relative error "
          f"{rel[worst]} > {TOL_ML_GRAD}")
    check(nk[1] > 0 and nk[2] > 0 and nk[3] > 0, f"ml-grad launches {nk}")
    return {"molecules_per_s": n / dt, "s": dt, "adjoint_iterations": iters,
            "backward_failures": fails, "loss_f32": l32.item(),
            "loss_f64": l64.item(), "relative_error": rel,
            "k1_launches": nk[0], "k2_launches": nk[1],
            "k3_launches": nk[2:]}


def resume_check(label, build, steps, path, with_generator):
    """``steps`` steps straight from a fresh driver's initial state against
    steps // 2, a checkpoint written to ``path`` (with the driver's
    generator), a second driver built afresh (its generator seeded
    elsewhere) and loaded from the file, then the other half.  Returns the
    fields that are not bit for bit equal, with their largest
    difference."""
    from pyseqm_tpu_torch.utils.checkpoint import (_leaves, load_state,
                                                   save_state)
    md, state = build(0)
    for _ in range(steps // 2):
        state, _ = md.step(md.species, state)
    save_state(path, state, generator=getattr(md, "generator", None)
               if with_generator else None)
    for _ in range(steps - steps // 2):
        state, _ = md.step(md.species, state)
    md2, like = build(99)
    resumed = load_state(path, like, generator=getattr(md2, "generator",
                                                       None))
    for _ in range(steps - steps // 2):
        resumed, _ = md2.step(md2.species, resumed)
    sync()
    diff = {}
    for (p, a), (_, b) in zip(_leaves(state), _leaves(resumed)):
        if torch.is_tensor(a):
            if not torch.equal(a, b):
                diff[p] = (a.double() - b.double()).abs().max().item()
        elif a != b:
            diff[p] = abs(a - b)
    print(f"[34 resume {label}] {steps} steps straight against {steps // 2} "
          f"+ checkpoint + a fresh driver + {steps - steps // 2}: "
          + ("every field bit for bit equal" if not diff else
             f"differing fields {diff}"), flush=True)
    return diff


def phase_resume(card):
    """Checkpoint and resume at full width: the headline XL-SP2 path and
    the Langevin bomd path (phase 24's configuration, with the generator's
    state); then run(thermo=2, dump=3) writing xyz frames of 2 molecules,
    timed by a Timing."""
    import tempfile
    from pyseqm_tpu_torch.drivers.md import LangevinDynamics, MDConfig
    from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
    from pyseqm_tpu_torch.utils.timing import Timing
    kernels_reset()
    xl_setup = headline_setup(NMOL, torch.float32, 1.0e-5, 1.0e-4)
    bomd = bomd_setup(NMOL, torch.float32)

    def build_xl(seed):
        const, tables, cfg, species, coords = xl_setup
        md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
        md.species = species
        return md, md.initialize(species, coords,
                                 velocities=torch.zeros_like(coords),
                                 initial_force=False)

    def build_langevin(seed):
        const, tables, cfg, species, coords = bomd
        md = LangevinDynamics(
            const, tables, cfg, MDConfig(timestep=0.4, damp=20.0,
                                         temperature=300.0),
            generator=torch.Generator(DEV).manual_seed(seed))
        md.species = species
        return md, md.initialize(species, coords, Temp=300.0)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["xlbomd_differing"] = resume_check(
            "xlbomd-sp2", build_xl, RESUME_STEPS,
            os.path.join(tmp, "xl.npz"), False)
        out["langevin_differing"] = resume_check(
            "bomd langevin", build_langevin, RESUME_STEPS,
            os.path.join(tmp, "bomd.npz"), True)
        md, state = build_xl(0)
        md.timing = Timing()
        prefix = os.path.join(tmp, "dump")
        md.run(md.species, state, steps=7, thermo=2, dump=3,
               dump_prefix=prefix, molids=(0, 1), log=False)
        frames = {}
        for mol in (0, 1):
            with open(f"{prefix}.{mol}.xyz") as f:
                lines = f.read().strip().splitlines()
            natom = int(lines[0])
            frames[mol] = (len(lines) // (natom + 2),
                           [ln.split()[1].rstrip(",")
                            for ln in lines[1::natom + 2]],
                           len(lines[2].split()))
    summ = md.timing.summary()
    nk = kernel_counts()
    print(f"[34 resume dump] run(steps=7, thermo=2, dump=3), molecules 0 "
          f"and 1: (frames, their steps, columns) {frames} | Timing {summ}",
          flush=True)
    print(f"[34 resume] launches K1 {nk[0]} K3 fwd {nk[2]} bwd {nk[3]}",
          flush=True)
    check(not out["xlbomd_differing"] and not out["langevin_differing"],
          f"resume: not bit for bit {out}")
    check(all(v == (2, ["3", "6"], 11) for v in frames.values()),
          f"resume: the dump wrote {frames}, expected the frames of steps 3 "
          "and 6, 11 columns, per molecule")
    check(summ.get("MD", {}).get("count") == 4, f"resume: Timing {summ}")
    check(nk[0] > 0 and nk[2] > 0 and nk[3] > 0, f"resume launches {nk}")
    out.update(frames={str(k): v[0] for k, v in frames.items()},
               timing=summ, k1_launches=nk[0], k3_launches=nk[2:])
    return out


def optax_iterations(step, state, x, iters):
    """``iters`` outer iterations of an optax-routed L-BFGS ``step``:
    the final point and state, the value (sum of Hf) at the start of
    each iteration, the line-search failures and the accepted step
    sizes."""
    values, failed, rates = [], 0, []
    for _ in range(iters):
        x, state, value, _ = step(x, state)
        values.append(value.item())
        failed += int(state.failed)
        rates.append(state.learning_rate)
    return x, state, values, failed, rates


def rises_past_slack(values):
    """The accepted steps that raised sum(Hf) by more than the zoom
    search's approximate-Wolfe slack, 1e-6 |sum Hf| plus the float32
    spacing of sum Hf: (iteration, rise, slack) of each."""
    out = []
    for i, (a, b) in enumerate(zip(values, values[1:])):
        slack = 1.0e-6 * abs(a) + float(np.spacing(np.float32(abs(a))))
        if b - a > slack:
            out.append((i, b - a, slack))
    return out


def phase_lbfgs_optax(card):
    """The JAX package's default L-BFGS (``make_lbfgs``, optax's chain:
    two-loop recursion on the whole batch as one vector, then the zoom
    line search, every evaluation a cold SCF) on the opt batch for its
    first OPTAX_ITERS outer iterations; the backtracking and none routes
    and the chunked route on OPTAX_SMALL_NMOL molecules; and the zoom
    route at float64 on the card against the same call on the CPU."""
    from pyseqm_tpu_torch.drivers import opt
    const, tables, cfg, species, coords = bomd_setup(OPT_NMOL, torch.float32,
                                                     jitter=0.05,
                                                     strict=False)
    init, step = opt.make_lbfgs(const, tables, cfg, species)
    sync()
    kernels_reset()
    opt.lbfgs_evaluations = 0
    t0 = time.perf_counter()
    x, state, values, failed, rates = optax_iterations(
        step, init(coords), coords, OPTAX_ITERS)
    sync()
    dt = time.perf_counter() - t0
    n = kernel_counts()
    evals = opt.lbfgs_evaluations
    values.append(state.value)
    rises = rises_past_slack(values)
    finite = bool(torch.isfinite(x).all()) and bool(np.isfinite(values).all())
    mips = OPT_NMOL * OPTAX_ITERS / dt
    # per molecule, max |g| at the last accepted point (the line search's
    # gradient there, masked to real atoms), against phase 26's criterion
    gerr = torch.where((species > 0)[..., None], state.grad,
                       torch.zeros_like(state.grad)).abs().amax(dim=(1, 2))
    ncv = int((gerr <= 1.0e-3).sum())
    print(f"[35 lbfgs-optax zoom] {OPT_NMOL} x {MOLSIZE} AM1 f32 SP2 packed, "
          f"optax L-BFGS (zoom), {OPTAX_ITERS} outer iterations: "
          f"{mips:.1f} molecule-iterations/s ({dt:.2f} s) on {card} | "
          f"{evals / OPTAX_ITERS:.2f} value evaluations per iteration "
          f"({evals}) | line-search failures {failed} | step sizes "
          f"{' '.join(f'{r:.3g}' for r in rates)} | sum Hf "
          f"{values[0]:.4f} -> {values[-1]:.4f} eV | rises past the slack "
          f"{rises} | molecules at max|g| <= 1e-3: {ncv}, median max|g| "
          f"{gerr.median().item():.3e} | K1 {n[0]} K2 {n[1]} K3 fwd {n[2]} "
          f"bwd {n[3]} | finite {finite}", flush=True)
    check(finite, "lbfgs-optax: non-finite state")
    check(values[-1] < values[0], f"lbfgs-optax: sum Hf {values[0]} -> "
          f"{values[-1]}")
    check(not rises, f"lbfgs-optax: accepted steps raised sum Hf {rises}")
    check(n[0] > 0 and n[2] > 0 and n[3] > 0, f"lbfgs-optax launches {n}")
    out = {"molecule_iterations_per_s": mips, "s": dt,
           "evaluations_per_iteration": evals / OPTAX_ITERS,
           "linesearch_failures": failed, "step_sizes": rates,
           "sum_hf_start": values[0], "sum_hf_end": values[-1],
           "converged": ncv, "median_max_grad": gerr.median().item(),
           "k1_launches": n[0], "k2_launches": n[1], "k3_launches": n[2:]}

    # the other routes on the first OPTAX_SMALL_NMOL molecules
    small = bomd_setup(OPTAX_SMALL_NMOL, torch.float32, jitter=0.05,
                       strict=False)
    k1 = n[0]
    k3 = list(n[2:])
    for route in ("backtracking", "none", "chunk"):
        # sum(Hf) at the ends is read outside the counted, timed window
        if route == "chunk":
            cinit, run = opt.make_lbfgs_chunk(*small[:4],
                                              chunk=OPTAX_SMALL_ITERS)
            v0 = float(pt_energy_sum(small, small[4]))
        else:
            sinit, sstep = opt.make_lbfgs(*small[:4], linesearch=route)
        sync()
        opt.lbfgs_evaluations = 0
        kernels_reset()
        t0 = time.perf_counter()
        if route == "chunk":
            x, st, _, nit, value, _ = run(small[4], cinit(small[4]), False,
                                          0)
        else:
            x, st, values, failed, _ = optax_iterations(
                sstep, sinit(small[4]), small[4], OPTAX_SMALL_ITERS)
        sync()
        dt = time.perf_counter() - t0
        m = kernel_counts()
        if route == "chunk":
            values, failed = [v0, st.value], int(st.failed)
            check(nit == OPTAX_SMALL_ITERS, f"chunked route: nit {nit}")
        else:
            values.append(float(pt_energy_sum(small, x)))
        k1 += m[0]
        k3 = [a + b for a, b in zip(k3, m[2:])]
        fin = bool(torch.isfinite(x).all()) and bool(np.isfinite(values)
                                                     .all())
        ev = opt.lbfgs_evaluations / OPTAX_SMALL_ITERS
        print(f"[35 lbfgs-optax {route}] {OPTAX_SMALL_NMOL} molecules, "
              f"{OPTAX_SMALL_ITERS} iterations: {dt:.2f} s, {ev:.2f} value "
              f"evaluations per iteration, line-search failures {failed} | "
              f"sum Hf {values[0]:.4f} -> {values[-1]:.4f} eV | K1 {m[0]} "
              f"K3 fwd {m[2]} bwd {m[3]} | finite {fin}", flush=True)
        check(fin, f"lbfgs-optax {route}: non-finite state")
        if route != "none":     # the unit step promises no decrease
            check(values[-1] < values[0], f"lbfgs-optax {route}: sum Hf "
                  f"{values[0]} -> {values[-1]}")
        out[route] = {"s": dt, "evaluations_per_iteration": ev,
                      "linesearch_failures": failed,
                      "sum_hf_start": values[0], "sum_hf_end": values[-1]}

    # float64: the card against the CPU, the same call
    xs = []
    for device in (DEV, "cpu"):
        c = bomd_setup(OPTAX_F64_NMOL, torch.float64, jitter=0.05,
                       eps=1.0e-10, sp2_eps=1.0e-7, device=device)
        finit, fstep = opt.make_lbfgs(*c[:4])
        x, _, values, _, _ = optax_iterations(fstep, finit(c[4]), c[4],
                                              OPTAX_SMALL_ITERS)
        xs.append(x.cpu())
    dx = (xs[0] - xs[1]).abs().max().item()
    print(f"[35 lbfgs-optax f64] {OPTAX_F64_NMOL} molecules, "
          f"{OPTAX_SMALL_ITERS} zoom iterations, card against CPU: max "
          f"|dx| {dx:.2e} A (bound {TOL_OPTAX_F64:g})", flush=True)
    check(dx <= TOL_OPTAX_F64, f"lbfgs-optax f64: card against CPU {dx} A")
    out.update(k1_launches=k1, k3_launches=tuple(k3), f64_max_dx=dx)
    return out


def pt_energy_sum(setup, x):
    import pyseqm_tpu_torch as pt
    const, tables, cfg, species, _ = setup
    with torch.no_grad():
        return pt.energy(const, tables, cfg, species, x).Hf.sum()


def sharded_rank(rank, out, device, nreal, steps):
    """A rank of phase 36's gloo group on one card: ``steps`` sharded
    XL-SP2 steps of its block of the first ``nreal`` headline molecules,
    padded to a multiple of the group; rank 0 saves the gathered state
    and the kernel launches of the steps, summed over the ranks."""
    import torch.distributed as dist
    from pyseqm_tpu_torch import parallel
    from pyseqm_tpu_torch.drivers.md import MDConfig
    from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
    mesh = parallel.molecule_mesh(device=device)
    const, tables, cfg, species, coords = headline_setup(
        nreal, torch.float32, 1.0e-5, 1.0e-4, device=device)
    psp, pco, _, _ = parallel.pad_to_mesh(mesh, species, coords)
    ssp, sco = parallel.shard_molecules(mesh, (psp, pco))
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
    st = md.initialize(ssp, sco, velocities=torch.zeros_like(sco),
                       initial_force=False)
    step = parallel.sharded_xlbomd_step(md, mesh)
    kernels_reset()
    for _ in range(steps):
        st, _ = step(ssp, st)
    launches = torch.tensor(kernel_counts())
    dist.all_reduce(launches)
    whole = parallel.gather_molecules(mesh, st)
    if rank == 0:
        torch.save({"state": {f.name: (getattr(whole, f.name).cpu()
                                       if torch.is_tensor(getattr(whole,
                                                                  f.name))
                                       else getattr(whole, f.name))
                              for f in dataclasses.fields(whole)},
                    "launches": launches.tolist()}, out)


def phase_sharded(card, main_sps):
    """Data parallelism over molecules (``parallel/``): an NCCL group of
    one on the card runs the sharded XL-SP2 step on the headline batch,
    the sharded force, and the data-parallel training step on
    SHARD_TRAIN_NMOL molecules (eigh, backward 1); then two gloo ranks
    with CUDA tensors on this card, SHARD_REAL molecules padded to a
    multiple of the ranks, their XL state after SHARD_GLOO_STEPS steps
    against one process's."""
    import torch.distributed as dist
    import pyseqm_tpu_torch as pt
    from pyseqm_tpu_torch import parallel
    from pyseqm_tpu_torch.drivers.md import MDConfig
    from pyseqm_tpu_torch.drivers.xlbomd import XLBOMD
    from pyseqm_tpu_torch.parallel import sharding
    mesh = parallel.molecule_mesh(device=DEV)
    try:
        check(mesh.backend == "nccl" and mesh.size == 1,
              f"mesh {mesh.backend} of {mesh.size}")
        const, tables, cfg, species, coords = headline_setup(
            NMOL, torch.float32, 1.0e-5, 1.0e-4)
        md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
        state = md.initialize(species, coords,
                              velocities=torch.zeros_like(coords),
                              initial_force=False)
        ssp, sst = parallel.shard_molecules(mesh, species), \
            parallel.shard_molecules(mesh, state)
        step = parallel.sharded_xlbomd_step(md, mesh)
        sst, _ = step(ssp, sst)
        sync()
        kernels_reset()
        t0 = time.perf_counter()
        for _ in range(SHARD_STEPS):
            sst, obs = step(ssp, sst)
        sync()
        dt = time.perf_counter() - t0
        n = kernel_counts()
        f, hf = parallel.sharded_force_fn(const, tables, cfg, mesh)(
            ssp, sst.coordinates)
        m = kernel_counts()
        finite = bool(torch.isfinite(sst.coordinates).all()
                      and torch.isfinite(sst.P).all()
                      and torch.isfinite(f).all()
                      and torch.isfinite(hf).all())
        sps = SHARD_STEPS / dt
        print(f"[36 sharded xl] {mesh.backend} group of {mesh.size} on "
              f"{mesh.device}: "
              f"{NMOL} x {MOLSIZE} XL-SP2 {sps:.3f} steps/s beside phase "
              f"4's {main_sps:.3f} on {card} | K1 {n[0]} in "
              f"{SHARD_STEPS} steps, K3 fwd {n[2]} bwd {n[3]} | sharded "
              f"force K3 fwd {m[2] - n[2]} bwd {m[3] - n[3]} | finite "
              f"{finite}", flush=True)
        check(finite, "sharded: non-finite state or force")
        check(n[0] == SHARD_STEPS, f"sharded: K1 {n[0]} in {SHARD_STEPS} "
              "steps")
        k1, k3 = m[0], list(m[2:])
        del md, state, sst, f, hf
        torch.cuda.empty_cache()

        # the training step on the eigh SCF with backward mode 1
        tc, tt, tcfg, tsp, tco = adjoint_setup(SHARD_TRAIN_NMOL,
                                               torch.float32, 1.0e-5, True)
        with torch.no_grad():
            target = pt.energy(tc, tt, tcfg, tsp, tco).Hf + 0.05
        names = ("U_ss", "zeta_s")
        train = parallel.make_train_step(tc, tt, tcfg, mesh, names, lr=1e-4)
        deltas = {k: torch.zeros_like(tt[k]) for k in names}
        kernels_reset()
        reduces = sharding.all_reduces
        losses = []
        t0 = time.perf_counter()
        for _ in range(SHARD_TRAIN_STEPS):
            deltas, loss = train(deltas, tsp, tco, target)
            losses.append(loss.item())
        sync()
        dt = time.perf_counter() - t0
        t = kernel_counts()
        reduces = sharding.all_reduces - reduces
        moved = max(d.abs().max().item() for d in deltas.values())
        print(f"[36 sharded train] {SHARD_TRAIN_NMOL} molecules, eigh "
              f"backward 1, U_ss and zeta_s offsets, lr 1e-4: "
              f"{SHARD_TRAIN_STEPS} steps {dt:.2f} s | loss "
              f"{' '.join(f'{v:.6g}' for v in losses)} | largest offset "
              f"{moved:.3g} | {mesh.backend} all_reduce calls {reduces} | K2 {t[1]} "
              f"K3 fwd {t[2]} bwd {t[3]}", flush=True)
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"sharded train: losses {losses}")
        check(reduces == SHARD_TRAIN_STEPS, f"all_reduce calls {reduces}")
        check(t[1] > 0 and t[2] > 0 and t[3] > 0, f"train launches {t}")
        k3 = [a + b for a, b in zip(k3, t[2:])]
        k2 = t[1]
    finally:
        dist.destroy_process_group()

    # two gloo ranks on this card, a padded batch; one process's reference
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.pt")
        t0 = time.perf_counter()
        sharding.spawn_ranks(sharded_rank, SHARD_RANKS,
                             (out, DEV, SHARD_REAL, SHARD_GLOO_STEPS),
                             timeout=600)
        t_ranks = time.perf_counter() - t0
        saved = torch.load(out)
    got, g = saved["state"], saved["launches"]
    k1 += g[0]
    k3 = [a + b for a, b in zip(k3, g[2:])]
    # one process: the whole real batch, and each rank's block alone
    const, tables, cfg, species, coords = headline_setup(
        SHARD_REAL, torch.float32, 1.0e-5, 1.0e-4)
    md = XLBOMD(const, tables, cfg, MDConfig(timestep=0.4), k=5)
    padded = got["coordinates"].shape[0]
    check(padded == SHARD_REAL + (-SHARD_REAL) % SHARD_RANKS,
          f"sharded gloo: {padded} molecules gathered")
    pad = padded - SHARD_REAL
    psp = torch.cat([species, species.new_zeros((pad,) + species.shape[1:])])
    pco = torch.cat([coords, coords.new_zeros((pad,) + coords.shape[1:])])
    blk = padded // SHARD_RANKS
    refs = {}
    for name, (a, b) in [("whole", (0, SHARD_REAL))] + [
            (f"block {r}", (r * blk, (r + 1) * blk))
            for r in range(SHARD_RANKS)]:
        sp_, co_ = psp[a:b], pco[a:b]
        st = md.initialize(sp_, co_, velocities=torch.zeros_like(co_),
                           initial_force=False)
        for _ in range(SHARD_GLOO_STEPS):
            st, _ = md.step(sp_, st)
        refs[name] = st
    axes = parallel.xlbomd_state_specs()
    rel, blocks_equal, pad_finite = {}, True, True
    for f in ("coordinates", "velocities", "acc", "D", "P", "Pt", "E0"):
        a, ax = got[f], getattr(axes, f)
        ref = getattr(refs["whole"], f).cpu()
        rel[f] = ((a.narrow(ax, 0, SHARD_REAL) - ref).abs().max()
                  / ref.abs().max()).item()
        blocks_equal &= torch.equal(a, torch.cat(
            [getattr(refs[f"block {r}"], f).cpu()
             for r in range(SHARD_RANKS)], dim=ax))
        pad_finite &= bool(torch.isfinite(a).all())
    print(f"[36 sharded gloo] {SHARD_RANKS} ranks, gloo, CUDA tensors on "
          f"one card: {SHARD_REAL} molecules padded to {padded}, "
          f"{SHARD_GLOO_STEPS} XL steps ({t_ranks:.1f} s with the ranks' "
          f"start; K1 {g[0]} K3 fwd {g[2]} bwd {g[3]}, both ranks) | "
          f"gathered against one process's run of each rank's "
          f"block: bit for bit {blocks_equal} | against its run of the "
          f"whole batch, max |d| / max |value| "
          + " ".join(f"{k} {v:.1e}" for k, v in rel.items())
          + f" (bound {TOL_SHARD_REL:g}) | padding finite {pad_finite} | "
          f"step {got['step']}", flush=True)
    check(blocks_equal, "sharded gloo: the ranks' blocks differ from one "
          "process's run of the same blocks")
    check(max(rel.values()) <= TOL_SHARD_REL, f"sharded gloo: {rel}")
    check(pad_finite, "sharded gloo: non-finite padding")
    check(g[0] > 0 and g[2] > 0 and g[3] > 0, f"sharded gloo launches {g}")
    return {"steps_per_s": sps, "main_path_steps_per_s": main_sps,
            "train_s": dt, "train_losses": losses,
            "all_reduce_calls": reduces, "gloo_blocks_bit_for_bit":
            blocks_equal, "gloo_whole_max_rel_diff": rel, "gloo_s": t_ranks,
            "gloo_launches": g,
            "k1_launches": k1, "k2_launches": k2, "k3_launches": tuple(k3)}


def k3_timing(ri, U, X, perm, tag, flush):
    """K3 on one path's own operands (the exchange apply of its Fock
    build): each kernel launch alone (median of 20, device time), with its
    inputs L2-warm ("ms") and cold ("ms_cold": ``flush`` writes a buffer
    larger than L2 before each call, outside the events, as the main path
    writes a K3 call's inputs many launches earlier), against its bound,
    beside the reading with host time (median_ms); the plain version's
    forward and autograd backward as the reference point (no PyTorch call
    computes this function)."""
    from pyseqm_tpu_torch.ops import wapply_kernel as wk
    batch = torch.broadcast_shapes(ri.shape[:-1], U.shape[:-2],
                                   X.shape[:-2])
    C = int(np.prod(batch))
    ri = ri.expand(batch + (22,)).reshape(C, 22).contiguous()
    U = U.expand(batch + (4, 4)).reshape(C, 4, 4).contiguous()
    X = X.expand(batch + (4, 4)).reshape(C, 4, 4).contiguous()
    g = torch.Generator(device=DEV).manual_seed(5)
    Yb = torch.randn(C, 4, 4, generator=g, device=DEV, dtype=X.dtype)
    rel, absmax, _ = k3_errors(ri, U, X, Yb, perm)
    check(max(rel) <= TOL_K3[X.dtype], f"K3 vs plain on the {tag} input: "
          f"{rel}")
    need = (True, True, True)
    launch = {"fwd": lambda: wk._launch_fwd(ri, U, X, perm),
              "bwd": lambda: wk._launch_bwd(ri, U, X, Yb, perm, need)}
    ms = {k: device_ms(f, 20) for k, f in launch.items()}
    cold = {k: device_ms(f, 20, before=flush) for k, f in launch.items()}
    host_ms = {k: median_ms(f, 20) for k, f in launch.items()}
    bulk = not any(t.data_ptr() % 16 for t in (ri, U, X, Yb))
    leaves = [t.clone().requires_grad_(True) for t in (ri, U, X)]
    yr = wk.w_apply_reference(*leaves, perm)
    plain = {"fwd": median_ms(lambda: wk.w_apply_reference(ri, U, X, perm),
                              5),
             "bwd": median_ms(lambda: torch.autograd.grad(
                 yr, leaves, Yb, retain_graph=True), 5)}
    size = X.element_size()
    out = {}
    for kind in ("fwd", "bwd"):
        nin, nout, flops = K3_IO[kind]
        t_byte = C * (nin + nout) * size / PEAK_BYTES * 1e3
        t_flop = C * flops / PEAK_FP32 * 1e3
        bound = max(t_byte, t_flop)
        out[kind] = {"ms": ms[kind], "ms_cold": cold[kind],
                     "host_ms": host_ms[kind], "plain_ms": plain[kind],
                     "bound_ms": bound,
                     "bound_by": "operations" if t_flop > t_byte else "bytes",
                     "share_of_bound_cold": bound / cold[kind],
                     "cells": C, "bulk_copies": bulk, "max_abs_err": absmax}
        print(f"[17 K3 {kind} timing, {tag} C={C} perm {perm}] kernel "
              f"cold {cold[kind]:.4f} ms, L2-warm {ms[kind]:.4f} ms (median "
              f"of 20, device time alone; with host time "
              f"{host_ms[kind]:.4f} ms), plain {plain[kind]:.3f} ms | bound "
              f"{bound:.4f} ms (bytes {t_byte:.4f}, FP32 {t_flop:.4f}), "
              f"kernel at {100 * bound / cold[kind]:.1f}% of it cold, "
              f"{100 * bound / ms[kind]:.1f}% warm | bulk copies {bulk} | "
              f"kernel vs plain {max(rel):.1e} rel", flush=True)
    return out


def k3_timings(inputs, perm):
    """k3_timing on each path's operands, after the timer's floor (the
    device_ms of an empty launch) is printed once; returns (timings by
    path, floor ms)."""
    floor = device_ms(lambda: torch.cuda._sleep(0), 20)
    print(f"[17 timer floor] device_ms of an empty launch "
          f"(torch.cuda._sleep(0)): {floor:.4f} ms", flush=True)
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=DEV)
    out = {tag: k3_timing(*ops[perm], perm, tag, buf.zero_)
           for tag, ops in inputs}
    del buf
    return out, floor


class Phase:
    """Prints a phase's elapsed time when it ends."""

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"[{self.label}] elapsed {time.perf_counter() - self.t0:.1f}"
                  f" s", flush=True)


def k3_entry(name, kind, replaces, launches_by_path, timings, worst, floor):
    """The kernels-line entry of K3's forward or backward kernel: times on
    the main path's (headline) input, every path's beside it."""
    main = timings["headline packed XX"][kind]
    return {"name": name, "route": "cuda",
            "source": "pyseqm_tpu_torch/csrc/wapply.cu",
            "replaces": replaces, "redesigned": "PR 5",
            "launches": sum(launches_by_path.values()),
            "max_abs_err": max(t[kind]["max_abs_err"]
                               for t in timings.values()),
            "max_abs_err_synthetic_f32": worst,
            **{k: main[k] for k in ("ms", "ms_cold", "plain_ms", "bound_ms",
                                    "bound_by")},
            "timer_floor_ms": floor,
            "library_ms": None, "cells": main["cells"],
            "launches_by_path": launches_by_path,
            "by_path": {tag: t[kind] for tag, t in timings.items()}}


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
    with Phase("2 build"):
        ptxas = phase_build()
        timer_check = phase_profiler()
    with Phase("3 K1 parity"):
        worst = phase_kernel_parity()
    with Phase("13 K3 parity"):
        worst3 = phase_k3_parity()
        worst3_second = phase_k3_second_order()
    with Phase("4 main path"), k3_tap() as k3_head:
        (md, species, state, launches, sps, parts, per_mol, k3_main,
         k3_step) = phase_main_path(card)
    check(launches > 0, "K1 was not launched on the main path")
    with Phase("5 K1 timing"):
        k1 = phase_kernel_times(md, species, state, launches, worst)
    with Phase("6 diagnostics"):
        phase_diagnostics(md, species, state, per_mol, 1e3 / sps)
    del md, state
    torch.cuda.empty_cache()
    with Phase("18 overlap"):
        overlap_t = phase_overlap()
    torch.cuda.empty_cache()
    with Phase("7 accuracy"):
        phase_accuracy()

    with Phase("8 K2 parity"):
        worst2 = phase_k2_parity()
    with Phase("9 scf-eigh"):
        scf_eigh, a16 = phase_scf_eigh(card)
    with Phase("10 eig=True"):
        n_eig, k3_eig, a32, eig_acc = phase_eig_outputs()
    with Phase("11 xlbomd-eigh"):
        n_xl, k3_xl, xl_eigh = phase_xl_eigh(card)
    by_path = {"scf_eigh": scf_eigh["launches"], "eig_true": n_eig,
               "xlbomd_eigh": n_xl}
    for path, n in by_path.items():
        check(n > 0, f"K2 was not launched on the {path} path")
    with Phase("12 K2 timing"):
        t16, t32 = k2_timing(a16, "scf-eigh"), k2_timing(a32, "eig=True")
    torch.cuda.empty_cache()
    with Phase("14 flat default"):
        flat, k3_flat_in = phase_flat_default(card)
    by_path["flat_default"] = flat["k2_launches"]
    check(by_path["flat_default"] > 0, "K2 was not launched on the "
          "flat_default path")
    torch.cuda.empty_cache()
    with Phase("15 nanostar packed"):
        nano_pk, nano_ref, k3_nano_pk_in = phase_nanostar_packed(card)
    torch.cuda.empty_cache()
    with Phase("16 nanostar dense"):
        nano_dn, k3_nano_dn_in = phase_nanostar_dense(card, nano_ref)
    torch.cuda.empty_cache()
    with Phase("19 scf-adjoint"):
        adj = phase_scf_adjoint(card, True)
    torch.cuda.empty_cache()
    with Phase("19 scf-adjoint flat"):
        adj_flat = phase_scf_adjoint(card, False)
    torch.cuda.empty_cache()
    with Phase("20 hessian"):
        hess = phase_hessian(card)
    torch.cuda.empty_cache()
    with Phase("21 flat-split"):
        split = phase_flat_split(card)
    torch.cuda.empty_cache()
    with Phase("22 convergers"):
        convergers = phase_convergers()
    torch.cuda.empty_cache()
    with Phase("24 bomd"):
        bomd = phase_bomd(card)
    torch.cuda.empty_cache()
    with Phase("25 nvt"):
        nvt = phase_nvt(card)
    torch.cuda.empty_cache()
    with Phase("26 opt"):
        opt = phase_opt(card)
    torch.cuda.empty_cache()
    with Phase("27 opt-sd"):
        opt_sd = phase_opt_sd(card)
    torch.cuda.empty_cache()
    with Phase("28 scf-row3"):
        row3 = phase_scf_row3(card)
    torch.cuda.empty_cache()
    with Phase("29 row3 pin"):
        pin = phase_row3_pin(card)
    torch.cuda.empty_cache()
    with Phase("30 xlbomd-ml-trained"):
        ml_trained = phase_xlbomd_ml_trained(card)
    torch.cuda.empty_cache()
    with Phase("31 xlbomd-ml"):
        ml_random = phase_xlbomd_ml(card)
    torch.cuda.empty_cache()
    with Phase("32 ml-hooks"):
        hooks = phase_ml_hooks(card)
    torch.cuda.empty_cache()
    with Phase("33 ml-grad"):
        ml_grad = phase_ml_grad(card)
    torch.cuda.empty_cache()
    with Phase("34 resume"):
        resume = phase_resume(card)
    torch.cuda.empty_cache()
    with Phase("35 lbfgs-optax"):
        optax = phase_lbfgs_optax(card)
    torch.cuda.empty_cache()
    with Phase("36 sharded"):
        sharded = phase_sharded(card, sps)
    torch.cuda.empty_cache()
    k1_paths = {"xlbomd_sp2": launches, "bomd": bomd["k1_launches"],
                "nvt_langevin": nvt["langevin"]["k1_launches"],
                "nvt_nose_hoover": nvt["nose_hoover"]["k1_launches"],
                "opt": opt["k1_launches"], "opt_sd": opt_sd["k1_launches"],
                "scf_row3": row3["k1_launches"],
                "xlbomd_ml_trained": ml_trained["k1_launches"],
                "xlbomd_ml": ml_random["k1_launches"],
                "ml_hooks": hooks["k1_launches"],
                "resume": resume["k1_launches"],
                "lbfgs_optax": optax["k1_launches"],
                "sharded": sharded["k1_launches"]}
    for path, n in k1_paths.items():
        check(n > 0, f"K1 was not launched on the {path} path")
    by_path.update(scf_adjoint=adj["k2_launches"],
                   scf_adjoint_flat=adj_flat["k2_launches"],
                   hessian=hess["k2_launches"],
                   ml_hooks=hooks["k2_launches"],
                   ml_grad=ml_grad["k2_launches"],
                   sharded_train=sharded["k2_launches"])
    for path in ("scf_adjoint", "scf_adjoint_flat", "hessian", "ml_hooks",
                 "ml_grad", "sharded_train"):
        check(by_path[path] > 0, f"K2 was not launched on the {path} path")

    k3_paths = {"xlbomd_sp2": k3_main, "scf_eigh": scf_eigh["k3_launches"],
                "eig_true": k3_eig, "xlbomd_eigh": k3_xl,
                "flat_default": flat["k3_launches"],
                "nanostar_packed": nano_pk["k3_launches"],
                "nanostar_dense": nano_dn["k3_launches"],
                "scf_adjoint": adj["k3_launches"],
                "scf_adjoint_flat": adj_flat["k3_launches"],
                "hessian": hess["k3_launches"],
                "flat_split": split["k3_launches"],
                "bomd": bomd["k3_launches"],
                "nvt_langevin": nvt["langevin"]["k3_launches"],
                "nvt_nose_hoover": nvt["nose_hoover"]["k3_launches"],
                "opt": opt["k3_launches"], "opt_sd": opt_sd["k3_launches"],
                "scf_row3": row3["k3_launches"],
                "row3_pin": pin["k3_launches"],
                "xlbomd_ml_trained": ml_trained["k3_launches"],
                "xlbomd_ml": ml_random["k3_launches"],
                "ml_hooks": hooks["k3_launches"],
                "ml_grad": ml_grad["k3_launches"],
                "resume": resume["k3_launches"],
                "lbfgs_optax": optax["k3_launches"],
                "sharded": sharded["k3_launches"]}
    for path, (nf, nb) in k3_paths.items():
        check(nf > 0, f"K3 forward was not launched on the {path} path")
    for path in ("xlbomd_sp2", "eig_true", "xlbomd_eigh", "nanostar_packed",
                 "nanostar_dense", "scf_adjoint", "scf_adjoint_flat",
                 "hessian", "bomd", "nvt_langevin", "nvt_nose_hoover", "opt",
                 "opt_sd", "row3_pin", "xlbomd_ml_trained", "xlbomd_ml",
                 "ml_hooks", "ml_grad", "resume", "lbfgs_optax", "sharded"):
        check(k3_paths[path][1] > 0, f"K3 backward was not launched on the "
              f"{path} path")
    xch = (1, 3, 2, 4)
    with Phase("17 K3 timing"):
        k3_t, floor = k3_timings(
            (("headline packed XX", k3_head.last),
             ("nanostar packed XX", k3_nano_pk_in),
             ("flat default", k3_flat_in),
             ("nanostar dense grid", k3_nano_dn_in)), xch)
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
          "launches_by_n": {str(n): sum(d.get(n, 0) for d in K2_BY_N.values())
                            for n in sorted({n for d in K2_BY_N.values()
                                             for n in d})},
          "launches_by_path_and_n": K2_BY_N,
          "ptxas": ptxas["eigh"],
          "phases": ["8 parity", "9 scf-eigh", "10 eig=True",
                     "11 xlbomd-eigh", "12 timing", "14 flat default",
                     "19 scf-adjoint", "20 hessian", "32 ml-hooks",
                     "33 ml-grad", "36 sharded"]}
    k1["launches"] = sum(k1_paths.values())
    k1["launches_by_path"] = k1_paths
    k1["phases"] += ["24 bomd", "25 nvt", "26 opt", "27 opt-sd",
                     "28 scf-row3", "30 xlbomd-ml-trained", "31 xlbomd-ml",
                     "32 ml-hooks", "34 resume", "35 lbfgs-optax",
                     "36 sharded"]
    k1["ptxas"] = ptxas["sp2"]
    k3f = k3_entry("wapply_fwd", "fwd", "tools/wapply_pallas.py:181",
                   {p: n[0] for p, n in k3_paths.items()}, k3_t, worst3,
                   floor)
    k3b = k3_entry("wapply_bwd", "bwd", "tools/wapply_pallas.py:199",
                   {p: n[1] for p, n in k3_paths.items()}, k3_t, worst3,
                   floor)
    for k3, kind in ((k3f, "fwd"), (k3b, "bwd")):
        k3["ptxas"] = {n: e for n, e in ptxas["wapply"].items()
                       if n.startswith(kind)}
        # under create_graph WApply's backward is WApplyBwd: its forward
        # the backward kernel, its backward three forward applies and
        # plain torch for the terms through U (phase 13)
        k3["second_derivative"] = {
            "route": "WApplyBwd", "max_abs_err_synthetic": {
                str(d)[6:]: e for d, e in worst3_second.items()}}
    k3f["timer_cross_check"] = timer_check
    from pyseqm_tpu_torch.ops import overlap_kernel
    main_ov = overlap_t["xl-small HH"]
    ov = {"name": "overlap_s", "route": "cuda",
          "source": "pyseqm_tpu_torch/csrc/overlap.cu",
          "replaces": None, "added": "PR 14",
          "launches": overlap_kernel.launches, "launches_per_xl_step": 3,
          "max_abs_err_f64": max(t["max_abs_err_f64"]
                                 for t in overlap_t.values()),
          **{k: main_ov[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by")},
          "library_ms": None, "segments": overlap_t,
          "ptxas": ptxas["overlap"],
          "phases": ["2 one launch", "4 main path", "18 overlap"]}
    k3f["launches_per_xl_step"], k3b["launches_per_xl_step"] = k3_step
    print(json.dumps({"main_path": {"steps_per_s": sps,
                                    "span_breakdown_ms": parts},
                      "scf_eigh": scf_eigh, "eig_true": eig_acc,
                      "xlbomd_eigh": xl_eigh, "flat_default": flat,
                      "nanostar_packed": nano_pk,
                      "nanostar_dense": nano_dn, "scf_adjoint": adj,
                      "scf_adjoint_flat": adj_flat, "hessian": hess,
                      "flat_split": split, "convergers": convergers,
                      "bomd": bomd, "nvt": nvt, "opt": opt, "opt_sd": opt_sd,
                      "scf_row3": row3, "row3_pin": pin,
                      "xlbomd_ml_trained": ml_trained,
                      "xlbomd_ml": ml_random, "ml_hooks": hooks,
                      "ml_grad": ml_grad, "resume": resume,
                      "lbfgs_optax": optax, "sharded": sharded}),
          flush=True)
    print(json.dumps({"kernels": [k1, k2, k3f, k3b, ov]}), flush=True)
    print(card_line(), flush=True)
    print(f"elapsed {time.perf_counter() - T_START:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
