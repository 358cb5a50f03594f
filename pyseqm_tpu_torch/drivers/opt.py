"""Geometry optimization drivers.

PyTorch counterpart of ``pyseqm_tpu/drivers/opt.py``: fixed-step steepest
descent with and without a 5-candidate line search (cf.
Geometry_Optimization_SD(_LS), seqm/MolecularDynamics.py:5-156), the
warm batched L-BFGS, the production optimizer (the batched counterpart of
the reference's scipy L-BFGS-B workflow, examples/opt.py:63-79), whose
energy and gradient evaluations thread the last converged density in as
the SCF's initial guess, and the JAX package's optax-routed L-BFGS
(``make_lbfgs``, ``make_lbfgs_chunk``; optax's chain written by hand in
``_lbfgs.py``), whose every evaluation is a cold SCF of the whole batch
as one objective.  A ``utils.timing.Timing`` given as ``timing`` records
the work between two host reads as phase "optimize".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..constants import Constants
from ..models.energy import SEQMConfig, _packed_layout, _species_tensor, energy
from ..ops.density import static_pack_mat
from ..scf import init_density
from ..system import make_system
from ..utils.timing import timed
from ._lbfgs import LBFGSState, lbfgs_init, lbfgs_update

# energy evaluations of the optax-routed L-BFGS (one per objective call:
# the value and gradient at the current point, and each line-search trial)
lbfgs_evaluations = 0


def _inputs(const, species, coordinates, charges):
    """(species, coordinates, charges) on the device of ``const`` (every
    energy call checks the species)."""
    species = _species_tensor(species, const.device)
    if coordinates is not None:
        coordinates = torch.as_tensor(coordinates, dtype=const.dtype,
                                      device=const.device)
    if charges is not None:
        charges = torch.as_tensor(charges, dtype=torch.long,
                                  device=const.device)
    return species, coordinates, charges


def _warm_density(cfg: SEQMConfig, A: int, P: torch.Tensor) -> torch.Tensor:
    """The SCF warm start as the drivers carry it: at the static packed
    size when the run uses the packed electronic state."""
    packed = _packed_layout(cfg, A)
    if packed is None or P.shape[-1] == packed[1]:
        return P
    return static_pack_mat(P, *packed)


def _initial_density(const, cfg, species, coordinates, charges):
    P = init_density(const, make_system(const, species, coordinates,
                                        charges))
    return _warm_density(cfg, species.shape[1], P)


def _value_and_grad(const, tables, cfg, species, coords, P0, learned,
                    charges):
    """(Hf, dHf/dcoords, converged P) at ``coords`` from the guess P0."""
    c = coords.detach().requires_grad_(True)
    with torch.enable_grad():
        out = energy(const, tables, cfg, species, c, learned=learned, P0=P0,
                     charges=charges)
        (g,) = torch.autograd.grad(out.Hf.sum(), c)
    P = _warm_density(cfg, species.shape[1], out.P.detach())
    return out.Hf.detach(), g, P


def geometry_optimize_sd(
    const: Constants, tables, cfg: SEQMConfig, species, coordinates,
    alpha: float = 0.01, force_tol: float = 1.0e-4, max_evl: int = 1000,
    learned=None, log: bool = False, chunk: int = 0, charges=None,
    timing=None,
):
    """Fixed-step steepest descent; returns (coords, max|F|, dE).

    ``chunk > 0`` reads the host once per ``chunk`` force evaluations
    instead of once per evaluation; the whole batch freezes once
    max|F| <= force_tol (the evaluations left in that chunk still run, at
    the frozen geometry, and report its max|F| and dE)."""
    species, coordinates, charges = _inputs(const, species, coordinates,
                                            charges)
    P = _initial_density(const, cfg, species, coordinates, charges)

    def evaluate(x, P):
        Hf, g, P = _value_and_grad(const, tables, cfg, species, x, P,
                                   learned, charges)
        return -g, P, Hf

    if chunk > 0:
        done = torch.zeros((), dtype=torch.bool, device=const.device)
        nit = torch.zeros((), dtype=torch.long, device=const.device)
        Lprev = torch.zeros((), dtype=coordinates.dtype, device=const.device)
        ferr = dE = None
        for c in range(-(-max_evl // chunk)):
            first = c == 0
            with timed(timing, "optimize", const.device):
                for _ in range(chunk):
                    frc, Pn, L = evaluate(coordinates, P)
                    ferr = frc.abs().max()
                    Lmean = L.sum() / L.shape[0]
                    dE = torch.full_like(Lmean, float("inf")) if first \
                        else Lmean - Lprev
                    stop = done | (ferr <= force_tol)
                    coordinates = torch.where(done, coordinates,
                                              coordinates + alpha * frc)
                    P = torch.where(done, P, Pn)
                    nit = nit + (~done).long()
                    done, Lprev, first = stop, Lmean, False
            if log:
                print(f"{int(nit)} {float(ferr):e} {float(dE):e}")
            if bool(done):
                break
        return coordinates, ferr, dE

    Lold = None
    ferr = eerr = float("inf")
    for i in range(max_evl):
        with timed(timing, "optimize", const.device):
            frc, P, L = evaluate(coordinates, P)
        coordinates = coordinates + alpha * frc
        ferr = float(frc.abs().max())
        eerr = (float((L - Lold).sum() / L.shape[0]) if Lold is not None
                else float("inf"))
        Lold = L
        if log:
            print(f"{i + 1} {ferr:e} {eerr:e}")
        if ferr <= force_tol:
            break
    return (coordinates, torch.tensor(ferr, dtype=coordinates.dtype),
            torch.tensor(eerr, dtype=coordinates.dtype))


# step-size candidates of the line search, times each molecule's step
LS_CANDIDATES = (0.5, 0.75, 1.0, 1.25, 1.5)


def geometry_optimize_sd_ls(
    const: Constants, tables, cfg: SEQMConfig, species, coordinates,
    alpha: float = 0.01, force_tol: float = 1.0e-4, max_evl: int = 1000,
    learned=None, log: bool = False, charges=None, timing=None,
):
    """Steepest descent with a 5-candidate per-molecule line search
    (cf. Geometry_Optimization_SD_LS.onestep, MolecularDynamics.py:28-41):
    the five trial geometries of every molecule run as one energy call on
    a 5 x nmol batch, with the learned parameters (a dict's tensors
    repeated over the candidates; the JAX package's trial energies drop
    ``learned``).  Returns (coords, max|F|)."""
    species, coordinates, charges = _inputs(const, species, coordinates,
                                            charges)
    nmol = species.shape[0]
    ncand = len(LS_CANDIDATES)
    cand = torch.tensor(LS_CANDIDATES, dtype=coordinates.dtype,
                        device=const.device)
    species5 = species.repeat(ncand, 1)
    charges5 = None if charges is None else charges.repeat(ncand)
    learned5 = learned if learned is None or callable(learned) else {
        k: v.repeat((ncand,) + (1,) * (v.dim() - 1))
        for k, v in learned.items()}
    P = _initial_density(const, cfg, species, coordinates, charges)
    alphas = torch.full((nmol,), alpha, dtype=coordinates.dtype,
                        device=const.device)
    rows = torch.arange(nmol, device=const.device)
    ferr = float("inf")
    for i in range(max_evl):
        with timed(timing, "optimize", const.device):
            Hf, g, P = _value_and_grad(const, tables, cfg, species,
                                       coordinates, P, learned, charges)
            frc = -g
            trial = alphas[:, None] * cand[None, :]           # (nmol, 5)
            xs = coordinates[None] + frc[None] * trial.T[:, :, None, None]
            with torch.no_grad():
                out = energy(const, tables, cfg, species5,
                             xs.reshape((ncand * nmol,)
                                        + coordinates.shape[1:]),
                             learned=learned5, P0=P.repeat(ncand, 1, 1),
                             charges=charges5)
            eng = out.Etot.reshape(ncand, nmol)
            best = torch.argmin(eng, dim=0)
            alphas = torch.clamp(trial[rows, best], min=1.0e-3)
            coordinates = coordinates + alphas[:, None, None] * frc
        ferr = float(frc.abs().max())
        if log:
            print(f"{i + 1} {ferr:e}")
        if ferr <= force_tol:
            break
    return coordinates, torch.tensor(ferr, dtype=coordinates.dtype)


@dataclasses.dataclass
class _WarmLBFGSState:
    x: torch.Tensor        # (nmol, D) flattened coordinates
    E: torch.Tensor        # (nmol,) Hf at x
    g: torch.Tensor        # (nmol, D) dHf/dx at x
    P: torch.Tensor        # converged density at x (SCF warm start)
    S: torch.Tensor        # (hist, nmol, D) step history
    Y: torch.Tensor        # (hist, nmol, D) gradient-difference history
    rho: torch.Tensor      # (hist, nmol) 1/(s.y); 0 marks an empty slot
    idx: int               # next ring slot
    done: torch.Tensor     # (nmol,) per-molecule convergence freeze
    nit: int               # iterations that advanced at least one molecule
    bad: torch.Tensor      # (nmol,) consecutive forced (non-Armijo) accepts


def make_lbfgs_warm(const: Constants, tables, cfg: SEQMConfig, species,
                    chunk: int = 10, force_tol: float = 1.0e-3,
                    hist: int = 8, c1: float = 1.0e-4, shrink: float = 0.5,
                    max_backtrack: int = 8, learned=None, charges=None,
                    max_forced: int = 3):
    """Batched L-BFGS with SCF warm starts (the production optimizer).

    Every energy/gradient evaluation starts its SCF from the last
    accepted point's converged P; per-molecule Armijo backtracking runs
    one batched evaluation per backtrack step and stops as soon as every
    molecule has accepted (one host read per step); per-molecule
    histories and step lengths, the two-loop recursion batched over
    molecules.  A molecule failing Armijo ``max_forced`` times in a row
    (the last backtrack step force-accepts) is frozen.

    Returns (init_fn, run_fn): ``init_fn(coords) -> state`` (no SCF: E =
    +inf makes the first iteration a bootstrap that accepts x unchanged
    and fills E, g and P), ``run_fn(state) -> (state, E, max|g|)``
    advancing ``chunk`` iterations, each skipped once every molecule is
    done.
    """
    species, _, charges = _inputs(const, species, None, charges)
    nmol, A = species.shape
    D = A * 3
    amask = (species > 0)[..., None].expand(nmol, A, 3).reshape(nmol, D)

    def eval_vg(xflat, P0):
        Hf, g, P = _value_and_grad(const, tables, cfg, species,
                                   xflat.reshape(nmol, A, 3), P0, learned,
                                   charges)
        g = g.reshape(nmol, D)
        return Hf, torch.where(amask, g, torch.zeros_like(g)), P

    def init(coords):
        coords = torch.as_tensor(coords, dtype=const.dtype,
                                 device=const.device)
        x = coords.reshape(nmol, D)
        dtype, dev = x.dtype, x.device
        P0 = _initial_density(const, cfg, species, coords, charges)
        z = torch.zeros((hist, nmol, D), dtype=dtype, device=dev)
        return _WarmLBFGSState(
            x=x, E=torch.full((nmol,), float("inf"), dtype=dtype, device=dev),
            g=torch.zeros((nmol, D), dtype=dtype, device=dev), P=P0, S=z,
            Y=z.clone(), rho=torch.zeros((hist, nmol), dtype=dtype,
                                         device=dev),
            idx=0, done=torch.zeros((nmol,), dtype=torch.bool, device=dev),
            nit=0, bad=torch.zeros((nmol,), dtype=torch.long, device=dev))

    def direction(st: _WarmLBFGSState):
        """Two-loop recursion, batched over molecules; empty ring slots
        have rho = 0 and drop out arithmetically."""
        q = st.g
        alphas = []
        for i in range(hist):
            j = (st.idx - 1 - i) % hist
            a = st.rho[j] * (st.S[j] * q).sum(dim=-1)
            q = q - a[:, None] * st.Y[j]
            alphas.append((j, a))
        # H0 = gamma I from the newest valid pair
        jn = (st.idx - 1) % hist
        yy = (st.Y[jn] * st.Y[jn]).sum(dim=-1)
        sy = (st.S[jn] * st.Y[jn]).sum(dim=-1)
        one = torch.ones_like(yy)
        gamma = torch.where((st.rho[jn] > 0) & (yy > 0),
                            sy / torch.where(yy > 0, yy, one), one)
        r = gamma[:, None] * q
        for j, a in reversed(alphas):
            b = st.rho[j] * (st.Y[j] * r).sum(dim=-1)
            r = r + st.S[j] * (a - b)[:, None]
        d = -r
        # safeguard: fall back to steepest descent on non-descent dirs
        dg = (d * st.g).sum(dim=-1)
        bad = dg >= 0.0
        d = torch.where(bad[:, None], -st.g, d)
        dg = torch.where(bad, -(st.g * st.g).sum(dim=-1), dg)
        return d, dg

    def outer(st: _WarmLBFGSState) -> _WarmLBFGSState:
        d, dg = direction(st)
        d = torch.where(st.done[:, None], torch.zeros_like(d), d)
        dg = torch.where(st.done, torch.zeros_like(dg), dg)

        t = torch.ones((nmol,), dtype=st.x.dtype, device=st.x.device)
        acc = st.done
        xb, Eb, gb, Pb = st.x, st.E, st.g, st.P
        fb = torch.zeros_like(st.done)
        for k in range(max_backtrack):
            if bool(acc.all()):
                break
            xc = torch.where(acc[:, None], xb, st.x + t[:, None] * d)
            Ec, gc, Pc = eval_vg(xc, st.P)
            ok = Ec <= st.E + c1 * t * dg
            # the final pass force-accepts whatever remains so no molecule
            # stalls on a bad model step; forced accepts are counted below
            forced = ~acc & ~ok if k == max_backtrack - 1 else \
                torch.zeros_like(ok)
            take = (ok & ~acc) | forced
            xb = torch.where(take[:, None], xc, xb)
            Eb = torch.where(take, Ec, Eb)
            gb = torch.where(take[:, None], gc, gb)
            Pb = torch.where(take[:, None, None], Pc, Pb)
            t = torch.where(take | acc, t, t * shrink)
            acc = acc | take
            fb = fb | forced

        s = xb - st.x
        y = gb - st.g
        sy = (s * y).sum(dim=-1)
        ok = sy > 1.0e-10
        S, Y, rho = st.S.clone(), st.Y.clone(), st.rho.clone()
        S[st.idx] = torch.where(ok[:, None], s, torch.zeros_like(s))
        Y[st.idx] = torch.where(ok[:, None], y, torch.zeros_like(y))
        rho[st.idx] = torch.where(
            ok, 1.0 / torch.where(ok, sy, torch.ones_like(sy)),
            torch.zeros_like(sy))
        gerr = gb.abs().amax(dim=-1)
        # a molecule failing Armijo max_forced times in a row is frozen:
        # its model steps are not descending
        bad = torch.where(fb & ~st.done, st.bad + 1, torch.zeros_like(st.bad))
        done = st.done | (gerr <= force_tol) | (bad >= max_forced)
        return _WarmLBFGSState(x=xb, E=Eb, g=gb, P=Pb, S=S, Y=Y, rho=rho,
                               idx=(st.idx + 1) % hist, done=done,
                               nit=st.nit + 1, bad=bad)

    def run(st: _WarmLBFGSState):
        for _ in range(chunk):
            if bool(st.done.all()):
                break
            st = outer(st)
        return st, st.E, st.g.abs().max()

    return init, run


def _objective(const, tables, cfg, species, learned, charges):
    """The optax routes' objective: x -> (sum of Hf over the batch,
    pullback to its gradient), each call a cold SCF (no initial guess),
    the gradient unmasked, as the JAX package's ``value_fn``."""
    def objective(x):
        global lbfgs_evaluations
        lbfgs_evaluations += 1
        c = x.detach().requires_grad_(True)
        with torch.enable_grad():
            value = energy(const, tables, cfg, species, c, learned=learned,
                           charges=charges).Hf.sum()

        def pullback():
            (g,) = torch.autograd.grad(value, c)
            return g
        return value.detach(), pullback
    return objective


LINESEARCHES = ("zoom", "backtracking", "none")


def make_lbfgs(const: Constants, tables, cfg: SEQMConfig, species,
               learned=None, linesearch: str = "zoom",
               max_linesearch_steps: int = 15, charges=None):
    """The JAX package's optax-routed L-BFGS: returns (init_fn, step_fn).

    ``init_fn(coords) -> LBFGSState``; ``step_fn(coords, state) ->
    (new_coords, state, value, max|grad|)``, one outer iteration: the
    value (sum of Hf) and gradient at ``coords``, the gradient masked to
    real atoms, then ``optax.lbfgs``'s update with the line search
    ``linesearch``: "zoom" (optax's default, strong Wolfe with Hager and
    Zhang's approximate decrease, 20 steps), "backtracking" (Armijo,
    ``max_linesearch_steps`` steps, the gradient stored at the accepted
    point) or "none" (the unit step on the preconditioned direction).
    The whole batch is one vector: one step size for every molecule.
    """
    if linesearch not in LINESEARCHES:
        raise ValueError(f"linesearch must be one of {LINESEARCHES}, got "
                         f"{linesearch!r}")
    species, _, charges = _inputs(const, species, None, charges)
    objective = _objective(const, tables, cfg, species, learned, charges)
    amask = (species > 0)[..., None]
    search = None if linesearch == "none" else linesearch

    def init(coords) -> LBFGSState:
        return lbfgs_init(torch.as_tensor(coords, dtype=const.dtype,
                                          device=const.device))

    def step(coords, state: LBFGSState):
        coords = torch.as_tensor(coords, dtype=const.dtype,
                                 device=const.device)
        value, pullback = objective(coords)
        grads = pullback()
        grads = torch.where(amask, grads, torch.zeros_like(grads))
        updates, state = lbfgs_update(grads, state, coords, value.item(),
                                      objective, search,
                                      max_linesearch_steps)
        return coords + updates, state, value, grads.abs().max()

    return init, step


def make_lbfgs_chunk(const: Constants, tables, cfg: SEQMConfig, species,
                     chunk: int, force_tol: float = 0.0, learned=None,
                     linesearch: str = "zoom",
                     max_linesearch_steps: int = 15, charges=None):
    """:func:`make_lbfgs`, ``chunk`` outer iterations per call: returns
    (init_fn, run_fn); ``run_fn(coords, state, done, nit) -> (coords,
    state, done, nit, value, max|grad|)``.  Once max|grad| <= force_tol
    the whole state freezes: the iteration that sees it counts in ``nit``
    but neither moves the geometry nor updates the state, and the rest of
    the chunk is skipped (it would repeat the frozen point)."""
    init, step = make_lbfgs(const, tables, cfg, species, learned=learned,
                            linesearch=linesearch,
                            max_linesearch_steps=max_linesearch_steps,
                            charges=charges)

    def run(coords, state: LBFGSState, done: bool, nit: int):
        value = ferr = None
        for _ in range(chunk):
            if done and value is not None:
                break
            new_coords, new_state, value, ferr = step(coords, state)
            stop = done or float(ferr) <= force_tol
            if not stop:
                coords, state = new_coords, new_state
            nit += int(not done)
            done = stop
        return coords, state, done, nit, value, ferr

    return init, run


def geometry_optimize_lbfgs(
    const: Constants, tables, cfg: SEQMConfig, species, coordinates,
    force_tol: float = 1.0e-4, max_evl: int = 300, learned=None,
    log: bool = False, linesearch: Optional[str] = None, chunk: int = 0,
    charges=None, timing=None,
):
    """Batched L-BFGS; returns (coords, max|g|, iterations).

    ``chunk > 0`` with ``linesearch=None`` runs the warm batched L-BFGS
    (:func:`make_lbfgs_warm`), ``chunk`` iterations between host reads of
    the convergence flags; otherwise the optax route's host loop
    (:func:`make_lbfgs`, line search "zoom" unless named), which stops
    at the first point with max|g| <= force_tol and counts outer
    iterations (each runs one evaluation plus its line search's).  With
    ``chunk > 0`` and a line search ("zoom", "backtracking", "none") it
    runs whole chunks of ``chunk`` iterations, ``max_evl`` rounded up:
    what the JAX package's chunked route (:func:`make_lbfgs_chunk`)
    returns, whose scan saves host reads that an eager loop makes
    anyway."""
    if chunk > 0 and linesearch is None:
        init, run = make_lbfgs_warm(const, tables, cfg, species, chunk=chunk,
                                    force_tol=force_tol, learned=learned,
                                    charges=charges)
        state = init(coordinates)
        ferr = torch.tensor(float("inf"))
        for _ in range(-(-max_evl // chunk)):
            with timed(timing, "optimize", const.device):
                state, value, ferr = run(state)
            if log:
                print(f"{state.nit} {float(ferr):e} {float(value.sum()):e}")
            if bool(state.done.all()):
                break
        nmol, A = state.done.shape[0], state.x.shape[1] // 3
        return state.x.reshape(nmol, A, 3), ferr, state.nit
    if chunk > 0:
        # the chunked optax route: the host loop below in whole chunks
        # (make_lbfgs_chunk's freeze and count are the host loop's stop)
        max_evl = -(-max_evl // chunk) * chunk

    init, step = make_lbfgs(const, tables, cfg, species, learned=learned,
                            linesearch=linesearch or "zoom", charges=charges)
    coords = torch.as_tensor(coordinates, dtype=const.dtype,
                             device=const.device)
    state = init(coords)
    ferr = torch.tensor(float("inf"))
    iters = 0
    for i in range(max_evl):
        with timed(timing, "optimize", const.device):
            new_coords, state, value, ferr = step(coords, state)
        iters = i + 1
        if log:
            print(f"{i + 1} {float(ferr):e} {float(value):e}")
        if float(ferr) <= force_tol:
            break
        coords = new_coords
    return coords, ferr, iters
