"""L-BFGS with optax's line searches, written for eager torch.

The JAX package's optax-routed optimizer (``make_lbfgs``) runs
``optax.lbfgs`` (optax 0.2.6): ``scale_by_lbfgs(memory_size=10,
scale_init_precond=True)``, ``scale(-1)`` (or the learning rate 1.0, the
same map), then a line search.  This module repeats that chain operation
for operation on one tensor, the whole batch's coordinates: every dot
product runs over the flattened batch.

* :func:`lbfgs_direction` is ``scale_by_lbfgs``'s update: the memory
  ring written at ``count - 1``, the identity scale (capped reciprocal
  gradient norm at the first step), the two-loop recursion over all
  ``MEMORY_SIZE`` slots from the oldest.
* :func:`zoom_linesearch` is ``scale_by_zoom_linesearch`` with
  ``initial_guess_strategy="one"``: the interval search, the zoom with its
  cubic/quadratic/bisection safeguards and the safe step taken when it
  fails.
* :func:`backtracking_linesearch` is ``scale_by_backtracking_linesearch``
  with ``store_grad=True``.

The line searches' control flow and scalars (values, slopes, step sizes)
run on the host in float64: each trial point costs one host read of its
value and slope.  The vectors stay on the device.  An objective is a
callable ``x -> (value, pullback)``: ``value`` a 0-d tensor, ``pullback()``
the gradient at ``x`` (computed only when a search needs it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# optax 0.2.6's values as optax.lbfgs() uses them: the memory, the zoom
# search (20 steps, Armijo slope 1e-4, curvature 0.9, Hager and Zhang's
# approximate decrease within 1e-6 of the start, step doubling, interval
# precision 1e-5) and the backtracking search (decrease 0.8, increase
# 1.5, learning rate at most 1)
MEMORY_SIZE = 10
ZOOM_STEPS, SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 20, 1e-4, 0.9, 1e-6
ZOOM_INCREASE, STEPSIZE_PRECISION = 2.0, 1e-5
BT_DECREASE, BT_INCREASE, BT_MAX_LR = 0.8, 1.5, 1.0

Objective = Callable[[torch.Tensor], Tuple[torch.Tensor, Callable]]


@dataclasses.dataclass
class LBFGSState:
    """``optax.lbfgs``'s state as one record: ``scale_by_lbfgs``'s fields,
    then the line search's (``learning_rate``, ``value``, ``grad`` and its
    info; untouched by ``"none"``), plus ``failed``: the last line search
    ended without meeting its criteria (zoom: its ``failed`` flag;
    backtracking: a positive decrease error)."""
    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params_memory: torch.Tensor    # (MEMORY_SIZE, *params.shape)
    diff_updates_memory: torch.Tensor
    weights_memory: torch.Tensor        # (MEMORY_SIZE,)
    learning_rate: float
    value: float
    grad: torch.Tensor
    num_linesearch_steps: int
    decrease_error: float
    curvature_error: float
    failed: bool


def lbfgs_init(params: torch.Tensor) -> LBFGSState:
    z = torch.zeros((MEMORY_SIZE,) + tuple(params.shape), dtype=params.dtype,
                    device=params.device)
    return LBFGSState(
        count=0, params=torch.zeros_like(params),
        updates=torch.zeros_like(params), diff_params_memory=z,
        diff_updates_memory=z.clone(),
        weights_memory=torch.zeros((MEMORY_SIZE,), dtype=params.dtype,
                                   device=params.device),
        learning_rate=1.0, value=math.inf, grad=torch.zeros_like(params),
        num_linesearch_steps=0, decrease_error=math.inf,
        curvature_error=math.inf, failed=False)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum()


def lbfgs_direction(updates: torch.Tensor, state: LBFGSState,
                    params: torch.Tensor) -> Tuple[torch.Tensor, LBFGSState]:
    """``scale_by_lbfgs``'s update: store the newest (dw, du) pair, then
    return P_k u_k with the new memory (the sign is the caller's)."""
    m = MEMORY_SIZE
    memory_idx = state.count % m
    prev_idx = (state.count - 1) % m
    if state.count > 0:
        dw = params - state.params
        du = updates - state.updates
        sy = _vdot(du, dw)
        weight = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
    else:
        dw = torch.zeros_like(params)
        du = torch.zeros_like(params)
        weight = torch.zeros((), dtype=params.dtype, device=params.device)
    dwm = state.diff_params_memory.clone()
    dum = state.diff_updates_memory.clone()
    rhos = state.weights_memory.clone()
    dwm[prev_idx], dum[prev_idx], rhos[prev_idx] = dw, du, weight

    if state.count > 0:
        num = _vdot(du, dw)
        den = _vdot(du, du)
        scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
    else:
        # the first step: a capped reciprocal of the gradient norm
        scale = torch.clamp(1.0 / torch.sqrt(_vdot(updates, updates)),
                            max=1.0)

    indices = [(memory_idx + i) % m for i in range(m)]
    vec = updates
    alphas = {}
    for idx in reversed(indices):
        alpha = rhos[idx] * _vdot(dwm[idx], vec)
        vec = vec - alpha * dum[idx]
        alphas[idx] = alpha
    vec = scale * vec
    for idx in indices:
        beta = rhos[idx] * _vdot(dum[idx], vec)
        vec = vec + (alphas[idx] - beta) * dwm[idx]
    return vec, dataclasses.replace(
        state, count=state.count + 1, params=params, updates=updates,
        diff_params_memory=dwm, diff_updates_memory=dum, weights_memory=rhos)


# scalar arithmetic of the line searches: float64 numpy scalars, so a
# division by zero or the square root of a negative number gives inf or
# nan as in the JAX programs instead of raising
_f = np.float64


def _nan_to_inf(x):
    return _f(math.inf) if np.isnan(x) else x


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin``: the critical point of the cubic through
    (a, fa), (b, fb), (c, fc) with slope fpa at a (nan if none)."""
    with np.errstate(all="ignore"):
        C = fpa
        db = b - a
        dc = c - a
        denom = (db * dc) ** 2 * (db - dc)
        r0 = fb - fa - C * db
        r1 = fc - fa - C * dc
        A = (dc ** 2 * r0 + (-(db ** 2)) * r1) / denom
        B = ((-(dc ** 3)) * r0 + db ** 3 * r1) / denom
        radical = B * B - _f(3.0) * A * C
        return a + (-B + np.sqrt(radical)) / (_f(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's ``_quadmin``: the critical point of the parabola through
    (a, fa), (b, fb) with slope fpa at a."""
    with np.errstate(all="ignore"):
        D = fa
        C = fpa
        db = b - a
        B = (fb - D - C * db) / (db ** 2)
        return a - C / (_f(2.0) * B)


@dataclasses.dataclass
class _Trial:
    stepsize: np.float64
    value: np.float64
    grad: torch.Tensor
    slope: np.float64


def _on_line(objective: Objective, params, updates, stepsize) -> _Trial:
    """Value, gradient and slope along ``updates`` at ``stepsize``: one
    objective evaluation and one host read."""
    value, pullback = objective(params + float(stepsize) * updates)
    grad = pullback()
    v, s = torch.stack([value, _vdot(grad, updates)]).tolist()
    return _Trial(_f(stepsize), _f(v), grad, _f(s))


def zoom_linesearch(objective: Objective, params: torch.Tensor,
                    updates: torch.Tensor, value: float, grad: torch.Tensor):
    """``scale_by_zoom_linesearch``'s update with the initial guess 1, no
    maximal step and no tolerance: returns (stepsize, value, grad, count,
    decrease_error, curvature_error, failed) of its final state."""
    value_init = _f(value)
    slope_init = _f(_vdot(updates, grad).item())

    def decrease_error(t: _Trial):
        # Armijo, or Hager and Zhang's approximate decrease once the value
        # is within APPROX_DEC_RTOL of the start; nan counts as violated
        with np.errstate(all="ignore"):
            err = t.value - value_init - SLOPE_RTOL * t.stepsize * slope_init
            approx = t.slope - (2 * SLOPE_RTOL - 1.0) * slope_init
            delta = t.value - value_init - APPROX_DEC_RTOL * abs(value_init)
            err = np.minimum(np.maximum(approx, delta), err)
        return _nan_to_inf(np.maximum(err, _f(0.0)))

    def curvature_error(t: _Trial):
        with np.errstate(all="ignore"):
            err = abs(t.slope) - CURV_RTOL * abs(slope_init)
        return _nan_to_inf(np.maximum(err, _f(0.0)))

    cur = _Trial(_f(0.0), value_init, grad, slope_init)
    low = high = cubic_ref = cur
    safe = cur
    count, interval_found, done, failed = 0, False, False, False
    dec = curv = _f(math.inf)
    while not (done or failed):
        if not interval_found:
            # the interval search, Algorithm 3.5 of Nocedal and Wright
            prev = cur
            t = _f(1.0) if count == 0 else ZOOM_INCREASE * prev.stepsize
            cur = _on_line(objective, params, updates, t)
            dec, curv = decrease_error(cur), curvature_error(cur)
            err = np.maximum(dec, curv)
            if dec <= 0.0:
                safe = cur
            set_high = (dec > 0.0) or (cur.value >= prev.value and count > 0)
            set_low = cur.slope >= 0.0 and not set_high
            low, high = (cur, prev) if set_low else (prev, cur)
            cubic_ref = low
            interval_found = set_high or set_low or err <= 0.0
            done = bool(err <= 0.0)
            failed = count + 1 >= ZOOM_STEPS and not done
        else:
            # the zoom, Algorithm 3.6 of Nocedal and Wright
            delta = abs(high.stepsize - low.stepsize)
            left = min(high.stepsize, low.stepsize)
            right = max(high.stepsize, low.stepsize)
            too_small = delta <= STEPSIZE_PRECISION
            mc = _cubicmin(low.stepsize, low.value, low.slope, high.stepsize,
                           high.value, cubic_ref.stepsize, cubic_ref.value)
            mq = _quadmin(low.stepsize, low.value, low.slope, high.stepsize,
                          high.value)
            if left + 0.2 * delta < mc < right - 0.2 * delta:
                middle = mc
            elif left + 0.1 * delta < mq < right - 0.1 * delta:
                middle = mq
            else:
                middle = (low.stepsize + high.stepsize) / 2.0
            cur = _on_line(objective, params, updates, middle)
            dec, curv = decrease_error(cur), curvature_error(cur)
            err = np.maximum(dec, curv)
            if dec <= 0.0 and cur.value < safe.value:
                safe = cur
            done = bool(err <= 0.0)
            set_high_mid = dec > 0.0 or cur.value >= low.value
            set_high_low = (cur.slope * (high.stepsize - low.stepsize) >= 0.0
                            and not set_high_mid)
            cubic_ref = high if set_high_mid or set_high_low else low
            new_high = cur if set_high_mid else high
            if set_high_low:
                new_high = low
            if not set_high_mid:
                low = cur
            high = new_high
            failed = ((count + 1 >= ZOOM_STEPS
                       or (too_small and safe.stepsize > 0.0)) and not done)
        count += 1
        if failed and (safe.stepsize > 0.0 or np.isinf(dec)):
            # the safe step: the best point with sufficient decrease
            cur = dataclasses.replace(cur, stepsize=safe.stepsize,
                                      value=safe.value, grad=safe.grad)
    return (float(cur.stepsize), float(cur.value), cur.grad, count,
            float(dec), float(curv), failed)


def backtracking_linesearch(objective: Objective, params: torch.Tensor,
                            updates: torch.Tensor, value: float,
                            grad: torch.Tensor, learning_rate: float,
                            max_backtracking_steps: int):
    """``scale_by_backtracking_linesearch(store_grad=True)``'s update from
    the previous learning rate, with no tolerances: returns
    (learning_rate, value, grad, steps, decrease_error).  The gradient is
    taken only at the point that ends the search."""
    value = _f(value)
    slope = _f(_vdot(updates, grad).item())
    lr = _f(min(BT_INCREASE * learning_rate, BT_MAX_LR))
    new_value, new_grad = value, torch.zeros_like(params)
    dec = _f(math.inf)
    it = 0
    while not dec <= 0.0 and it <= max_backtracking_steps:
        if it > 0:
            lr = BT_DECREASE * lr
        v, pullback = objective(params + float(lr) * updates)
        new_value = _f(v.item())
        with np.errstate(all="ignore"):
            dec = new_value - value - lr * SLOPE_RTOL * slope
        dec = _f(math.inf) if np.isnan(dec) else max(dec, _f(0.0))
        if dec <= 0.0 or it == max_backtracking_steps:
            new_grad = pullback()
        it += 1
    lr = 0.0 if np.isinf(dec) else float(lr)
    return lr, float(new_value), new_grad, it, float(dec)


def lbfgs_update(grad: torch.Tensor, state: LBFGSState,
                 params: torch.Tensor, value: float, objective: Objective,
                 linesearch: Optional[str],
                 max_linesearch_steps: int = 15):
    """One ``optax.lbfgs`` update: (updates, state) with
    ``params + updates`` the next point.  ``linesearch`` is "zoom"
    (optax.lbfgs()'s default search, ZOOM_STEPS steps), "backtracking"
    (``max_linesearch_steps`` steps) or None (the unit step)."""
    direction, state = lbfgs_direction(grad, state, params)
    direction = -direction
    if linesearch is None:
        return direction, state
    if linesearch == "zoom":
        lr, v, g, n, dec, curv, failed = zoom_linesearch(
            objective, params, direction, value, grad)
    elif linesearch == "backtracking":
        lr, v, g, n, dec = backtracking_linesearch(
            objective, params, direction, value, grad, state.learning_rate,
            max_linesearch_steps)
        curv, failed = state.curvature_error, dec > 0.0
    else:
        raise ValueError(f"unknown line search {linesearch!r}")
    return lr * direction, dataclasses.replace(
        state, learning_rate=lr, value=v, grad=g, num_linesearch_steps=n,
        decrease_error=dec, curvature_error=curv, failed=bool(failed))
