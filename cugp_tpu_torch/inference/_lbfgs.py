"""L-BFGS with a zoom line search: ``optax.lbfgs(learning_rate=None)``.

A plain-torch copy of the update that ``cugp_tpu/inference/map_opt.py``
takes from optax: ``scale_by_lbfgs(memory_size=10,
scale_init_precond=True)`` (the two-loop recursion of Nocedal & Wright,
Algorithm 7.4, with optax's capped first scale), then ``scale(-1)``, then
``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")`` with its other defaults (Algorithms 3.5
and 3.6, with optax's approximate-Wolfe decrease test and its safe-step
fallback). The same constants and the same branch decisions make the
same iterates, so the port can be held against JAX step by step, which
``torch.optim.LBFGS`` (its own strong-Wolfe search and first-step
scaling) would not allow.

The direction is formed on the parameters' device in float32. The line
search decides on the host: each trial point costs one value-and-gradient
evaluation and one read of (value, slope) back to the host, and its
scalar arithmetic runs on float32 CPU tensors, so it rounds as optax's
float32 scalars do (NaN propagates through max/min, a division by zero
gives inf).
"""

from __future__ import annotations

import collections
import math

import torch


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
# scale_by_zoom_linesearch's defaults: tol, increase_factor, slope_rtol,
# curv_rtol, approx_dec_rtol, stepsize_precision; the first trial step
# is 1 ("one")
_TOL = _f32(0.0)
_INCREASE = _f32(2.0)
_SLOPE_RTOL = _f32(1e-4)
_CURV_RTOL = _f32(0.9)
_APPROX_DEC_RTOL = _f32(1e-6)
_STEPSIZE_PRECISION = _f32(1e-5)
_FIRST_STEP = _f32(1.0)


def _decrease_error(eta, value, slope, value0, slope0):
    dec = value - value0 - _SLOPE_RTOL * eta * slope0
    approx = slope - (2.0 * _SLOPE_RTOL - 1.0) * slope0
    delta = value - value0 - _APPROX_DEC_RTOL * torch.abs(value0)
    dec = torch.minimum(torch.maximum(approx, delta), dec)
    dec = torch.maximum(dec, _f32(0.0))
    return torch.where(torch.isnan(dec), _f32(math.inf), dec)


def _curvature_error(slope, slope0):
    curv = torch.maximum(torch.abs(slope) - _CURV_RTOL * torch.abs(slope0),
                         _f32(0.0))
    return torch.where(torch.isnan(curv), _f32(math.inf), curv)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when there is none)."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    rb, rc = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc ** 2 * rb - db ** 2 * rc) / denom
    B = (-(dc ** 3) * rb + db ** 3 * rc) / denom
    radical = B * B - 3.0 * A * fpa
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def zoom_linesearch(phi, value_init, slope_init):
    """optax.scale_by_zoom_linesearch's search along one direction.

    phi(eta) -> (value, slope) at params + eta * direction, on the host.
    Returns (stepsize, trial points evaluated).
    """
    v0, s0 = _f32(value_init), _f32(slope_init)
    zero, inf = _f32(0.0), _f32(math.inf)
    eta, value, slope = zero, v0, s0
    dec_err = inf
    low, v_low, s_low = zero, v0, s0
    high, v_high, s_high = zero, v0, s0
    cubic_ref, v_cubic_ref = zero, v0
    safe, v_safe = zero, v0
    interval_found = done = failed = False
    count = 0
    while not (done or failed):
        if not interval_found:
            # Algorithm 3.5: grow the step until an interval brackets a
            # point meeting both criteria
            new = _FIRST_STEP if count == 0 else _INCREASE * eta
            v_new, s_new = (_f32(t) for t in phi(new))
            dec_err = _decrease_error(new, v_new, s_new, v0, s0)
            err = torch.maximum(dec_err, _curvature_error(s_new, s0))
            if bool(dec_err <= _TOL):
                safe, v_safe = new, v_new
            high_new = bool(dec_err > 0.0) or (bool(v_new >= value)
                                               and count > 0)
            low_new = bool(s_new >= 0.0) and not high_new
            if low_new:
                low, v_low, s_low = new, v_new, s_new
                high, v_high, s_high = eta, value, slope
            else:
                low, v_low, s_low = eta, value, slope
                high, v_high, s_high = new, v_new, s_new
            cubic_ref, v_cubic_ref = low, v_low
            done = bool(err <= _TOL)
            interval_found = high_new or low_new or done
            failed = count + 1 >= MAX_LINESEARCH_STEPS and not done
        else:
            # Algorithm 3.6: zoom by cubic, then quadratic interpolation,
            # then bisection
            delta = torch.abs(high - low)
            left, right = torch.minimum(high, low), torch.maximum(high, low)
            mid_c = _cubicmin(low, v_low, s_low, high, v_high, cubic_ref,
                              v_cubic_ref)
            mid_q = _quadmin(low, v_low, s_low, high, v_high)
            if bool((mid_c > left + 0.2 * delta)
                    & (mid_c < right - 0.2 * delta)):
                new = mid_c
            elif bool((mid_q > left + 0.1 * delta)
                      & (mid_q < right - 0.1 * delta)):
                new = mid_q
            else:
                new = (low + high) / 2.0
            v_new, s_new = (_f32(t) for t in phi(new))
            dec_err = _decrease_error(new, v_new, s_new, v0, s0)
            err = torch.maximum(dec_err, _curvature_error(s_new, s0))
            if bool(dec_err <= _TOL) and bool(v_new < v_safe):
                safe, v_safe = new, v_new
            done = bool(err <= _TOL)
            high_to_mid = bool(dec_err > 0.0) or bool(v_new >= v_low)
            high_to_low = (bool(s_new * (high - low) >= 0.0)
                           and not high_to_mid)
            if high_to_mid or high_to_low:
                cubic_ref, v_cubic_ref = high, v_high
            else:
                cubic_ref, v_cubic_ref = low, v_low
            if high_to_mid:
                high, v_high, s_high = new, v_new, s_new
            if high_to_low:
                high, v_high, s_high = low, v_low, s_low
            if not high_to_mid:
                low, v_low, s_low = new, v_new, s_new
            too_small = bool(delta <= _STEPSIZE_PRECISION)
            failed = (count + 1 >= MAX_LINESEARCH_STEPS
                      or (too_small and bool(safe > 0.0))) and not done
        eta, value, slope = new, v_new, s_new
        count += 1
        if failed and (bool(safe > 0.0) or bool(torch.isinf(dec_err))):
            # no step met both criteria: take the best one that met
            # sufficient decrease (0 when none did)
            eta = safe
    return eta, count


class LBFGS:
    """optax.lbfgs(learning_rate=None) on a flat float32 parameter vector.

    ``step(x, value, grad, value_and_grad)`` takes the value and gradient
    at x and returns (x + eta * d, line-search trials), d the L-BFGS
    descent direction; value_and_grad(x) -> (value, grad) tensors.
    """

    def __init__(self):
        self.memory = collections.deque(maxlen=MEMORY_SIZE)
        self.count = 0
        self.prev_x = self.prev_g = None

    def direction(self, x, g):
        """-P g, P the inverse-Hessian estimate of the last pairs."""
        if self.count > 0:
            s, yv = x - self.prev_x, g - self.prev_g
            sy = torch.dot(yv, s)
            rho = torch.where(sy == 0.0, 0.0, 1.0 / sy)
            self.memory.append((s, yv, rho))
            yy = torch.dot(yv, yv)
            gamma = torch.where(yy > 0.0, sy / yy, 1.0)
        else:
            # first step: a capped reciprocal of the gradient norm
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        self.prev_x, self.prev_g = x, g
        self.count += 1
        q, alphas = g, []
        for s, yv, rho in reversed(self.memory):
            a = rho * torch.dot(s, q)
            q = q - a * yv
            alphas.append(a)
        r = gamma * q
        for (s, yv, rho), a in zip(self.memory, reversed(alphas)):
            r = r + (a - rho * torch.dot(yv, r)) * s
        return -r

    def step(self, x, value, grad, value_and_grad):
        d = self.direction(x, grad)

        def phi(eta):
            v, g = value_and_grad(x + eta * d)
            return torch.stack([v, torch.dot(g, d)]).cpu()

        v0, s0 = torch.stack([value.detach(), torch.dot(d, grad)]).cpu()
        eta, trials = zoom_linesearch(phi, v0, s0)
        return x + eta * d, trials
