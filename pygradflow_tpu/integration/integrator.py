"""Adaptive implicit integrators for the stiff restricted flow.

The reference integrates with scipy's BDF + analytic Jacobian + scipy event
root-finding (``integration_solver.py:278-285``).  This engine
ships two self-contained adaptive one-step methods, fully jit-compiled, so
a whole integration *segment* (advance until any event crossing) runs as
one ``lax.while_loop`` on device; event times are then refined by
host-driven bisection re-using the jitted single-step kernel (the
reference likewise re-enters Python per event).

- **TR-BDF2** (default): the L-stable trapezoidal/BDF2 composite of Bank
  et al. with the Hosea-Shampine embedded 3rd-order error estimate.  Both
  stages share the implicit weight ``d = gamma/2`` (``gamma = 2 - sqrt 2``),
  so ONE dense Jacobian factorization per attempted step serves every
  frozen-Jacobian Newton iteration of both stages — vs up to
  ``3*NEWTON_MAX_IT`` factorizations for step-doubled implicit Euler.
- **Implicit Euler** with step-doubling/Richardson error control: three
  full-Newton solves per attempted step; kept as the maximally robust
  fallback (``Params.integration_method``).
"""

import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..jit import jit
from ..linalg.plu import plu_factor, plu_solve
from ..params import IntegrationMethod
from . import events as ev
from . import flow as fl

NEWTON_MAX_IT = 8
NEWTON_TOL_FACTOR = 1e-3  # relative to the step error tolerance


# event-bisection probe validation: a probe whose flow residuum exceeds
# this factor times the bracket entry's residuum converged to a spurious
# implicit-equation root (see bisect_event docstring); legitimate
# within-bracket growth is O(1), the spurious case is ~1e9x
BISECT_BLOWUP = 100.0

# event-bracket stop tolerance (relative to |t_hi|).  Every bisection
# probe is one implicit step, and the post-event state is tolerant of a
# small location offset: a pinned variable is clipped exactly onto its bound regardless, release/penalty
# events only flip the filter / scale rho, and pure-convergence crossings
# skip bisection entirely (any point past the crossing has residuum
# <= opt_tol).  1e-9 cuts ~10 probes per event vs the previous 1e-12
# with every parity anchor's event/segment sequence unchanged (1e-6 cut
# ~20 but flipped TR-BDF2 HS71 to 11 segments vs the reference's 10 —
# measured, do not loosen further).
BISECT_RTOL = 1e-9

# TR-BDF2 constants (gamma = 2 - sqrt(2): equal implicit weights in both
# stages, L-stability)
TRBDF2_GAMMA = 2.0 - math.sqrt(2.0)
TRBDF2_D = TRBDF2_GAMMA / 2.0  # implicit weight, both stages
# stage-2 (BDF2) combination w = AZ*z + AW*w_gamma + D*h*f(w)
TRBDF2_AW = 1.0 / (TRBDF2_GAMMA * (2.0 - TRBDF2_GAMMA))
TRBDF2_AZ = 1.0 - TRBDF2_AW
# embedded error weights: est = h/3 * (E1*f(z) + E2*f(w_gamma) + E3*f(w))
# (difference of the order-2 weights b = [sqrt2/4, sqrt2/4, 1-sqrt2/2]
# against the 3rd-order quadrature weights for nodes [0, gamma, 1])
TRBDF2_E1 = math.sqrt(2.0) - 1.0
TRBDF2_E2 = -1.0
TRBDF2_E3 = 2.0 - math.sqrt(2.0)

# SDIRK4: Hairer & Wanner II Table 6.5 (gamma = 1/4) — L-stable, stiffly
# accurate, order 4 with an embedded order-3 estimate.  All order
# conditions and R(-inf) = 0 are re-verified in
# tests/test_integrator_methods.py from these exact rationals.
SDIRK4_GAMMA = 0.25
SDIRK4_A = (
    (1.0 / 4.0,),
    (1.0 / 2.0, 1.0 / 4.0),
    (17.0 / 50.0, -1.0 / 25.0, 1.0 / 4.0),
    (371.0 / 1360.0, -137.0 / 2720.0, 15.0 / 544.0, 1.0 / 4.0),
    (25.0 / 24.0, -49.0 / 48.0, 125.0 / 16.0, -85.0 / 12.0, 1.0 / 4.0),
)
# b - b_hat: b = last row of A (stiff accuracy), b_hat the embedded
# order-3 weights (59/48, -17/96, 225/32, -85/12, 0)
SDIRK4_E = (-3.0 / 16.0, -27.0 / 32.0, 25.0 / 32.0, 0.0, 1.0 / 4.0)


def _scaled_norm(v, ref, rtol, atol):
    """scipy-style rms norm with per-component scale atol + rtol*|ref|."""
    scale = atol + rtol * jnp.abs(ref)
    r = v / scale
    return jnp.sqrt(jnp.mean(r * r))


def _pick_predictor(res_fn, cands, valid=None):
    """Select the stage-Newton start with the smallest finite stage
    residual among ``cands`` (one rhs eval each).  Non-finite residuals
    rank last, so an overflowing extrapolation can never displace a
    usable candidate (and vice versa).  ``valid`` (optional, parallel to
    ``cands``) masks candidates out entirely — an invalid candidate must
    behave exactly as if it were never offered, so a traced no-history
    marker (``h_prev <= 0``) reproduces the untraced ``hist=None`` path
    decision for decision."""
    W = jnp.stack(cands)
    # one vmapped eval for all candidates: one batched op instead of a
    # separate op per res_fn call
    rs = jnp.linalg.norm(jax.vmap(res_fn)(W), axis=-1)
    rs = jnp.where(jnp.isfinite(rs), rs, jnp.inf)
    if valid is not None:
        ok = jnp.stack([jnp.asarray(v) for v in valid])
        rs = jnp.where(ok, rs, jnp.inf)
    return W[jnp.argmin(rs)]


def _prefer_challenger(res_fn, incumbent, challenger, valid, margin=0.5):
    """Two-way predictor choice with a DECISIVE margin: the challenger
    replaces the incumbent only when its stage residual is finite and
    under ``margin`` times the incumbent's (or the incumbent's is
    non-finite).  The margin matters for determinism, not accuracy:
    during the slow-manifold creep the f-based and history-extrapolated
    predictors converge to the same line, an argmin between near-equal
    residuals flips on last-ulp differences that vary with vectorization
    width (vmap batch vs single), and though either pick converges to the
    same stage root, the flip breaks the flat-engine == host-driver
    trajectory identity.  Near-equal ⇒ keep the incumbent; the challenger
    wins exactly where it carries its measured value — when the incumbent
    is headed out of the Newton basin and the residual gap is orders of
    magnitude, far from the margin boundary."""
    r = jnp.linalg.norm(
        jax.vmap(res_fn)(jnp.stack([incumbent, challenger])), axis=-1
    )
    r_i, r_c = r[0], r[1]
    better = jnp.logical_and(
        jnp.logical_and(jnp.asarray(valid), jnp.isfinite(r_c)),
        jnp.logical_or(r_c < margin * r_i, ~jnp.isfinite(r_i)),
    )
    return jnp.where(better, challenger, incumbent)


def _hist_candidate(z, z_prev, h_prev, theta_h):
    """Cross-step linear predictor: extrapolate the line through the last
    two ACCEPTED points to the stage time ``t + c_i*h`` (``theta_h`` =
    ``c_i*h``).  This is the degree-1 version of the multistep (BDF-style)
    predictor that lets the reference's scipy BDF-5 cross the final
    slow-manifold creep in ~40 steps (reference
    ``integration_solver.py:278-285``): in the creep the trajectory is
    nearly straight in t, the f-based guess ``z + c_i*h*f`` routinely
    leaves the frozen-Newton basin, and the intra-step stage extrapolation
    only exists from stage 2 on — this candidate covers stage 1 (and
    often wins outright).  ``h_prev <= 0`` marks no-history (start of a
    segment / after an event where the flow changed / a bisection probe);
    the caller must then mask the candidate out via ``_pick_predictor``'s
    ``valid`` argument (returning ``z`` here is only a finite
    placeholder)."""
    theta = theta_h / jnp.maximum(h_prev, jnp.asarray(1e-300, z.dtype))
    theta = jnp.where(h_prev > 0.0, theta, 0.0)
    return z + theta * (z - z_prev)


def implicit_euler_step(ctx, z, h, rho, filter, rtol, atol):
    """One implicit-Euler step: solve w = z + h f(w) by full Newton with
    the dense Jacobian; returns (w, converged, num_newton).  Error control
    is per-component (scipy-style), so small components (duals, constraint
    values) are resolved to atol rather than to rtol*||z||."""

    def newton_body(carry):
        w, i, err = carry
        g = w - z - h * fl.rhs(ctx, w, rho, filter)
        Jf = fl.rhs_jac(ctx, w, rho, filter)
        n_all = g.shape[0]
        A = jnp.eye(n_all, dtype=g.dtype) - h * Jf
        dw = plu_solve(plu_factor(A), g)
        w = w - dw
        return (w, i + 1, _scaled_norm(dw, w, rtol, atol))

    def newton_cond(carry):
        _, i, err = carry
        return jnp.logical_and(i < NEWTON_MAX_IT, err > NEWTON_TOL_FACTOR)

    w0 = z + h * fl.rhs(ctx, z, rho, filter)  # explicit predictor
    (w, iters, err) = jax.lax.while_loop(
        newton_cond, newton_body, (w0, jnp.zeros((), jnp.int32), jnp.asarray(jnp.inf, z.dtype))
    )
    ok = jnp.logical_and(err <= 1.0, jnp.all(jnp.isfinite(w)))
    return w, ok, iters


def _make_stage_newton(ctx, fact, dh, rho, filter, rtol, atol):
    """Shared implicit-stage solver for the DIRK methods: frozen-Jacobian
    iteration first (one shared factorization ``fact`` of
    ``I - dh*J(z)``), escalating to full Newton — fresh ``J(w)`` and
    refactorization per iteration, exactly as the implicit-Euler path
    does throughout — when the frozen iteration stalls or blows up
    (strongly nonlinear flows at large ``rho*h``).

    Replacing these while_loops with statically unrolled masked sweeps
    (NEWTON_MAX_IT slots, carry frozen once converged) made the B=64
    batched sweep slower on the earlier accelerator: unlike the PLU
    substitution sweeps (``linalg/plu.py``), the wasted Newton slots run
    real work (rhs evals + solves) that costs more than the loop
    boundaries they remove.  Not yet re-measured on the GPU."""

    def newton(res_fn, w0):
        n_all = w0.shape[0]
        dtype = w0.dtype

        def cond(carry):
            _, i, err = carry
            return jnp.logical_and(i < NEWTON_MAX_IT, err > NEWTON_TOL_FACTOR)

        def frozen_body(carry):
            w, i, err = carry
            dw = plu_solve(fact, res_fn(w))
            w = w - dw
            return (w, i + 1, _scaled_norm(dw, w, rtol, atol))

        def full_body(carry):
            w, i, err = carry
            Jw = fl.rhs_jac(ctx, w, rho, filter)
            A = jnp.eye(n_all, dtype=dtype) - dh * Jw
            dw = plu_solve(plu_factor(A), res_fn(w))
            w = w - dw
            return (w, i + 1, _scaled_norm(dw, w, rtol, atol))

        init = (w0, jnp.zeros((), jnp.int32), jnp.asarray(jnp.inf, dtype))
        w, iters, err = jax.lax.while_loop(cond, frozen_body, init)
        ok = jnp.logical_and(err <= 1.0, jnp.all(jnp.isfinite(w)))

        def escalate(_):
            # From-scratch restart, deliberately NOT warm-started: this
            # branch is only selected when the frozen iteration truly
            # diverged (err > 1.0 — a stalled-but-converging endpoint is
            # already accepted by the frozen branch), and full Newton from
            # a diverged endpoint lands on wrong stage roots (measured:
            # warm-starting turned the nominal HS71 SDIRK4 solve from 194
            # into 2302 steps).
            #
            # err_start masks CONVERGED lanes out of the loop under vmap:
            # a vmapped lax.cond lowers to a select that evaluates both
            # branches for every lane, and with a plain err=inf init the
            # escalation loop re-solved every stage for every lane every
            # step (~half the batched engine's per-work-unit cost).  With
            # err_start=0 those lanes fail the loop cond immediately, so
            # the batched trip count is the max over lanes that actually
            # need escalating — zero when none does.  Selected results are
            # unchanged: ok lanes take the frozen branch of the cond.
            err_start = jnp.where(ok, jnp.zeros((), dtype), jnp.asarray(jnp.inf, dtype))
            wf, itf, errf = jax.lax.while_loop(
                cond, full_body, (w0, jnp.zeros((), jnp.int32), err_start)
            )
            okf = jnp.logical_and(errf <= 1.0, jnp.all(jnp.isfinite(wf)))
            return wf, okf, iters + itf

        return jax.lax.cond(ok, lambda _: (w, ok, iters), escalate, None)

    return newton


def trbdf2_step(ctx, z, h, rho, filter, rtol, atol, hist=None):
    """One TR-BDF2 step from ``z``: TR stage to ``z + gamma*h``, BDF2
    stage to ``z + h``.  Both stages solve with the SAME frozen matrix
    ``M = I - d*h*J(z)`` (simplified Newton), so the whole step costs one
    dense factorization plus back-solves.  ``hist = (z_prev, h_prev)`` is
    the previous ACCEPTED point (see :func:`_hist_candidate`).  Returns
    ``(w, ok, num_newton, est)`` where ``est`` is the stiffly-filtered
    embedded local-error estimate (Hosea & Shampine)."""
    fz = fl.rhs(ctx, z, rho, filter)
    J = fl.rhs_jac(ctx, z, rho, filter)
    n_all = z.shape[0]
    M = jnp.eye(n_all, dtype=z.dtype) - (TRBDF2_D * h) * J
    fact = plu_factor(M)

    dh = TRBDF2_D * h
    newton = _make_stage_newton(ctx, fact, dh, rho, filter, rtol, atol)

    # TR stage: w1 = z + d*h*(f(z) + f(w1))
    def res1(ww):
        return ww - z - dh * (fz + fl.rhs(ctx, ww, rho, filter))

    w1_init = z + TRBDF2_GAMMA * h * fz
    if hist is not None:
        z_prev, h_prev = hist
        w1_init = _prefer_challenger(
            res1,
            w1_init,
            _hist_candidate(z, z_prev, h_prev, TRBDF2_GAMMA * h),
            h_prev > 0.0,
        )
    w1, ok1, it1 = newton(res1, w1_init)
    f1 = fl.rhs(ctx, w1, rho, filter)

    # BDF2 stage: w = az*z + aw*w1 + d*h*f(w).  Candidate predictors,
    # pick the smallest stage residual (one extra rhs eval each): f-based
    # for curved transients, linear-in-t extrapolation of the TR stage or
    # of the previous accepted step for the stiff creep along the slow
    # manifold (see the same choice in sdirk4_step)
    base = TRBDF2_AZ * z + TRBDF2_AW * w1

    def res2(ww):
        return ww - base - dh * fl.rhs(ctx, ww, rho, filter)

    # NOTE: the cross-step candidate is deliberately NOT offered here —
    # stage 2 already has the intra-step extrapolation cand_x, and during
    # the slow-manifold creep the two are near-identical lines, so the
    # residual argmin between them degenerates to an ulp coin-flip that
    # varies with vectorization width (vmap batch) and breaks the
    # flat-engine == host-driver trajectory identity.  Stage 1 (above) is
    # where no intra-step extrapolation exists and the cross-step
    # predictor carries all of its measured win.
    cands2 = [base + dh * f1, z + (1.0 / TRBDF2_GAMMA) * (w1 - z)]
    w_init = _pick_predictor(res2, cands2)
    w, ok2, it2 = newton(res2, w_init)
    fw = fl.rhs(ctx, w, rho, filter)

    # embedded 3rd-order error estimate, filtered through M^{-1} so the
    # stiff components don't dominate (Hosea-Shampine)
    est = (h / 3.0) * (TRBDF2_E1 * fz + TRBDF2_E2 * f1 + TRBDF2_E3 * fw)
    est = plu_solve(fact, est)

    ok = jnp.logical_and(ok1, ok2)
    return w, ok, it1 + it2, est


def sdirk4_step(ctx, z, h, rho, filter, rtol, atol, hist=None):
    """One SDIRK4 step from ``z`` (Hairer & Wanner II Table 6.5,
    gamma=1/4): five implicit stages, all with implicit weight ``h/4``,
    so ONE frozen factorization ``M = I - h/4 J(z)`` serves every stage's
    simplified-Newton iteration.  Stiffly accurate (the solution is the
    last stage), L-stable, order 4 with an embedded order-3 error
    estimate stiffly filtered through ``M^{-1}``.  ``hist = (z_prev,
    h_prev)`` is the previous ACCEPTED point (:func:`_hist_candidate`).
    Returns ``(w, ok, num_newton, est)`` like :func:`trbdf2_step`."""
    fz = fl.rhs(ctx, z, rho, filter)
    J = fl.rhs_jac(ctx, z, rho, filter)
    n_all = z.shape[0]
    dh = SDIRK4_GAMMA * h
    M = jnp.eye(n_all, dtype=z.dtype) - dh * J
    fact = plu_factor(M)

    newton = _make_stage_newton(ctx, fact, dh, rho, filter, rtol, atol)

    fs = []
    c_nodes = (0.25, 0.75, 0.55, 0.5, 1.0)  # row sums of SDIRK4_A
    y_prev = None
    f_pred = fz
    ok = jnp.ones((), bool)
    iters = jnp.zeros((), jnp.int32)
    for i in range(5):
        base = z
        for j in range(i):
            base = base + (h * SDIRK4_A[i][j]) * fs[j]

        def res_fn(w, base=base):
            return w - base - dh * fl.rhs(ctx, w, rho, filter)

        # candidate stage predictors, pick the smallest stage residual
        # (one extra rhs eval each): the f-based one wins in curved
        # transients; the linear-in-t extrapolations — of the previous
        # stage within this step, and of the previous ACCEPTED step
        # (cross-step, BDF-style) — win in the stiff creep along the slow
        # manifold where the trajectory is nearly straight and the
        # f-based guess diverges the frozen Newton (measured:
        # extrapolation-only cut a grinding perturbed HS71 lane from 2149
        # to 1281 steps but blew the nominal solve from 194 to 1405; the
        # residual-based choice keeps both).  The cross-step candidate is
        # the only extrapolation available at stage 1, exactly where the
        # creep grind used to start each step with a diverging f-guess.
        w_init = base + dh * f_pred
        if i > 0:
            w_init = _pick_predictor(
                res_fn,
                [w_init, z + (c_nodes[i] / c_nodes[i - 1]) * (y_prev - z)],
            )
        elif hist is not None:
            # cross-step candidate at stage 1 ONLY (later stages have the
            # intra-step extrapolation), and only on a DECISIVE residual
            # margin — see _prefer_challenger for why near-equal ties must
            # keep the f-based incumbent
            z_prev, h_prev = hist
            w_init = _prefer_challenger(
                res_fn,
                w_init,
                _hist_candidate(z, z_prev, h_prev, c_nodes[i] * h),
                h_prev > 0.0,
            )
        y_i, ok_i, it_i = newton(res_fn, w_init)
        f_i = fl.rhs(ctx, y_i, rho, filter)
        fs.append(f_i)
        y_prev = y_i
        f_pred = f_i
        ok = jnp.logical_and(ok, ok_i)
        iters = iters + it_i
    w = y_i  # stiffly accurate: b = last row of A

    est = h * sum(e * f for e, f in zip(SDIRK4_E, fs))
    est = plu_solve(fact, est)
    return w, ok, iters, est


class SegmentResult(NamedTuple):
    t_prev: Any
    z_prev: Any
    t: Any
    z: Any
    h: Any
    crossed: Any  # bool vector over events (crossing within last step)
    status: Any  # 0 = event, 1 = reached t_end, 2 = step failure/underflow
    num_steps: Any
    num_newton: Any


def make_segment_runner(
    cfg: ev.EventCfg,
    method: IntegrationMethod = IntegrationMethod.TRBDF2,
    rtol=1e-6,
    atol=1e-9,
    max_steps=300_000,
):
    """Build the jitted segment integrator for a fixed event configuration."""
    ctx = cfg.ctx

    def euler_step_with_error(z, h, rho, filter, hist=None):
        w_full, ok1, n1 = implicit_euler_step(ctx, z, h, rho, filter, rtol, atol)
        w_half, ok2, n2 = implicit_euler_step(ctx, z, 0.5 * h, rho, filter, rtol, atol)
        w_two, ok3, n3 = implicit_euler_step(ctx, w_half, 0.5 * h, rho, filter, rtol, atol)

        err_ratio = _scaled_norm(w_two - w_full, w_two, rtol, atol)

        ok = jnp.logical_and(ok1, jnp.logical_and(ok2, ok3))
        accept = jnp.logical_and(ok, err_ratio <= 1.0)

        # Richardson extrapolation of the step-doubled solution: locally
        # second order, with the first-order difference as error estimate
        w_acc = 2.0 * w_two - w_full

        factor = jnp.where(err_ratio > 0.0, 0.9 * err_ratio**-0.5, 5.0)
        factor = jnp.clip(factor, 0.2, 5.0)
        factor = jnp.where(ok, factor, 0.5)

        return w_acc, accept, factor, n1 + n2 + n3

    def trbdf2_step_with_error(z, h, rho, filter, hist=None):
        w, ok, iters, est = trbdf2_step(ctx, z, h, rho, filter, rtol, atol, hist)

        err_ratio = _scaled_norm(est, w, rtol, atol)
        accept = jnp.logical_and(ok, err_ratio <= 1.0)

        # 3rd-order estimate of an order-2 method: err ~ h^3.  Growth cap
        # 10 (vs 5 for the Euler path): the embedded estimate is reliable
        # enough to ramp aggressively out of the conservative post-event
        # restart, and rejections cost only one factorization here.
        factor = jnp.where(err_ratio > 0.0, 0.9 * err_ratio ** (-1.0 / 3.0), 10.0)
        factor = jnp.clip(factor, 0.2, 10.0)
        factor = jnp.where(ok, factor, 0.5)

        return w, accept, factor, iters

    def sdirk4_step_with_error(z, h, rho, filter, hist=None):
        w, ok, iters, est = sdirk4_step(ctx, z, h, rho, filter, rtol, atol, hist)

        err_ratio = _scaled_norm(est, w, rtol, atol)
        accept = jnp.logical_and(ok, err_ratio <= 1.0)

        # order-3 embedded estimate of an order-4 method: err ~ h^4
        factor = jnp.where(err_ratio > 0.0, 0.9 * err_ratio ** (-1.0 / 4.0), 10.0)
        factor = jnp.clip(factor, 0.2, 10.0)
        factor = jnp.where(ok, factor, 0.5)

        return w, accept, factor, iters

    step_with_error = {
        IntegrationMethod.TRBDF2: trbdf2_step_with_error,
        IntegrationMethod.SDIRK4: sdirk4_step_with_error,
        IntegrationMethod.ImplicitEuler: euler_step_with_error,
    }[method]

    def run(t0, z0, h0, rho, filter, grad_dirs, t_end):
        dirs = ev.event_directions(cfg, filter, grad_dirs)
        vals0 = ev.event_values(cfg, z0, rho, filter, grad_dirs)

        init = dict(
            t_prev=t0,
            z_prev=z0,
            t=t0,
            z=z0,
            h=h0,
            # size of the last ACCEPTED step (0 = no in-segment history);
            # stored directly rather than recomputed as t - t_prev so the
            # flat engine (which stores it the same way) stays bitwise
            # identical — the subtraction rounds through accumulated t
            h_last=jnp.zeros_like(t0),
            vals=vals0,
            crossed=jnp.zeros_like(vals0, dtype=bool),
            status=jnp.zeros_like(t0).astype(jnp.int32) - 1,  # -1 = running
            steps=jnp.zeros((), jnp.int32),
            newtons=jnp.zeros((), jnp.int32),
        )

        def cond(c):
            return c["status"] == -1

        def body(c):
            h = jnp.minimum(c["h"], t_end - c["t"])
            # cross-step predictor history: the previous accepted point
            # (h_last == 0 at segment start marks no-history)
            hist = (c["z_prev"], c["h_last"])
            w, accept, factor, n_newton = step_with_error(
                c["z"], h, rho, filter, hist
            )

            new_vals = ev.event_values(cfg, w, rho, filter, grad_dirs)
            crossed = ev.crossings(c["vals"], new_vals, dirs)
            any_crossed = jnp.any(crossed)

            t_new = c["t"] + h
            h_new = jnp.maximum(c["h"] * factor, 1e-14)

            # status transitions
            status = jnp.where(
                jnp.logical_and(accept, any_crossed),
                0,
                jnp.where(
                    jnp.logical_and(accept, t_new >= t_end),
                    1,
                    jnp.where(
                        jnp.logical_or(
                            # underflow test on the CONTROLLER step, not the
                            # t_end-clamped one: h == t_end - t tiny is a
                            # normal final step, not a breakdown.  Threshold
                            # ~16*eps*t (scipy-style): below that t+h == t.
                            c["steps"] >= max_steps,
                            c["h"] <= 3.6e-15 * jnp.maximum(1.0, c["t"]),
                        ),
                        2,
                        -1,
                    ),
                ),
            ).astype(jnp.int32)

            return dict(
                t_prev=jnp.where(accept, c["t"], c["t_prev"]),
                z_prev=jnp.where(accept, c["z"], c["z_prev"]),
                t=jnp.where(accept, t_new, c["t"]),
                z=jnp.where(accept, w, c["z"]),
                h=h_new,
                h_last=jnp.where(accept, h, c["h_last"]),
                vals=jnp.where(accept, new_vals, c["vals"]),
                crossed=jnp.where(accept, crossed, c["crossed"]),
                status=status,
                steps=c["steps"] + 1,
                newtons=c["newtons"] + n_newton,
            )

        out = jax.lax.while_loop(cond, body, init)
        return SegmentResult(
            t_prev=out["t_prev"],
            z_prev=out["z_prev"],
            t=out["t"],
            z=out["z"],
            h=out["h"],
            crossed=out["crossed"],
            status=out["status"],
            num_steps=out["steps"],
            num_newton=out["newtons"],
        )

    if method == IntegrationMethod.TRBDF2:

        def single(z, h, rho, filter):
            w, ok, _, _ = trbdf2_step(ctx, z, h, rho, filter, rtol, atol)
            return w, ok

    elif method == IntegrationMethod.SDIRK4:

        def single(z, h, rho, filter):
            w, ok, _, _ = sdirk4_step(ctx, z, h, rho, filter, rtol, atol)
            return w, ok

    else:

        def single(z, h, rho, filter):
            w, ok, _ = implicit_euler_step(ctx, z, h, rho, filter, rtol, atol)
            return w, ok

    return jit(run), jit(single)


def bisect_event(
    cfg,
    step_fn,
    run_vals,
    t_prev,
    z_prev,
    t_cur,
    rho,
    filter,
    grad_dirs,
    max_bisect=50,
    z_end=None,
):
    """Host-driven bisection: shrink the event bracket [t_prev, t_cur] by
    taking single implicit-Euler steps from ``z_prev``; returns the refined
    (t, z, crossed) at the post-crossing side.

    ``z_end`` is the segment integrator's own ACCEPTED state at ``t_cur``.
    When the bisection never re-finds the crossing (the single-step
    re-integration rounds differently than the adaptive path), it falls
    back to ``z_end`` rather than jumping the whole remaining bracket with
    one implicit-Euler step — near convergence the bracket can span ~1e6
    model-time units, the Newton for that jump diverges, and (before this
    guard) its garbage state, clipped into the box, silently replaced an
    essentially-converged iterate with duals ~1e45.

    Probe validation (``BISECT_BLOWUP``): a probe step whose Newton
    CONVERGES can still land on a spurious root — a single uncontrolled
    step across a long late-homotopy bracket (~1e7 model-time units at
    rho=1e7) has multiple implicit-equation roots, and an off-trajectory
    root passes ``ok`` while carrying a flow residuum ~1e9 (measured: a
    perturbed HS71 start whose post-event "refined" state had residuum
    9.2e8 vs 1.5e-1 at the bracket entry, poisoning every later segment).
    Any probe whose residuum exceeds ``BISECT_BLOWUP x`` the bracket
    entry's is treated exactly like a failed probe: stop bisecting and
    fall back to the integrator's own error-controlled ``z_end``.  The
    same guard runs in the device/flat engines (decision-identical)."""
    import numpy as np

    dirs = ev.event_directions(cfg, filter, grad_dirs)
    vals_prev = run_vals(z_prev)
    # the conv event slot IS residuum - opt_tol: probe residuums are free
    res_entry = float(vals_prev[3 * cfg.ctx.n]) + cfg.opt_tol

    t_lo, z_lo = float(t_prev), z_prev
    t_hi = float(t_cur)
    z_hi = None  # state at t_hi computed lazily

    for _ in range(max_bisect):
        if t_hi - t_lo <= BISECT_RTOL * max(1.0, abs(t_hi)):
            break
        t_mid = 0.5 * (t_lo + t_hi)
        h = t_mid - t_lo
        z_mid, ok = step_fn(z_lo, h, rho, filter)
        if not bool(ok):
            break
        vals_mid = run_vals(z_mid)
        res_mid = float(vals_mid[3 * cfg.ctx.n]) + cfg.opt_tol
        if not np.isfinite(res_mid) or res_mid > BISECT_BLOWUP * res_entry:
            break
        crossed = ev.crossings(vals_prev, vals_mid, dirs)
        if bool(jnp.any(crossed)):
            t_hi = t_mid
            z_hi = z_mid
        else:
            t_lo, z_lo = t_mid, z_mid
            vals_prev = vals_mid

    if z_hi is None:
        if z_end is not None:
            z_hi = z_end
        else:
            # legacy path (no segment endpoint provided): one step to the
            # end of the bracket, rejected if its Newton fails
            z_hi, ok = step_fn(z_lo, t_hi - t_lo, rho, filter)
            if not bool(ok) or not bool(jnp.all(jnp.isfinite(z_hi))):
                z_hi = z_lo

    vals_hi = run_vals(z_hi)
    crossed = ev.crossings(vals_prev, vals_hi, dirs)
    return t_hi, z_hi, crossed
