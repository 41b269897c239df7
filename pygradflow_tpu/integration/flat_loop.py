"""Flat (single-level) device-resident continuous-flow engine for
batched solves and time-limited chunked execution.

``device_loop.py`` nests loops: outer segments -> inner adaptive stepping
-> event bisection -> stage Newton, with ``lax.cond`` dispatching between
them.  Under ``vmap`` that structure is catastrophic for heterogeneous
batches: a vmapped ``while_loop`` iterates until EVERY lane's condition
fails, so each nesting level synchronizes lanes to the slowest one (the
wall-clock becomes a sum of per-segment maxima instead of the maximum of
per-lane sums), and a vmapped ``lax.cond`` lowers to ``select`` —
executing BOTH branches, including the full bisection loop, on every
outer iteration for every lane.  Round-2 measurement: 0.08x the
sequential reference at B=64 (``artifacts/r2_integration_batch.json``).

This engine flattens the whole solve into ONE ``lax.while_loop`` whose
body performs exactly one uniform work unit per iteration — one adaptive
step attempt, or one bisection step — with segment transitions and event
application as masked updates.  Lanes advance through their own phases
independently; the batch's wall-clock is the maximum of per-lane total
work, the true critical path.  Execution is chunked (``iterations per
dispatch``), so callers can enforce ``params.time_limit`` between
dispatches and harvest/compact converged lanes.

Semantics mirror ``device_loop.py`` decision for decision (same method
steps, same bisection bracket updates, same event priority and boundary
checks); the only deviation: under ``IntegrationMethod.ImplicitEuler``
bisection probes use the step-doubled/extrapolated step rather than the
single plain step, since the flat body shares one step kernel.
Reference behavior: ``/root/reference/pygradflow/integration/
integration_solver.py:143-225,264-356``.
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..iterate import evaluate_iterate, is_feasible, locally_infeasible
from ..params import IntegrationMethod
from ..status import RUNNING, SolverStatus
from . import events as ev
from . import flow as fl
from .device_loop import MAX_BISECT, _create_filter
from .integrator import (
    BISECT_BLOWUP,
    BISECT_RTOL,
    _scaled_norm,
    implicit_euler_step,
    sdirk4_step,
    trbdf2_step,
)

# modes of the per-lane state machine
STEP = 0
BISECT = 1
DONE = 2


class FlatLoopResult(NamedTuple):
    z: Any
    status: Any
    iterations: Any
    rho: Any
    num_steps: Any
    num_newtons: Any
    path_dist: Any


def make_flat_loop(cfg, fns, lb, ub, params):
    """Build ``(init, chunk, collect)`` for the flat engine.

    - ``init(x, y) -> state``: per-lane state dict (vmap for batches);
    - ``chunk(state, budget) -> state``: advance up to ``budget`` work
      units (static int), freezing lanes whose status leaves RUNNING;
    - ``collect(state) -> FlatLoopResult``.
    """
    ctx = cfg.ctx
    n = ctx.n
    iteration_limit = params.iteration_limit or params.iteration_limit_default
    opt_tol = params.opt_tol
    max_steps = params.integration_max_steps
    rtol, atol = params.integration_rtol, params.integration_atol
    method = params.integration_method

    if method == IntegrationMethod.SDIRK4:
        step_full = lambda z, h, rho, filt, hist: sdirk4_step(  # noqa: E731
            ctx, z, h, rho, filt, rtol, atol, hist
        )
        err_exponent = -1.0 / 4.0
    elif method == IntegrationMethod.TRBDF2:
        step_full = lambda z, h, rho, filt, hist: trbdf2_step(  # noqa: E731
            ctx, z, h, rho, filt, rtol, atol, hist
        )
        err_exponent = -1.0 / 3.0
    else:

        def step_full(z, h, rho, filt, hist=None):
            """Step-doubled implicit Euler in the (w, ok, iters, est) API:
            est derived from the Richardson difference."""
            w_full, ok1, n1 = implicit_euler_step(ctx, z, h, rho, filt, rtol, atol)
            w_half, ok2, n2 = implicit_euler_step(
                ctx, z, 0.5 * h, rho, filt, rtol, atol
            )
            w_two, ok3, n3 = implicit_euler_step(
                ctx, w_half, 0.5 * h, rho, filt, rtol, atol
            )
            ok = jnp.logical_and(ok1, jnp.logical_and(ok2, ok3))
            w_acc = 2.0 * w_two - w_full
            return w_acc, ok, n1 + n2 + n3, w_two - w_full

        err_exponent = -1.0 / 2.0

    # ------------------------------------------------------------------

    def _transition(c):
        """Segment boundary: iteration-limit check, termination checks at
        the (new) point, and next-segment initialization.  Mirrors the
        top of ``device_loop.body`` + segment setup in ``advance``.
        Applied masked — ``c`` must already hold the post-event state."""
        z, filt, rho = c["z"], c["filter"], c["rho"]
        status = c["status"]

        status = jnp.where(
            jnp.logical_and(c["iteration"] >= iteration_limit, status == RUNNING),
            int(SolverStatus.IterationLimit),
            status,
        ).astype(jnp.int32)

        res = fl.residuum(ctx, z, filt)
        it = evaluate_iterate(fns, *fl.split(ctx, z))
        infeas = locally_infeasible(
            it, lb, ub, params.active_tol, opt_tol, params.local_infeas_tol
        )
        unb = jnp.logical_and(
            it.obj <= params.obj_lower_limit, is_feasible(it, lb, ub, opt_tol)
        )
        status = jnp.where(
            jnp.logical_and(status == RUNNING, res <= opt_tol),
            int(SolverStatus.Optimal),
            status,
        )
        status = jnp.where(
            jnp.logical_and(status == RUNNING, infeas),
            int(SolverStatus.LocallyInfeasible),
            status,
        )
        status = jnp.where(
            jnp.logical_and(status == RUNNING, unb),
            int(SolverStatus.Unbounded),
            status,
        ).astype(jnp.int32)

        grad_dirs = ev.grad_event_dirs(ctx, z, filt, lb, ub)
        vals = ev.event_values(cfg, z, rho, filt, grad_dirs)
        dirs = ev.event_directions(cfg, filt, grad_dirs)

        return dict(
            c,
            status=status,
            mode=jnp.where(status == RUNNING, STEP, DONE).astype(jnp.int32),
            grad_dirs=grad_dirs,
            vals=vals,
            dirs=dirs,
            seg_t_end=c["t"] + 1e10,
            seg_z0=z,
            seg_steps=jnp.zeros((), jnp.int32),
            # the nested engine starts every run_segment call with no
            # predictor history (t_prev == t0); mirror that here so the
            # flat engine's step sequence matches decision for decision
            hist_h=jnp.zeros_like(c["hist_h"]),
        )

    def _masked(c_new, c_old, mask):
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(mask, a, b), c_new, c_old
        )

    # ------------------------------------------------------------------

    def init(x, y):
        z = jnp.concatenate([x, y])
        dt = z.dtype
        rho0 = jnp.asarray(params.rho, dt)
        filt = _create_filter(ctx, lb, ub, z, rho0)
        zero_i = jnp.zeros((), jnp.int32)
        n_ev = ev.num_events(n)
        c = dict(
            z=z,
            t=jnp.zeros((), dt),
            h=jnp.asarray(1e-4, dt),
            rho=rho0,
            filter=filt,
            status=jnp.asarray(RUNNING, jnp.int32),
            mode=jnp.asarray(STEP, jnp.int32),
            iteration=zero_i,
            steps=zero_i,
            newtons=zero_i,
            seg_steps=zero_i,
            path_dist=jnp.zeros((), dt),
            grad_dirs=jnp.zeros((n,), dt),
            vals=jnp.zeros((n_ev,), dt),
            dirs=jnp.zeros((n_ev,), dt),
            seg_t_end=jnp.zeros((), dt),
            seg_z0=z,
            bis_t_lo=jnp.zeros((), dt),
            bis_z_lo=z,
            bis_vals_lo=jnp.zeros((n_ev,), dt),
            bis_res0=jnp.zeros((), dt),
            bis_t_hi=jnp.zeros((), dt),
            bis_z_hi=z,
            bis_vals_hi=jnp.zeros((n_ev,), dt),
            bis_has_hi=jnp.zeros((), bool),
            bis_stop=jnp.zeros((), bool),
            bis_i=zero_i,
            z_end=z,
            vals_end=jnp.zeros((n_ev,), dt),
            # cross-step predictor history (h <= 0 marks no-history)
            hist_z=z,
            hist_h=jnp.zeros((), dt),
            # total work units (step attempts + bisection probes) — the
            # lane's share of the lockstep critical path; max over lanes
            # x time per unit approximates the batched wall
            units=zero_i,
        )
        return _transition(c)

    # ------------------------------------------------------------------

    def body(c):
        rho, filt = c["rho"], c["filter"]
        is_step = c["mode"] == STEP
        is_bis = c["mode"] == BISECT

        # bisection-done test on the CURRENT bracket (device_loop checks
        # its cond before each bisection step)
        gap = c["bis_t_hi"] - c["bis_t_lo"]
        bis_done = jnp.logical_and(
            is_bis,
            jnp.logical_not(
                jnp.logical_and(
                    c["bis_i"] < MAX_BISECT,
                    jnp.logical_and(
                        jnp.logical_not(c["bis_stop"]),
                        gap > BISECT_RTOL * jnp.maximum(1.0, jnp.abs(c["bis_t_hi"])),
                    ),
                )
            ),
        )
        do_bis = jnp.logical_and(is_bis, jnp.logical_not(bis_done))

        # ---- unified work unit: one implicit step from selected inputs
        t_mid = 0.5 * (c["bis_t_lo"] + c["bis_t_hi"])
        z_in = jnp.where(do_bis, c["bis_z_lo"], c["z"])
        h_step = jnp.minimum(c["h"], c["seg_t_end"] - c["t"])
        h_in = jnp.where(do_bis, t_mid - c["bis_t_lo"], h_step)
        # frozen lanes / zero brackets: keep the kernel numerically alive
        h_in = jnp.maximum(h_in, 1e-300)

        # the step kernel's cross-step history only applies to STEP-mode
        # lanes (bisection probes re-step from the bracket start, not
        # from the accepted trajectory point the history is relative to)
        hist = (c["hist_z"], jnp.where(do_bis, 0.0, c["hist_h"]))
        w, ok, n_newton, est = step_full(z_in, h_in, rho, filt, hist)
        new_vals = ev.event_values(cfg, w, rho, filt, c["grad_dirs"])

        # ---- STEP-mode update (mirrors make_segment_runner.body)
        err_ratio = _scaled_norm(est, w, rtol, atol)
        accept = jnp.logical_and(ok, err_ratio <= 1.0)
        factor = jnp.where(err_ratio > 0.0, 0.9 * err_ratio**err_exponent, 10.0)
        factor = jnp.clip(factor, 0.2, 10.0)
        factor = jnp.where(ok, factor, 0.5)

        crossed_step = ev.crossings(c["vals"], new_vals, c["dirs"])
        any_crossed = jnp.any(crossed_step)
        t_new = c["t"] + h_in

        ev_any = jnp.logical_and(accept, any_crossed)
        # pure-convergence crossing: bisection refines the event TIME, but
        # any point past a convergence crossing already has residuum
        # <= opt_tol — the accepted endpoint is an Optimal certificate, so
        # ~BISECT-probe units (one implicit step each) buy nothing.  Only
        # when conv is the sole crossed event (an earlier pin/release in
        # the same step must still be located and applied first).
        conv_only = jnp.logical_and(
            crossed_step[3 * n], jnp.sum(crossed_step) == 1
        )
        ev_direct = jnp.logical_and(ev_any, conv_only)
        ev_enter = jnp.logical_and(ev_any, jnp.logical_not(conv_only))
        tend_hit = jnp.logical_and(
            accept,
            jnp.logical_and(jnp.logical_not(any_crossed), t_new >= c["seg_t_end"]),
        )
        brk = jnp.logical_and(
            jnp.logical_not(jnp.logical_or(ev_any, tend_hit)),
            jnp.logical_or(
                c["seg_steps"] >= max_steps,
                c["h"] <= 3.6e-15 * jnp.maximum(1.0, c["t"]),
            ),
        )
        normal = jnp.logical_and(
            accept, jnp.logical_not(jnp.logical_or(ev_any, tend_hit))
        )

        h_new = jnp.maximum(c["h"] * factor, 1e-14)

        cs = dict(c)
        cs["steps"] = c["steps"] + 1
        cs["seg_steps"] = c["seg_steps"] + 1
        cs["newtons"] = c["newtons"] + n_newton
        cs["h"] = h_new
        adv = jnp.logical_or(normal, tend_hit)
        cs["t"] = jnp.where(adv, t_new, c["t"])
        cs["z"] = jnp.where(adv, w, c["z"])
        cs["vals"] = jnp.where(adv, new_vals, c["vals"])
        cs["hist_z"] = jnp.where(adv, c["z"], c["hist_z"])
        cs["hist_h"] = jnp.where(adv, h_in, c["hist_h"])
        # entering bisection: bracket [t, t_new] from the accepted state
        cs["bis_t_lo"] = jnp.where(ev_enter, c["t"], c["bis_t_lo"])
        cs["bis_z_lo"] = jnp.where(ev_enter, c["z"], c["bis_z_lo"])
        cs["bis_vals_lo"] = jnp.where(ev_enter, c["vals"], c["bis_vals_lo"])
        # bracket-entry residuum: the spurious-root probe guard's scale
        # (see integrator.bisect_event / BISECT_BLOWUP).  The conv event
        # slot IS residuum - opt_tol, so this costs nothing extra.
        cs["bis_res0"] = jnp.where(
            ev_enter, c["vals"][3 * n] + opt_tol, c["bis_res0"]
        )
        cs["bis_t_hi"] = jnp.where(ev_enter, t_new, c["bis_t_hi"])
        cs["bis_has_hi"] = jnp.where(ev_enter, False, c["bis_has_hi"])
        cs["bis_stop"] = jnp.where(ev_enter, False, c["bis_stop"])
        cs["bis_i"] = jnp.where(ev_enter, 0, c["bis_i"])
        cs["z_end"] = jnp.where(ev_enter, w, c["z_end"])
        cs["vals_end"] = jnp.where(ev_enter, new_vals, c["vals_end"])
        cs["mode"] = jnp.where(ev_enter, BISECT, c["mode"]).astype(jnp.int32)
        # breakdown: stop with IterationLimit at the segment's current
        # accepted state (cs["z"] is already w when accepted, else c["z"])
        cs["status"] = jnp.where(
            brk, int(SolverStatus.IterationLimit), cs["status"]
        ).astype(jnp.int32)
        cs["mode"] = jnp.where(brk, DONE, cs["mode"]).astype(jnp.int32)
        cs["iteration"] = c["iteration"] + brk.astype(jnp.int32)
        # segment end via t_end: path, counters, then transition below
        cs["path_dist"] = jnp.where(
            tend_hit,
            c["path_dist"] + jnp.linalg.norm(w - c["seg_z0"]),
            c["path_dist"],
        )
        cs["h"] = jnp.where(tend_hit, jnp.maximum(h_new, 1e-10), cs["h"])
        cs["iteration"] = cs["iteration"] + tend_hit.astype(jnp.int32)
        # direct convergence (conv-only crossing, no bisection): apply the
        # event at the accepted endpoint, mirroring the ca-family conv
        # path (box clip + path_dist + iteration count + Optimal)
        x_w, y_w = fl.split(ctx, w)
        z_conv = jnp.concatenate([jnp.clip(x_w, lb, ub), y_w])
        cs["t"] = jnp.where(ev_direct, t_new, cs["t"])
        cs["z"] = jnp.where(ev_direct, z_conv, cs["z"])
        cs["path_dist"] = jnp.where(
            ev_direct,
            c["path_dist"] + jnp.linalg.norm(z_conv - c["seg_z0"]),
            cs["path_dist"],
        )
        cs["iteration"] = cs["iteration"] + ev_direct.astype(jnp.int32)
        cs["status"] = jnp.where(
            ev_direct, int(SolverStatus.Optimal), cs["status"]
        ).astype(jnp.int32)
        cs["mode"] = jnp.where(ev_direct, DONE, cs["mode"]).astype(jnp.int32)

        # ---- BISECT-step update (mirrors device_loop.bisect.body, incl.
        # the spurious-root probe guard: a converged probe whose flow
        # residuum blew past BISECT_BLOWUP x the bracket entry's is a
        # wrong Newton root — treated exactly like a failed probe).  The
        # probe's residuum comes free from its conv event slot.
        res_w = new_vals[3 * n] + opt_tol
        ok_probe = jnp.logical_and(
            ok,
            jnp.logical_and(
                jnp.isfinite(res_w), res_w <= BISECT_BLOWUP * c["bis_res0"]
            ),
        )
        crossed_mid = jnp.any(ev.crossings(c["bis_vals_lo"], new_vals, c["dirs"]))
        hi_branch = jnp.logical_and(ok_probe, crossed_mid)
        lo_branch = jnp.logical_and(ok_probe, jnp.logical_not(crossed_mid))
        cb = dict(c)
        cb["bis_t_lo"] = jnp.where(lo_branch, t_mid, c["bis_t_lo"])
        cb["bis_z_lo"] = jnp.where(lo_branch, w, c["bis_z_lo"])
        cb["bis_vals_lo"] = jnp.where(lo_branch, new_vals, c["bis_vals_lo"])
        cb["bis_t_hi"] = jnp.where(hi_branch, t_mid, c["bis_t_hi"])
        cb["bis_z_hi"] = jnp.where(hi_branch, w, c["bis_z_hi"])
        cb["bis_vals_hi"] = jnp.where(hi_branch, new_vals, c["bis_vals_hi"])
        cb["bis_has_hi"] = jnp.logical_or(c["bis_has_hi"], hi_branch)
        cb["bis_stop"] = jnp.logical_not(ok_probe)
        cb["bis_i"] = c["bis_i"] + 1

        # ---- event application (bisection finished)
        z_hi = jnp.where(c["bis_has_hi"], c["bis_z_hi"], c["z_end"])
        vals_hi = jnp.where(c["bis_has_hi"], c["bis_vals_hi"], c["vals_end"])
        crossed_ev = ev.crossings(c["bis_vals_lo"], vals_hi, c["dirs"])
        t_ev = c["bis_t_hi"]
        x_ev, y_ev = fl.split(ctx, z_hi)
        x_ev = jnp.clip(x_ev, lb, ub)
        z_ev = jnp.concatenate([x_ev, y_ev])

        ca = dict(c)
        ca["path_dist"] = c["path_dist"] + jnp.linalg.norm(z_ev - c["seg_z0"])
        ca["t"] = t_ev
        ca["z"] = z_ev
        ca["h"] = jnp.full_like(c["h"], 1e-4)
        ca["hist_h"] = jnp.zeros_like(c["hist_h"])  # flow changed at the event
        ca["iteration"] = c["iteration"] + 1

        it_ev = evaluate_iterate(fns, x_ev, y_ev)
        feas = is_feasible(it_ev, lb, ub, opt_tol)
        crossed_ev = crossed_ev.at[3 * n + 1].set(
            jnp.logical_and(crossed_ev[3 * n + 1], feas)
        )
        has = jnp.any(crossed_ev)
        idx = jnp.argmax(crossed_ev)
        is_pin = jnp.logical_and(has, idx < 2 * n)
        is_rel = jnp.logical_and(has, jnp.logical_and(2 * n <= idx, idx < 3 * n))
        is_conv = jnp.logical_and(has, idx == 3 * n)
        is_unb = jnp.logical_and(has, idx == 3 * n + 1)
        is_pen = jnp.logical_and(has, idx == 3 * n + 2)

        j_pin = jnp.where(is_pin, idx % n, 0)
        j_rel = jnp.where(is_rel, idx - 2 * n, 0)
        filt_n = jnp.where(is_pin, filt.at[j_pin].set(False), filt)
        filt_n = jnp.where(is_rel, filt_n.at[j_rel].set(True), filt_n)
        ca["status"] = jnp.where(
            is_conv,
            int(SolverStatus.Optimal),
            jnp.where(is_unb, int(SolverStatus.Unbounded), c["status"]),
        ).astype(jnp.int32)
        rho_n = jnp.where(is_pen, 10.0 * rho, rho)
        filt_n = jnp.where(is_pen, _create_filter(ctx, lb, ub, z_ev, rho_n), filt_n)
        ca["rho"] = rho_n
        ca["filter"] = filt_n

        # ---- merge the three masked update families
        out = _masked(cs, c, is_step)
        out = _masked(cb, out, do_bis)
        out = _masked(ca, out, bis_done)

        # segment transitions re-run boundary checks + segment init
        trans = jnp.logical_or(jnp.logical_and(is_step, tend_hit), bis_done)
        out = _masked(_transition(out), out, trans)
        # terminal statuses reached inside the event application
        out["mode"] = jnp.where(out["status"] == RUNNING, out["mode"], DONE).astype(
            jnp.int32
        )
        out["units"] = c["units"] + 1
        return out

    # ------------------------------------------------------------------

    def chunk(state, budget: int):
        def cond(carry):
            c, k = carry
            return jnp.logical_and(c["status"] == RUNNING, k < budget)

        def step(carry):
            c, k = carry
            return body(c), k + 1

        out, _ = jax.lax.while_loop(
            cond, step, (state, jnp.zeros((), jnp.int32))
        )
        return out

    def collect(state) -> FlatLoopResult:
        return FlatLoopResult(
            z=state["z"],
            status=state["status"],
            iterations=state["iteration"],
            rho=state["rho"],
            num_steps=state["steps"],
            num_newtons=state["newtons"],
            path_dist=state["path_dist"],
        )

    return init, chunk, collect
