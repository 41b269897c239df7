"""Fully device-resident integration loop — the whole continuous-homotopy
solve (segments, event bisection, filter/penalty switches, termination)
as ONE traced function, vmappable over instances.

The host driver (``integration_solver.py``) re-enters Python once per
segment and per bisection step, each a host-device round trip.  This
loop keeps everything on device: a single
``lax.while_loop`` carries (z, t, h, rho, filter, status, counters),
events are located by an in-loop bisection ``while_loop`` re-using the
jitted single-step kernel, and crossings are dispatched by masked
selects in the reference's priority order
(``/root/reference/pygradflow/integration/integration_solver.py:143-225``).

Used by :class:`BatchedIntegrationSolver` (vmap over the whole loop —
the reference's scipy-BDF engine has no batched counterpart) and
available for low-latency single-instance solves.

Deviations from the host driver (documented, by design):
- no ``collect_path`` (unbounded host buffers) and no live display;
- ``time_limit`` is enforced at chunk boundaries by the caller, not
  inside the loop;
- the degenerate-bound error of ``create_filter`` (both ``dx`` and
  ``ddx`` exactly zero at an active bound) cannot raise under jit; the
  variable is left free, matching the flow's forward behavior.
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..iterate import evaluate_iterate, is_feasible, locally_infeasible
from ..status import RUNNING, SolverStatus
from . import events as ev
from . import flow as fl
from .integrator import BISECT_BLOWUP, BISECT_RTOL

MAX_BISECT = 50


class DeviceLoopResult(NamedTuple):
    z: Any
    status: Any  # int32 SolverStatus value
    iterations: Any
    rho: Any
    num_steps: Any
    num_newtons: Any
    path_dist: Any


def _create_filter(ctx, lb, ub, z, rho):
    """Traced counterpart of ``IntegrationSolver.create_filter``
    (reference ``integration_solver.py:90-123``): free-variable mask from
    active bounds and flow signs with second-order tie-breaks."""
    x, _ = fl.split(ctx, z)
    at_lb = fl.isclose(x, lb)
    at_ub = fl.isclose(x, ub)

    dx = -fl.aug_lag_deriv_x(ctx, z, rho)
    dx_zero = fl.isclose(dx, 0.0)

    fixed = jnp.logical_or(
        jnp.logical_and(at_lb, dx < 0), jnp.logical_and(at_ub, dx > 0)
    )

    ddx = fl.rhs_deriv_x(ctx, z, rho)
    amb_lb = jnp.logical_and(at_lb, dx_zero)
    amb_ub = jnp.logical_and(at_ub, dx_zero)
    fixed = jnp.where(amb_lb, ddx < 0, fixed)
    fixed = jnp.where(amb_ub, ddx > 0, fixed)

    return jnp.logical_not(fixed)


def make_device_loop(cfg, fns, lb, ub, params, run_segment, step_fn):
    """Build ``run(x, y) -> DeviceLoopResult`` (traced end to end).

    ``run_segment``/``step_fn`` are the jitted segment/single-step kernels
    from :func:`integrator.make_segment_runner` (jit nests transparently
    under an outer trace)."""
    ctx = cfg.ctx
    n = ctx.n
    n_ev = ev.num_events(n)
    iteration_limit = params.iteration_limit or params.iteration_limit_default
    opt_tol = params.opt_tol

    def run_vals(z, rho, filter, grad_dirs):
        return ev.event_values(cfg, z, rho, filter, grad_dirs)

    def bisect(t_prev, z_prev, t_cur, z_end, rho, filter, grad_dirs):
        """Device bisection of the event bracket (mirrors
        ``integrator.bisect_event``).  ``z_end`` is the segment's own
        accepted state at ``t_cur`` — the fallback when bisection never
        re-finds the crossing (re-stepping the whole remaining bracket
        with one implicit-Euler jump diverges near convergence, where the
        bracket can span ~1e6 model-time units).  Probes whose flow
        residuum blows up past ``BISECT_BLOWUP x`` the bracket entry's are
        spurious Newton roots and stop the bisection exactly like a
        failed probe (see ``integrator.bisect_event``)."""
        dirs = ev.event_directions(cfg, filter, grad_dirs)

        def cond(c):
            gap = c["t_hi"] - c["t_lo"]
            return jnp.logical_and(
                c["i"] < MAX_BISECT,
                jnp.logical_and(
                    jnp.logical_not(c["stop"]),
                    gap > BISECT_RTOL * jnp.maximum(1.0, jnp.abs(c["t_hi"])),
                ),
            )

        def body(c):
            t_mid = 0.5 * (c["t_lo"] + c["t_hi"])
            h = t_mid - c["t_lo"]
            z_mid, ok = step_fn(c["z_lo"], h, rho, filter)
            vals_mid = run_vals(z_mid, rho, filter, grad_dirs)
            # probe residuum comes free from the conv event slot;
            # res_entry is the FIXED bracket-entry residuum (closure)
            res_mid = vals_mid[3 * n] + opt_tol
            ok = jnp.logical_and(
                ok,
                jnp.logical_and(
                    jnp.isfinite(res_mid), res_mid <= BISECT_BLOWUP * res_entry
                ),
            )
            crossed = jnp.any(ev.crossings(c["vals_lo"], vals_mid, dirs))

            hi_branch = jnp.logical_and(ok, crossed)
            lo_branch = jnp.logical_and(ok, jnp.logical_not(crossed))
            return dict(
                t_lo=jnp.where(lo_branch, t_mid, c["t_lo"]),
                z_lo=jnp.where(lo_branch, z_mid, c["z_lo"]),
                vals_lo=jnp.where(lo_branch, vals_mid, c["vals_lo"]),
                t_hi=jnp.where(hi_branch, t_mid, c["t_hi"]),
                z_hi=jnp.where(hi_branch, z_mid, c["z_hi"]),
                has_hi=jnp.logical_or(c["has_hi"], hi_branch),
                stop=jnp.logical_not(ok),
                i=c["i"] + 1,
            )

        vals0 = run_vals(z_prev, rho, filter, grad_dirs)
        res_entry = vals0[3 * n] + opt_tol  # conv slot = residuum - tol
        init = dict(
            t_lo=t_prev,
            z_lo=z_prev,
            vals_lo=vals0,
            t_hi=t_cur,
            z_hi=jnp.zeros_like(z_prev),
            has_hi=jnp.zeros((), bool),
            stop=jnp.zeros((), bool),
            i=jnp.zeros((), jnp.int32),
        )
        out = jax.lax.while_loop(cond, body, init)

        z_hi = jnp.where(out["has_hi"], out["z_hi"], z_end)
        vals_hi = run_vals(z_hi, rho, filter, grad_dirs)
        crossed = ev.crossings(out["vals_lo"], vals_hi, dirs)
        return out["t_hi"], z_hi, crossed

    def handle_event(t, z, h0, rho, filter, status, path_dist, seg):
        """Bisect to the crossing and dispatch it (priority = event index,
        reference ``integration_solver.py:143-225``).  A pure-convergence
        crossing (conv is the ONLY crossed event of the step) skips
        bisection: any point past the crossing has residuum <= opt_tol,
        so the segment's accepted endpoint is an Optimal certificate (the
        host driver and flat engine short-circuit identically)."""
        grad_dirs = ev.grad_event_dirs(ctx, z, filter, lb, ub)
        conv_only = jnp.logical_and(
            seg.crossed[3 * n], jnp.sum(seg.crossed) == 1
        )
        t_ev, z_ev, crossed = jax.lax.cond(
            conv_only,
            lambda _: (seg.t, seg.z, seg.crossed),
            lambda _: bisect(
                seg.t_prev, seg.z_prev, seg.t, seg.z, rho, filter, grad_dirs
            ),
            None,
        )
        path_dist = path_dist + jnp.linalg.norm(z_ev - z)

        # clip into the box (reference integration_solver.py:330)
        x_ev, y_ev = fl.split(ctx, z_ev)
        x_ev = jnp.clip(x_ev, lb, ub)
        z_ev = jnp.concatenate([x_ev, y_ev])

        # the unboundedness event only fires at a feasible point; when
        # infeasible the host driver skips it and scans on — masking the
        # slot reproduces that priority
        it = evaluate_iterate(fns, x_ev, y_ev)
        feas = is_feasible(it, lb, ub, opt_tol)
        crossed = crossed.at[3 * n + 1].set(
            jnp.logical_and(crossed[3 * n + 1], feas)
        )

        has = jnp.any(crossed)
        idx = jnp.argmax(crossed)  # first crossed slot = highest priority

        is_pin = jnp.logical_and(has, idx < 2 * n)
        is_rel = jnp.logical_and(has, jnp.logical_and(2 * n <= idx, idx < 3 * n))
        is_conv = jnp.logical_and(has, idx == 3 * n)
        is_unb = jnp.logical_and(has, idx == 3 * n + 1)
        is_pen = jnp.logical_and(has, idx == 3 * n + 2)

        j_pin = jnp.where(is_pin, idx % n, 0)
        j_rel = jnp.where(is_rel, idx - 2 * n, 0)
        filter_n = jnp.where(
            is_pin, filter.at[j_pin].set(False), filter
        )
        filter_n = jnp.where(is_rel, filter_n.at[j_rel].set(True), filter_n)

        status_n = jnp.where(
            is_conv,
            int(SolverStatus.Optimal),
            jnp.where(is_unb, int(SolverStatus.Unbounded), status),
        ).astype(jnp.int32)

        rho_n = jnp.where(is_pen, 10.0 * rho, rho)
        filter_n = jnp.where(
            is_pen, _create_filter(ctx, lb, ub, z_ev, rho_n), filter_n
        )

        # conservative restart after any event (dynamics changed)
        return t_ev, z_ev, jnp.full_like(h0, 1e-4), rho_n, filter_n, status_n, path_dist

    def body(c):
        z, t, h0, rho, filter = c["z"], c["t"], c["h0"], c["rho"], c["filter"]
        status, path_dist = c["status"], c["path_dist"]

        # termination checks at segment boundaries (host driver order)
        res = fl.residuum(ctx, z, filter)
        it = evaluate_iterate(fns, *fl.split(ctx, z))
        infeas = locally_infeasible(
            it, lb, ub, params.active_tol, opt_tol, params.local_infeas_tol
        )
        unb = jnp.logical_and(
            it.obj <= params.obj_lower_limit, is_feasible(it, lb, ub, opt_tol)
        )
        status = jnp.where(res <= opt_tol, int(SolverStatus.Optimal), status)
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

        def advance(args):
            z, t, h0, rho, filter, status, path_dist = args
            grad_dirs = ev.grad_event_dirs(ctx, z, filter, lb, ub)
            seg = run_segment(
                t, z, h0, rho, filter, grad_dirs, t + 1e10
            )

            # breakdown (status 2): stop with IterationLimit like the host
            brk = seg.status == 2

            def on_event(_):
                return handle_event(t, z, h0, rho, filter, status, path_dist, seg)

            def on_t_end(_):
                pd = path_dist + jnp.linalg.norm(seg.z - z)
                return (
                    seg.t,
                    seg.z,
                    jnp.maximum(seg.h, 1e-10),
                    rho,
                    filter,
                    status,
                    pd,
                )

            t_n, z_n, h_n, rho_n, filter_n, status_n, pd_n = jax.lax.cond(
                seg.status == 0, on_event, on_t_end, None
            )

            status_n = jnp.where(
                brk, int(SolverStatus.IterationLimit), status_n
            ).astype(jnp.int32)
            z_n = jnp.where(brk, seg.z, z_n)
            return (
                z_n, t_n, h_n, rho_n, filter_n, status_n, pd_n,
                seg.num_steps, seg.num_newton,
            )

        def hold(args):
            z, t, h0, rho, filter, status, path_dist = args
            zero = jnp.zeros((), jnp.int32)
            return (z, t, h0, rho, filter, status, path_dist, zero, zero)

        ran = status == RUNNING  # boundary checks passed: a segment runs
        (z, t, h0, rho, filter, status, path_dist, d_steps, d_newts) = jax.lax.cond(
            ran,
            advance,
            hold,
            (z, t, h0, rho, filter, status, path_dist),
        )

        # host driver increments per segment run, including the one that
        # sets a terminal status — but not when a boundary check stopped
        # the loop before integrating
        iteration = c["iteration"] + ran.astype(jnp.int32)
        status = jnp.where(
            jnp.logical_and(iteration >= iteration_limit, status == RUNNING),
            int(SolverStatus.IterationLimit),
            status,
        ).astype(jnp.int32)

        return dict(
            z=z, t=t, h0=h0, rho=rho, filter=filter, status=status,
            iteration=iteration, path_dist=path_dist,
            steps=c["steps"] + d_steps, newtons=c["newtons"] + d_newts,
        )

    def cond(c):
        return c["status"] == RUNNING

    def run(x, y):
        z = jnp.concatenate([x, y])
        rho0 = jnp.asarray(params.rho, z.dtype)
        init = dict(
            z=z,
            t=jnp.zeros((), z.dtype),
            h0=jnp.asarray(1e-4, z.dtype),
            rho=rho0,
            filter=_create_filter(ctx, lb, ub, z, rho0),
            status=jnp.asarray(RUNNING, jnp.int32),
            iteration=jnp.zeros((), jnp.int32),
            path_dist=jnp.zeros((), z.dtype),
            steps=jnp.zeros((), jnp.int32),
            newtons=jnp.zeros((), jnp.int32),
        )
        out = jax.lax.while_loop(cond, body, init)
        return DeviceLoopResult(
            z=out["z"],
            status=out["status"],
            iterations=out["iteration"],
            rho=out["rho"],
            num_steps=out["steps"],
            num_newtons=out["newtons"],
            path_dist=out["path_dist"],
        )

    return run
