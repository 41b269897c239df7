"""Continuous-flow solver with event detection.

Counterpart of the reference IntegrationSolver
(``pygradflow/integration/integration_solver.py``): instead of discrete
implicit-Euler steps, integrate the *restricted* augmented-Lagrangian
gradient flow (free variables move, pinned variables stay at their bounds)
until an event — a free variable hitting a bound, a pinned variable's
gradient changing sign, convergence, unboundedness, or violation of the
penalty continuation criterion — then flip the corresponding filter bit or
grow rho and continue.

The heavy work (adaptive implicit integration, event evaluation) runs in
jit-compiled segments (``integrator.py``); the outer event loop is host
Python, like the reference's scipy orchestration.
"""

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..display import integrator_display, print_problem_stats
from ..eval import validate_fns
from ..iterate import bounds_dual, evaluate_iterate, is_feasible, locally_infeasible
from ..jit import jit
from ..log import logger
from ..params import Params
from ..result import SolverResult
from ..status import RUNNING, SolverStatus
from ..timer import Timer
from ..transform import Transformation
from . import events as ev
from . import flow as fl
from .integrator import bisect_event, make_segment_runner


class IntegrationSolver:
    def __init__(self, problem, params: Optional[Params] = None):
        if params is None:
            params = Params()
        self.orig_problem = problem
        self.params = params

        self.transform = Transformation(problem, params)
        self.problem = self.transform.trans_problem
        self.fns = self.transform.fns

        dtype = params.dtype
        self.lb = jnp.asarray(self.problem.var_lb, dtype=dtype)
        self.ub = jnp.asarray(self.problem.var_ub, dtype=dtype)
        self.ctx = fl.FlowCtx(fns=self.fns, lb=self.lb, ub=self.ub)
        self.cfg = ev.EventCfg(
            ctx=self.ctx,
            opt_tol=params.opt_tol,
            obj_lower_limit=params.obj_lower_limit,
            active_tol=params.active_tol,
        )

        self._run_segment, self._step_fn = make_segment_runner(
            self.cfg,
            method=params.integration_method,
            rtol=params.integration_rtol,
            atol=params.integration_atol,
            max_steps=params.integration_max_steps,
        )

    # ------------------------------------------------------------------

    def create_filter(self, z, rho):
        """Free-variable mask from active bounds and flow signs, with
        second-order tie-breaks (reference
        ``integration_solver.py:90-123``)."""
        ctx = self.ctx
        x, _ = fl.split(ctx, z)
        at_lb = np.asarray(fl.isclose(x, self.lb))
        at_ub = np.asarray(fl.isclose(x, self.ub))

        dx = np.asarray(-fl.aug_lag_deriv_x(ctx, z, rho))
        dx_zero = np.asarray(fl.isclose(jnp.asarray(dx), 0.0))

        fixed = np.logical_or(
            np.logical_and(at_lb, dx < 0), np.logical_and(at_ub, dx > 0)
        )

        ambiguous = np.logical_and(dx_zero, np.logical_or(at_lb, at_ub))
        if ambiguous.any():
            ddx = np.asarray(fl.rhs_deriv_x(ctx, z, rho))
            if np.asarray(fl.isclose(jnp.asarray(ddx)[ambiguous], 0.0)).any():
                raise Exception("Degenerate bound")
            amb_lb = np.logical_and(at_lb, dx_zero)
            fixed[amb_lb] = ddx[amb_lb] < 0
            amb_ub = np.logical_and(at_ub, dx_zero)
            fixed[amb_ub] = ddx[amb_ub] > 0

        return jnp.asarray(np.logical_not(fixed))

    # ------------------------------------------------------------------

    def solve(self, x0=None, y0=None) -> SolverResult:
        params = self.params
        problem = self.problem
        n = self.ctx.n

        x, y = self.transform.create_transformed_initial(x0, y0)
        if params.validate_input:
            validate_fns(self.fns, x, y)

        if (
            params.integration_device_loop
            and not params.collect_path
            and not params.display
        ):
            return self._solve_device(x, y)

        print_problem_stats(problem, problem.num_vars, problem.num_cons)

        rho = params.rho
        z = jnp.concatenate([x, y])
        t = 0.0
        h0 = 1e-4  # carried across segments once the controller adapts it
        filter = self.create_filter(z, rho)

        z_init = z
        status = None
        iteration = 0
        path_dist = 0.0
        total_steps = 0
        total_newtons = 0

        path = [np.asarray(z)[:, None]] if params.collect_path else None
        path_times = [np.array([0.0])] if params.collect_path else None

        timer = Timer(params.time_limit)
        iteration_limit = params.iteration_limit or params.iteration_limit_default
        display = integrator_display(self.ctx.m, params) if params.display else None

        while True:
            res = float(fl.residuum(self.ctx, z, filter))
            if res <= params.opt_tol:
                status = SolverStatus.Optimal
                break

            if timer.reached_time_limit():
                status = SolverStatus.TimeLimit
                break

            it = evaluate_iterate(self.fns, *fl.split(self.ctx, z))
            if bool(
                locally_infeasible(
                    it, self.lb, self.ub, params.active_tol, params.opt_tol,
                    params.local_infeas_tol,
                )
            ):
                status = SolverStatus.LocallyInfeasible
                break
            if bool(it.obj <= params.obj_lower_limit) and bool(
                is_feasible(it, self.lb, self.ub, params.opt_tol)
            ):
                status = SolverStatus.Unbounded
                break

            grad_dirs = ev.grad_event_dirs(self.ctx, z, filter, self.lb, self.ub)
            t_end = t + 1e10

            seg = self._run_segment(
                jnp.asarray(t, z.dtype), z, jnp.asarray(h0, z.dtype), rho,
                filter, grad_dirs, jnp.asarray(t_end, z.dtype),
            )

            seg_status = int(seg.status)
            iteration += 1
            total_steps += int(seg.num_steps)
            total_newtons += int(seg.num_newton)
            # carry the adapted step when the segment merely ran out of
            # horizon (t_end): the dynamics are unchanged, and restarting
            # at 1e-4 wastes a ramp-up.  After a real event the filter or
            # rho changes the dynamics, so keep the conservative restart
            # (which also preserves the reference-matching event sequence).
            h0 = max(float(seg.h), 1e-10) if seg_status == 1 else 1e-4

            if display is not None and display.should_display():
                display.row(
                    dict(
                        iter=iteration,
                        t=float(seg.t),
                        obj=float(fl.obj(self.ctx, seg.z)),
                        res=float(fl.residuum(self.ctx, seg.z, filter)),
                        rho=rho,
                        steps=int(seg.num_steps),
                        free=int(np.asarray(filter).sum()),
                    )
                )

            if seg_status == 2:
                # integrator breakdown: treat as a failed solve
                logger.warning("Integrator failed to advance at t=%s", float(seg.t))
                status = SolverStatus.IterationLimit
                z = seg.z
                break

            if seg_status == 0:
                crossed_step = np.asarray(seg.crossed)
                if bool(crossed_step[3 * n]) and crossed_step.sum() == 1:
                    # pure-convergence crossing: any point past it has
                    # residuum <= opt_tol, so the segment's accepted
                    # endpoint certifies Optimal — skip the bisection
                    # (device/flat engines short-circuit identically)
                    t_ev, z_ev, crossed = float(seg.t), seg.z, crossed_step
                else:
                    # refine the event location by bisection
                    def run_vals(zz):
                        return ev.event_values(
                            self.cfg, zz, rho, filter, grad_dirs
                        )

                    t_ev, z_ev, crossed = bisect_event(
                        self.cfg,
                        self._step_fn,
                        run_vals,
                        seg.t_prev,
                        seg.z_prev,
                        float(seg.t),
                        rho,
                        filter,
                        grad_dirs,
                        z_end=seg.z,
                    )
                    crossed = np.asarray(crossed)
                path_dist += float(jnp.linalg.norm(z_ev - z))
                t, z = t_ev, z_ev

                # clip into the box (reference integration_solver.py:330)
                xz, yz = fl.split(self.ctx, z)
                z = jnp.concatenate([jnp.clip(xz, self.lb, self.ub), yz])

                if path is not None:
                    path.append(np.asarray(z)[:, None])
                    path_times.append(np.array([t]))

                handled = self._handle_crossings(crossed, z, rho, filter)
                if handled is None:
                    # e.g. unbounded event at an infeasible point: resume
                    pass
                else:
                    kind, payload = handled
                    if kind == "status":
                        status = payload
                        break
                    elif kind == "filter":
                        filter = payload
                    else:
                        assert kind == "penalty"
                        logger.debug(
                            "Penalty event: rho %e -> %e", rho, 10.0 * rho
                        )
                        rho = 10.0 * rho
                        filter = self.create_filter(z, rho)
            else:
                # reached t_end without an event
                path_dist += float(jnp.linalg.norm(seg.z - z))
                t, z = float(seg.t), seg.z
                if path is not None:
                    path.append(np.asarray(z)[:, None])
                    path_times.append(np.array([t]))

            if iteration >= iteration_limit:
                status = SolverStatus.IterationLimit
                break

        # ------------------------------------------------------------------
        it = evaluate_iterate(self.fns, *fl.split(self.ctx, z))
        d = bounds_dual(it, self.lb, self.ub, params.active_tol)

        direct_dist = float(jnp.linalg.norm(z - z_init))
        dist_factor = path_dist / direct_dist if direct_dist != 0.0 else 1.0
        total_time = timer.elapsed()

        (xr, yr, dr) = self.transform.restore_sol(it.x, it.y, d)

        result = SolverResult(
            problem,
            xr,
            yr,
            dr,
            status,
            iterations=iteration,
            num_accepted_steps=iteration,
            total_time=total_time,
            dist_factor=dist_factor,
            num_integration_steps=total_steps,
            num_newton_steps=total_newtons,
            final_rho=rho,
        )
        if path is not None:
            result._set_path(np.hstack(path), np.hstack(path_times))
        return result

    # ------------------------------------------------------------------

    def _solve_device(self, x, y):
        """Device-resident solve (``Params.integration_device_loop``).

        With ``time_limit=inf`` (the default) the whole solve is ONE
        dispatch of ``device_loop.py``.  With a finite limit it runs the
        flat chunked engine (``flat_loop.py``) in dispatches of
        ``params.integration_chunk`` work units, checking the Timer
        between dispatches — the limit is enforceable and no single
        dispatch runs unboundedly long."""
        import jax

        from .device_loop import make_device_loop

        params = self.params
        timer = Timer(params.time_limit)

        if np.isfinite(params.time_limit):
            return self._solve_device_chunked(x, y, timer)

        if not hasattr(self, "_device_run"):
            loop = make_device_loop(
                self.cfg, self.fns, self.lb, self.ub, params,
                self._run_segment, self._step_fn,
            )

            def full(x, y):
                res = loop(x, y)
                xr, yr = fl.split(self.ctx, res.z)
                it = evaluate_iterate(self.fns, xr, yr)
                d = bounds_dual(it, self.lb, self.ub, params.active_tol)
                return res, (it.x, it.y, d)

            self._device_run = jit(full)

        res, (xf, yf, d) = jax.device_get(self._device_run(x, y))

        (xr, yr, dr) = self.transform.restore_sol(xf, yf, d)
        direct = float(np.linalg.norm(np.concatenate([xf, yf]) - np.concatenate([np.asarray(x), np.asarray(y)])))
        dist_factor = float(res.path_dist) / direct if direct != 0.0 else 1.0

        return SolverResult(
            self.problem,
            xr,
            yr,
            dr,
            SolverStatus(int(res.status)),
            iterations=int(res.iterations),
            num_accepted_steps=int(res.iterations),
            total_time=timer.elapsed(),
            dist_factor=dist_factor,
            num_integration_steps=int(res.num_steps),
            num_newton_steps=int(res.num_newtons),
            final_rho=float(res.rho),
        )

    def _solve_device_chunked(self, x, y, timer):
        """Flat chunked engine: time_limit enforced at chunk boundaries."""
        import jax

        from .flat_loop import make_flat_loop

        params = self.params

        if not hasattr(self, "_flat"):
            init_fn, chunk_fn, _ = make_flat_loop(
                self.cfg, self.fns, self.lb, self.ub, params
            )
            budget = int(params.integration_chunk)

            def post_fn(state):
                xr, yr = fl.split(self.ctx, state["z"])
                it = evaluate_iterate(self.fns, xr, yr)
                d = bounds_dual(it, self.lb, self.ub, params.active_tol)
                return (
                    it.x, it.y, d, state["path_dist"], state["iteration"],
                    state["steps"], state["newtons"], state["rho"],
                )

            # all three jitted ONCE (a fresh jit per call re-traces)
            self._flat = (
                jit(init_fn),
                jit(lambda s: chunk_fn(s, budget)),
                jit(post_fn),
            )
        init_fn, run_chunk, post_jit = self._flat

        state = init_fn(x, y)
        status = int(SolverStatus.TimeLimit)
        while True:
            state = run_chunk(state)
            status = int(jax.device_get(state["status"]))
            if status != int(RUNNING):
                break
            if timer.reached_time_limit():
                status = int(SolverStatus.TimeLimit)
                break

        xf, yf, d, path_dist, iters, steps, newtons, rho = jax.device_get(
            post_jit(state)
        )

        (xr, yr, dr) = self.transform.restore_sol(xf, yf, d)
        direct = float(
            np.linalg.norm(
                np.concatenate([xf, yf])
                - np.concatenate([np.asarray(x), np.asarray(y)])
            )
        )
        dist_factor = float(path_dist) / direct if direct != 0.0 else 1.0

        return SolverResult(
            self.problem,
            xr,
            yr,
            dr,
            SolverStatus(status),
            iterations=int(iters),
            num_accepted_steps=int(iters),
            total_time=timer.elapsed(),
            dist_factor=dist_factor,
            num_integration_steps=int(steps),
            num_newton_steps=int(newtons),
            final_rho=float(rho),
        )

    # ------------------------------------------------------------------

    def _handle_crossings(self, crossed, z, rho, filter):
        """Reference ``handle_events`` (``integration_solver.py:143-225``):
        process crossings in priority order."""
        n = self.ctx.n
        params = self.params

        idxs = np.where(crossed)[0]
        for idx in idxs:
            if idx < 2 * n:
                j = idx % n
                logger.debug("Variable %d hit a bound; pinning", j)
                return ("filter", filter.at[j].set(False))
            elif idx < 3 * n:
                j = idx - 2 * n
                logger.debug("Pinned variable %d released", j)
                return ("filter", filter.at[j].set(True))
            elif idx == 3 * n:
                return ("status", SolverStatus.Optimal)
            elif idx == 3 * n + 1:
                it = evaluate_iterate(self.fns, *fl.split(self.ctx, z))
                if bool(is_feasible(it, self.lb, self.ub, params.opt_tol)):
                    return ("status", SolverStatus.Unbounded)
                continue  # infeasible: keep scanning other events
            else:
                return ("penalty", None)
        return None
