"""Solver driver: the implicit-Euler homotopy loop, jit-compiled.

Counterpart of the reference driver (``pygradflow/solver.py:233-431``) with
the outer loop expressed as a ``lax.while_loop`` over a small state pytree
``(iterate, lambda, rho, PI error sum, penalty state, counters, status)``.
Rejected steps, penalty vetoes and failure recovery are all branchless
state updates.

Wall-clock concerns (time limit, display rate limiting) live at *chunk*
boundaries: the while_loop runs at most ``params.jit_chunk`` iterations per
device invocation, the Python wrapper loops until a terminal status —
everything on device stays data-dependency-free for XLA.

The same loop body is reused by the batched/sharded frontends
(``parallel/``): ``vmap(solve_state)`` gives per-chip instance batching,
``shard_map`` distributes batches over a mesh.
"""

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .callbacks import Callbacks, CallbackType
from .display import Format, print_problem_stats, solver_display
from .eval import Counters, EvalError, validate_fns
from .iterate import (
    Iterate,
    aug_lag,
    cons_violation,
    evaluate_iterate,
    is_feasible,
    iterate_eval_counts,
    locally_infeasible,
    bounds_dual,
    stat_res,
    total_res,
)
from .jit import jit
from .log import logger
from .params import Params, PenaltyUpdate
from .penalty import penalty_strategy
from .problem import Problem  # noqa: F401  (re-export)
from .result import SolverResult
from .status import RUNNING, SolverStatus
from .step.control import compute_step, make_control_cfg, make_controller
from .timer import Timer
from .transform import Transformation


class LoopState(NamedTuple):
    it: Iterate
    lamb: Any
    rho: Any
    error_sum: Any
    pstate: Any
    iteration: Any
    accepted_steps: Any
    num_penalty_changes: Any
    path_dist: Any
    status: Any
    counters: Counters
    path: Any  # () or (buffer (cap, n+m), times (cap,), length)
    last_rcond: Any  # rcond estimate from the most recent step (NaN when off)
    # () or (flag, first_x, first_y, cand_x, cand_y): the first candidate
    # chain rejected for non-finite values (first evaluated inner candidate
    # + final candidate), kept for the host-side eval diagnosis
    # (params.validate_input)
    eval_fail: Any


class SolveLoop:
    """Compiled solve loop for one (problem, params) pair.

    Separated from the user-facing :class:`Solver` so the batched and
    sharded frontends can reuse ``init_state`` / ``run_chunk`` /
    ``body`` directly.
    """

    def __init__(self, transform: Transformation, params: Params, callbacks=None):
        self.transform = transform
        self.params = params
        self.fns = transform.fns
        self.callbacks = callbacks

        problem = transform.trans_problem
        self.n = problem.num_vars
        self.m = problem.num_cons
        dtype = params.dtype
        self.lb = jnp.asarray(problem.var_lb, dtype=dtype)
        self.ub = jnp.asarray(problem.var_ub, dtype=dtype)

        self.cfg = make_control_cfg(self.fns, params, self.lb, self.ub)
        self.controller = make_controller(self.cfg)
        self.penalty_initial, self.penalty_update = penalty_strategy(
            params, self.m, self.fns
        )

        if params.iteration_limit is not None:
            self.iteration_limit = int(params.iteration_limit)
        else:
            self.iteration_limit = int(params.iteration_limit_default)

        self._run_chunk = jit(self._run_chunk_impl)
        self._init_state = jit(self.init_state)
        self._first_chunk = jit(
            lambda x, y, chunk_end: self._chunk_and_finalize(
                self.init_state(x, y), chunk_end, x, y
            )
        )
        self._next_chunk = jit(self._chunk_and_finalize)
        self._finalize = jit(self._finalize_impl)

    # ------------------------------------------------------------------

    def init_state(self, x, y) -> LoopState:
        params = self.params
        dtype = params.dtype

        it = evaluate_iterate(self.fns, x, y)
        counters = Counters.zero().add(**iterate_eval_counts(self.m))

        rho0, pstate0 = self.penalty_initial()

        if params.collect_path:
            cap = params.path_capacity
            buf = jnp.zeros((cap, self.n + self.m), dtype=dtype)
            buf = buf.at[0].set(jnp.concatenate([x, y]))
            times = jnp.zeros((cap,), dtype=dtype)
            path = (buf, times, jnp.ones((), jnp.int32))
        else:
            path = ()

        return LoopState(
            it=it,
            lamb=jnp.asarray(params.lamb_init, dtype),
            rho=jnp.asarray(rho0, dtype),
            error_sum=jnp.zeros((), dtype),
            pstate=pstate0,
            iteration=jnp.zeros((), jnp.int32),
            accepted_steps=jnp.zeros((), jnp.int32),
            num_penalty_changes=jnp.zeros((), jnp.int32),
            path_dist=jnp.zeros((), dtype),
            status=jnp.asarray(RUNNING, jnp.int32),
            counters=counters,
            path=path,
            last_rcond=jnp.full((), jnp.nan, dtype),
            eval_fail=(
                (
                    jnp.zeros((), bool),
                    jnp.zeros_like(x),
                    jnp.zeros_like(y),
                    jnp.zeros_like(x),
                    jnp.zeros_like(y),
                )
                if params.validate_input
                else ()
            ),
        )

    # ------------------------------------------------------------------

    def check_terminate(self, state: LoopState):
        """Termination conditions in reference priority order
        (``solver.py:180-205``); the time limit is handled by the wrapper
        at chunk boundaries."""
        params = self.params
        it = state.it
        lb, ub = self.lb, self.ub

        status = jnp.asarray(RUNNING, jnp.int32)

        unbounded = jnp.logical_and(
            it.obj <= params.obj_lower_limit, is_feasible(it, lb, ub, params.opt_tol)
        )
        status = jnp.where(unbounded, int(SolverStatus.Unbounded), status)

        infeas = locally_infeasible(
            it, lb, ub, params.active_tol, params.opt_tol,
            params.local_infeas_tol, self.fns,
        )
        status = jnp.where(infeas, int(SolverStatus.LocallyInfeasible), status)

        res = total_res(it, lb, ub, params.active_tol, self.fns)
        status = jnp.where(res <= params.opt_tol, int(SolverStatus.Optimal), status)

        status = jnp.where(
            state.iteration >= self.iteration_limit,
            int(SolverStatus.IterationLimit),
            status,
        )
        return status

    def run_iteration(self, state: LoopState) -> LoopState:
        """One outer iteration (reference ``solver.py:305-380``)."""
        params = self.params

        out = compute_step(
            self.cfg,
            self.controller,
            state.it,
            state.lamb,
            state.rho,
            state.error_sum,
            state.counters,
        )
        ctrl = out.ctrl

        next_it = ctrl.iterate
        lamb_n = ctrl.lamb
        accept = ctrl.accepted

        primal_step_norm = jnp.linalg.norm(next_it.x - state.it.x)
        dual_step_norm = jnp.linalg.norm(next_it.y - state.it.y)

        # penalty update runs only on accepted steps and can veto
        # (reference solver.py:357-369)
        pres = self.penalty_update(state.it, next_it, state.rho, state.pstate)
        accept_final = jnp.logical_and(accept, pres.accept)
        pstate_n = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), pres.state, state.pstate
        )
        rho_n = jnp.where(accept_final, pres.rho, state.rho)
        penalty_changed = jnp.logical_and(accept_final, rho_n != state.rho)

        it_n = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept_final, new, old), next_it, state.it
        )

        path_n = state.path
        if params.collect_path:
            buf, times, length = state.path
            z = jnp.concatenate([next_it.x, next_it.y])
            idx = jnp.minimum(length, params.path_capacity - 1)
            t_new = times[idx - 1] + 1.0 / lamb_n
            do_write = jnp.logical_and(accept_final, length < params.path_capacity)
            buf = jnp.where(do_write, buf.at[idx].set(z), buf)
            times = jnp.where(do_write, times.at[idx].set(t_new), times)
            length = length + do_write.astype(jnp.int32)
            path_n = (buf, times, length)

        eval_fail_n = state.eval_fail
        if params.validate_input:
            flag, fxb, fyb, xb, yb = state.eval_fail
            # record the FIRST non-finite candidate chain (factorization
            # breakdown or bad user eval; the host diagnosis distinguishes)
            new_bad = jnp.logical_and(
                jnp.logical_not(out.eval_ok), jnp.logical_not(flag)
            )
            eval_fail_n = (
                jnp.logical_or(flag, jnp.logical_not(out.eval_ok)),
                jnp.where(new_bad, out.first_x, fxb),
                jnp.where(new_bad, out.first_y, fyb),
                jnp.where(new_bad, out.cand_x, xb),
                jnp.where(new_bad, out.cand_y, yb),
            )

        # lambda blow-up check (reference raises, solver.py:323-326)
        status = jnp.where(
            lamb_n >= params.lamb_max,
            int(SolverStatus.LambdaLimit),
            jnp.asarray(RUNNING, jnp.int32),
        )

        state_n = LoopState(
            it=it_n,
            lamb=lamb_n,
            rho=rho_n,
            error_sum=ctrl.error_sum,
            pstate=pstate_n,
            iteration=state.iteration + 1,
            accepted_steps=state.accepted_steps + accept_final.astype(jnp.int32),
            num_penalty_changes=state.num_penalty_changes
            + penalty_changed.astype(jnp.int32),
            path_dist=state.path_dist
            + jnp.where(accept_final, primal_step_norm + dual_step_norm, 0.0),
            status=status,
            counters=ctrl.counters,
            path=path_n,
            last_rcond=ctrl.rcond,
            eval_fail=eval_fail_n,
        )

        self._emit_row(state, state_n, ctrl, accept_final, primal_step_norm, dual_step_norm)
        return state_n

    def _emit_row(self, state, state_n, ctrl, accept, primal_step, dual_step):
        """Host-side display/callback hooks through jax.debug.callback."""
        params = self.params
        emit_display = params.display
        emit_callback = self.callbacks is not None and not self.callbacks.empty(
            CallbackType.ComputedStep
        )
        if not (emit_display or emit_callback):
            return

        it = state.it
        from .iterate import obj_nonlin

        payload = dict(
            iter=state.iteration + 1,
            aug_lag=aug_lag(it, state.rho),
            obj=it.obj,
            cons_viol=cons_violation(it),
            stat_res=stat_res(it, self.lb, self.ub, params.active_tol, self.fns),
            active=jnp.sum(ctrl.active_set.astype(jnp.int32)),
            obj_nonlin=obj_nonlin(it, ctrl.iterate),
            dx=primal_step,
            dy=dual_step,
            lamb=state_n.lamb,
            rho=state_n.rho,
            accept=accept,
        )
        if params.report_rcond:
            payload["rcond"] = ctrl.rcond

        if emit_display:
            display = self._display()

            def show(**kw):
                if display.should_display():
                    vals = {k: np.asarray(v).item() for k, v in kw.items()}
                    vals["|dx|"] = vals.pop("dx")
                    vals["|dy|"] = vals.pop("dy")
                    display.row(vals)

            jax.debug.callback(show, **payload)

        if emit_callback:
            cb = self.callbacks

            def fire(x, y, xn, yn, acc):
                cb(CallbackType.ComputedStep, (x, y), (xn, yn), bool(acc))

            jax.debug.callback(
                fire, state.it.x, state.it.y, ctrl.iterate.x, ctrl.iterate.y, accept
            )

    @functools.lru_cache(maxsize=1)
    def _display(self):
        return solver_display(self.m, self.params)

    # ------------------------------------------------------------------

    def body(self, state: LoopState) -> LoopState:
        status = self.check_terminate(state)
        return jax.lax.cond(
            status == RUNNING,
            self.run_iteration,
            lambda s: s._replace(status=status),
            state,
        )

    def _run_chunk_impl(self, state: LoopState, chunk_end) -> LoopState:
        def cond(s):
            return jnp.logical_and(s.status == RUNNING, s.iteration < chunk_end)

        return jax.lax.while_loop(cond, self.body, state)

    def _finalize_impl(self, state: LoopState, x0, y0):
        """Everything the wrapper needs after the loop, as ONE device call
        returning a dict fetched with a single ``jax.device_get``: each
        eager dispatch or scalar fetch costs a full host<->device round
        trip, so the final residuals,
        solution restoration and all result scalars are fused here."""
        params = self.params
        it = state.it
        d = bounds_dual(it, self.lb, self.ub, params.active_tol, self.fns)
        direct_dist = jnp.sqrt(
            jnp.sum((it.x - x0) ** 2) + jnp.sum((it.y - y0) ** 2)
        )
        x_r, y_r, d_r = self.transform.restore_sol(it.x, it.y, d)
        c = state.counters
        dtype = it.x.dtype
        eval_fail_flag = (
            state.eval_fail[0] if params.validate_input else jnp.zeros((), bool)
        )
        scalars = jnp.stack(
            [
                jnp.asarray(v, dtype)
                for v in (
                    direct_dist,
                    stat_res(it, self.lb, self.ub, params.active_tol, self.fns),
                    cons_violation(it),
                    it.obj,
                    state.rho,
                    state.path_dist,
                    state.lamb,
                    state.iteration,
                    state.accepted_steps,
                    state.num_penalty_changes,
                    c.obj,
                    c.obj_grad,
                    c.cons,
                    c.cons_jac,
                    c.lag_hess,
                    state.last_rcond,
                    eval_fail_flag,
                    state.status,
                )
            ]
        )
        out = dict(sol=(x_r, y_r, d_r), scalars=scalars)
        if params.validate_input:
            out["eval_fail"] = state.eval_fail[1:]
        return out

    def _chunk_and_finalize(self, state, chunk_end, x0, y0):
        state = self._run_chunk_impl(state, chunk_end)
        return state, self._finalize_impl(state, x0, y0)

    def run_fused(self, x, y, timer: Timer):
        """Drive a fresh solve with minimal host<->device traffic: state
        init is fused into the first chunk dispatch, the finalizer runs
        inside every chunk call, and only the packed scalar vector is
        fetched per chunk (one host<->device round trip).
        Returns ``(state, fin, scalars_np, sol_np)`` — the solution
        triple rides the same per-chunk fetch, so the caller pays no
        extra round trip after the final chunk."""
        chunk = self.params.jit_chunk
        state, fin = self._first_chunk(x, y, jnp.asarray(chunk, jnp.int32))
        while True:
            # ONE blocking fetch per chunk: scalars + solution arrays
            # together (the sol triple is a few KB for single solves, so
            # bundling it here saves the separate device_get round trip
            # the caller would otherwise pay after the final chunk)
            fetched = jax.device_get({"scalars": fin["scalars"], "sol": fin["sol"]})
            scalars = np.array(fetched["scalars"])  # copy: mutated on TimeLimit
            status = int(scalars[-1])
            if status != RUNNING:
                return state, fin, scalars, fetched["sol"]
            if timer.reached_time_limit():
                scalars[-1] = int(SolverStatus.TimeLimit)
                state = state._replace(
                    status=jnp.asarray(int(SolverStatus.TimeLimit), jnp.int32)
                )
                return state, fin, scalars, fetched["sol"]
            state, fin = self._next_chunk(state, state.iteration + chunk, x, y)

    def run(self, state: LoopState, timer: Timer, ckpt=None) -> LoopState:
        """Drive chunks until a terminal status or the time limit,
        optionally checkpointing at chunk boundaries."""
        chunk = self.params.jit_chunk
        while True:
            chunk_end = state.iteration + chunk
            state = self._run_chunk(state, chunk_end)
            if int(state.status) != RUNNING:
                return state
            if ckpt is not None:
                ckpt.maybe_save(state)
            if timer.reached_time_limit():
                return state._replace(
                    status=jnp.asarray(int(SolverStatus.TimeLimit), jnp.int32)
                )


class Solver:
    """User-facing solver (reference ``pygradflow/solver.py:26-431``)."""

    def __init__(self, problem: Problem, params: Params = None) -> None:
        if params is None:
            params = Params()
        self.orig_problem = problem
        self.params = params
        self.callbacks = Callbacks()

        self.transform = Transformation(problem, params)
        self.problem = self.transform.trans_problem
        self.evaluator = self.transform.fns

        self._loop = SolveLoop(self.transform, params, self.callbacks)

    # ------------------------------------------------------------------

    def _deriv_check(self, x, y):
        from .deriv_check import deriv_check_problem

        deriv_check_problem(self.problem, self.params, x, y)

    def perform_iteration(self, x0=None, y0=None):
        """Single implicit-Euler step (reference ``solver.py:207-231``)."""
        params = self.params
        loop = self._loop

        x, y = self.transform.create_transformed_initial(x0, y0)
        state = loop.init_state(x, y)
        state = loop.run_iteration(state)

        it = state.it
        d = bounds_dual(it, loop.lb, loop.ub, params.active_tol, loop.fns)
        return self.transform.restore_sol(it.x, it.y, d)

    def solve(
        self, x0=None, y0=None, checkpoint_path=None, resume=False
    ) -> SolverResult:
        """Solve the problem.  With ``checkpoint_path`` the homotopy state
        is snapshotted at every jit-chunk boundary; ``resume=True`` picks up
        from an existing snapshot (bitwise-identical continuation)."""
        params = self.params
        loop = self._loop

        x, y = self.transform.create_transformed_initial(x0, y0)

        if params.validate_input:
            try:
                validate_fns(self.transform.fns, x, y)
            except EvalError as e:
                raise Exception("Failed to evaluate initial iterate") from e

        print_problem_stats(self.problem, loop.n, loop.m)

        self._deriv_check(x, y)

        timer = Timer(params.time_limit)

        ckpt = None
        if checkpoint_path is not None:
            from .checkpoint import CheckpointManager

            ckpt = CheckpointManager(checkpoint_path)

        def drive():
            if ckpt is None:
                # fresh solve without checkpointing: init fused into the
                # first chunk dispatch, finalizer fused into every chunk
                return loop.run_fused(x, y, timer)
            state0 = loop._init_state(x, y)
            if resume and ckpt.exists():
                state0 = ckpt.restore(state0)
            state = loop.run(state0, timer, ckpt)
            fin = loop._finalize(state, x, y)
            return state, fin, np.asarray(fin["scalars"]), None

        if params.profile_dir:
            with jax.profiler.trace(params.profile_dir):
                state, fin, scalars, sol_np = drive()
        else:
            state, fin, scalars, sol_np = drive()

        total_time = timer.elapsed()

        (
            direct_dist,
            final_stat_res,
            final_cons_violation,
            final_obj,
            rho,
            path_dist,
            _lamb,
            iterations,
            accepted_steps,
            penalty_changes,
            c_obj,
            c_obj_grad,
            c_cons,
            c_cons_jac,
            c_lag_hess,
            final_rcond,
            _eval_fail,
            _status_val,
        ) = (float(v) for v in scalars)

        status = SolverStatus(int(_status_val))

        # eval diagnosis (debug-mode parity with the reference
        # ValidatingEvaluator, eval.py:130-211): a candidate was rejected
        # for non-finite values at some point — replay the user callbacks
        # eagerly at that point and name the culprit component
        failed_component = None
        fail_x = None
        if params.validate_input and _eval_fail != 0.0:
            from .eval import diagnose_eval_failure

            first_x, first_y, cand_x, cand_y = jax.device_get(fin["eval_fail"])
            # try the first evaluated inner candidate (finite coordinates
            # even when its bad eval poisoned later candidates), then the
            # final candidate
            for fail_x, fail_y in ((first_x, first_y), (cand_x, cand_y)):
                failed_component = diagnose_eval_failure(
                    self.transform.fns, fail_x, fail_y
                )
                if failed_component is not None:
                    break
            if failed_component is not None:
                logger.warning(
                    "Evaluation of %s produced non-finite values at x = %s "
                    "(step rejected)",
                    failed_component.name(),
                    np.asarray(fail_x),
                )

        if status == SolverStatus.LambdaLimit:
            if failed_component is not None:
                raise EvalError(
                    f"Evaluation of {failed_component.name()} produced "
                    f"non-finite values at x = {np.asarray(fail_x)}",
                    fail_x,
                )
            raise Exception(
                f"Inverse step size {_lamb} exceeded maximum "
                f"{params.lamb_max} (incorrect derivatives?)"
            )

        (x_r, y_r, d_r) = sol_np if sol_np is not None else jax.device_get(fin["sol"])
        dist_factor = path_dist / direct_dist if direct_dist != 0.0 else 1.0

        from .eval import Component

        num_evals = {
            Component.Obj: int(c_obj),
            Component.ObjGrad: int(c_obj_grad),
            Component.Cons: int(c_cons),
            Component.ConsJac: int(c_cons_jac),
            Component.LagHess: int(c_lag_hess),
        }

        self._print_result(
            total_time=total_time,
            status=status,
            iterations=int(iterations),
            accepted_steps=int(accepted_steps),
            penalty_changes=int(penalty_changes),
            rho=rho,
            dist_factor=dist_factor,
            final_obj=final_obj,
            final_stat_res=final_stat_res,
            final_cons_violation=final_cons_violation,
            num_evals=num_evals,
        )

        result = SolverResult(
            self.problem,
            x_r,
            y_r,
            d_r,
            status,
            iterations=int(iterations),
            num_accepted_steps=int(accepted_steps),
            total_time=total_time,
            dist_factor=dist_factor,
            final_scaled_obj=final_obj,
            final_stat_res=final_stat_res,
            final_cons_violation=final_cons_violation,
            num_penalty_changes=int(penalty_changes),
            num_evals=num_evals,
            final_rcond=final_rcond,
        )

        if params.collect_path:
            buf, times, length = state.path
            length = int(length)
            # initial point + one entry per accepted step unless the ring
            # stopped recording at capacity (the reference path is
            # unbounded, solver.py:333-340) — tell the user it's truncated
            if int(accepted_steps) + 1 > length:
                logger.warning(
                    "Trajectory truncated: %d accepted steps exceed "
                    "path_capacity=%d; raise Params.path_capacity to "
                    "record the full path",
                    int(accepted_steps),
                    params.path_capacity,
                )
            result._set_path(
                np.asarray(buf[:length]).T, np.asarray(times[:length])
            )

        return result

    def _print_result(
        self,
        total_time,
        status,
        iterations,
        accepted_steps,
        penalty_changes,
        rho,
        dist_factor,
        final_obj,
        final_stat_res,
        final_cons_violation,
        num_evals,
    ):
        desc = "{:>45s}".format(SolverStatus.description(status))
        status_desc = Format.redgreen(desc, SolverStatus.success(status), bold=True)
        status_name = Format.bold("{:>20s}".format("Status"))

        logger.info("%20s: %45s", status_name, status_desc)
        logger.info("%20s: %45s", "Time", f"{total_time:.2f}s")
        logger.info("%20s: %45d", "Iterations", iterations)
        logger.info("%20s: %45d", "Accepted steps", accepted_steps)
        logger.info("%20s: %45e", "Distance factor", dist_factor)

        if self.params.penalty_update != PenaltyUpdate.Constant:
            logger.info("%20s: %45e", "Final penalty", rho)
            logger.info("%20s: %45d", "Penalty changes", penalty_changes)

        logger.info("%20s: %45e", "Objective", final_obj)
        logger.info("%20s: %45e", "Constraint violation", final_cons_violation)
        logger.info("%20s: %45e", "Dual violation", final_stat_res)

        logger.info("%20s", Format.bold("{:>20s}".format("Evaluations")))
        for component, num in num_evals.items():
            logger.info("%20s: %45d", component.name(), num)
