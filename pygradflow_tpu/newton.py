"""Semismooth Newton methods for the implicit-Euler subproblem.

Counterparts of the reference's four Newton variants
(``pygradflow/newton.py``), expressed as pairs of pure functions::

    init(orig_iterate, lamb, rho, tau, counters) -> (carry, counters)
    step(carry, cur_iterate, counters) -> (StepResult, carry, counters)

``carry`` holds whatever the variant freezes (factorization, derivatives),
making the trade-offs explicit in data: Simplified factors once in ``init``
and only back-solves in ``step``; Full refactors every ``step``; ActiveSet
keeps derivatives frozen but reassembles when the active set moves (here
reassembly is cheap dense masking, so it simply refactors each step —
detecting "no change" would cost a sync); Globalized adds an Armijo line
search on the residual merit under ``lax.while_loop``.

Evaluation counters are threaded through explicitly (the reference counts
via its Evaluator, ``eval.py:60-85``).
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from . import implicit_func as impl
from .eval import Counters, Fns
from .iterate import (
    Iterate,
    aug_lag_deriv_xx,
    evaluate_iterate,
    iterate_eval_counts,
)
from .params import NewtonType, Params
from .step.solvers import StepResult, StepSolverDef, make_step_result


class NewtonCfg(NamedTuple):
    fns: Fns
    params: Params
    lb: Any
    ub: Any
    ssdef: StepSolverDef


def _eval_hess(cfg: NewtonCfg, it: Iterate, rho, counters):
    """Hessian for the step matrix: the Standard solver uses the full
    augmented Hessian at the runtime rho, the scaled solvers the plain
    Lagrangian Hessian (reference ``scaled_step_solver.py:76-79``)."""
    h_rho = rho if cfg.ssdef.hess_rho_is_runtime else 0.0
    H = aug_lag_deriv_xx(cfg.fns, it, h_rho)
    return H, counters.add(lag_hess=1)


def _factorize(cfg: NewtonCfg, func, it: Iterate, active, rho, counters):
    """Assemble + factor the step matrix.  A matrix-free StepSolverDef
    receives the ITERATE and derives the blocks it needs through
    jvp/vjp/hvp probes (one Hessian-equivalent evaluation, charged as
    such) instead of the dense H and J."""
    if cfg.ssdef.matrix_free:
        fact = cfg.ssdef.factor(func, it, active, rho)
        return fact, counters.add(lag_hess=1, cons_jac=1)
    H, counters = _eval_hess(cfg, it, rho, counters)
    fact = cfg.ssdef.factor(func, H, it.cons_jac, active, rho)
    return fact, counters.add(cons_jac=0)


def _make_func(cfg: NewtonCfg, orig: Iterate, lamb) -> impl.StepFunc:
    return impl.make_step_func(orig, lamb, cfg.lb, cfg.ub, scaled=cfg.ssdef.scaled)


def _result(cfg: NewtonCfg, it: Iterate, dx, dy, active, rcond=None) -> StepResult:
    return make_step_result(it, dx, dy, cfg.lb, cfg.ub, active, rcond)


# ----------------------------------------------------------------------
# Simplified Newton (default): derivative + active set frozen at origin
# (reference newton.py:35-60)
# ----------------------------------------------------------------------


def _simplified(cfg: NewtonCfg):
    def init(orig: Iterate, lamb, rho, tau, counters: Counters):
        func = _make_func(cfg, orig, lamb)
        active = impl.compute_active_set(func, orig, rho, tau, fns=cfg.fns)
        fact, counters = _factorize(cfg, func, orig, active, rho, counters)
        return (func, fact, rho), counters

    def step(carry, cur: Iterate, counters: Counters):
        func, fact, rho = carry
        dx, dy = cfg.ssdef.solve(fact, func, cur, rho)
        return _result(cfg, cur, dx, dy, fact.active, fact.rcond), carry, counters

    return init, step


# ----------------------------------------------------------------------
# Full Newton: re-evaluate + refactor each inner iteration
# (reference newton.py:63-89)
# ----------------------------------------------------------------------


def _full(cfg: NewtonCfg):
    def init(orig: Iterate, lamb, rho, tau, counters: Counters):
        func = _make_func(cfg, orig, lamb)
        return (func, rho, tau), counters

    def step(carry, cur: Iterate, counters: Counters):
        func, rho, tau = carry
        active = impl.compute_active_set(func, cur, rho, tau, fns=cfg.fns)
        fact, counters = _factorize(cfg, func, cur, active, rho, counters)
        dx, dy = cfg.ssdef.solve(fact, func, cur, rho)
        return _result(cfg, cur, dx, dy, active, fact.rcond), carry, counters

    return init, step


# ----------------------------------------------------------------------
# ActiveSet Newton: derivatives frozen at origin, active set tracks the
# current iterate (reference newton.py:181-215)
# ----------------------------------------------------------------------


def _active_set(cfg: NewtonCfg):
    def init(orig: Iterate, lamb, rho, tau, counters: Counters):
        func = _make_func(cfg, orig, lamb)
        if not cfg.ssdef.matrix_free:
            H, counters = _eval_hess(cfg, orig, rho, counters)
        else:
            H = None  # matrix-free: probes run at the frozen origin
        return (func, H, orig, rho, tau), counters

    def step(carry, cur: Iterate, counters: Counters):
        func, H, orig, rho, tau = carry
        active = impl.compute_active_set(func, cur, rho, tau, fns=cfg.fns)
        if cfg.ssdef.matrix_free:
            fact = cfg.ssdef.factor(func, orig, active, rho)
            counters = counters.add(lag_hess=1, cons_jac=1)
        else:
            fact = cfg.ssdef.factor(func, H, orig.cons_jac, active, rho)
        dx, dy = cfg.ssdef.solve(fact, func, cur, rho)
        return _result(cfg, cur, dx, dy, active, fact.rcond), carry, counters

    return init, step


# ----------------------------------------------------------------------
# Globalized Newton: Full Newton + Armijo line search on 1/2 ||F||^2
# (reference newton.py:218-304)
# ----------------------------------------------------------------------


def _globalized(cfg: NewtonCfg):
    fns = cfg.fns
    params = cfg.params
    m = fns.num_cons

    def init(orig: Iterate, lamb, rho, tau, counters: Counters):
        func = _make_func(cfg, orig, lamb)
        return (func, rho, tau), counters

    def step(carry, cur: Iterate, counters: Counters):
        func, rho, tau = carry
        orig = func.orig

        active = impl.compute_active_set(func, cur, rho, tau)
        H, counters = _eval_hess(cfg, cur, rho, counters)
        fact = cfg.ssdef.factor(func, H, cur.cons_jac, active, rho)

        # direction from the residual at the *origin* iterate
        # (reference newton.py:250: step_solver.solve(self.orig_iterate))
        dx0, dy0 = cfg.ssdef.solve(fact, func, orig, rho)

        rx, ry = impl.value_at(func, cur, rho)
        res_value = 0.5 * (jnp.dot(rx, rx) + jnp.dot(ry, ry))

        # slope F'^T F (reference newton.py:263-272)
        deriv = impl.deriv(func, cur.cons_jac, H, active)
        fval = jnp.concatenate([rx, ry])
        fgrad = deriv.T @ fval
        n = dx0.shape[0]
        inner = jnp.dot(fgrad[:n], dx0) + jnp.dot(fgrad[n:], dy0)

        max_it = params.linesearch_max_it

        def ls_cond(c):
            return jnp.logical_and(c["trial"] < max_it, jnp.logical_not(c["done"]))

        def ls_body(c):
            dx, dy = c["dx"], c["dy"]
            cand = evaluate_iterate(fns, cur.x - dx, cur.y - dy)
            crx, cry = impl.value_at(func, cand, rho)
            cres = 0.5 * (jnp.dot(crx, crx) + jnp.dot(cry, cry))

            ok = jnp.logical_or(
                cres <= params.newton_tol,
                cres <= res_value + 1e-4 * c["alpha"] * inner,
            )

            alpha = c["alpha"] * 0.5
            counters2 = c["counters"].add(**iterate_eval_counts(m))
            return dict(
                alpha=jnp.where(ok, c["alpha"], alpha),
                dx=jnp.where(ok, dx, alpha * dx0),
                dy=jnp.where(ok, dy, alpha * dy0),
                trial=c["trial"] + 1,
                done=ok,
                counters=counters2,
            )

        ls0 = dict(
            alpha=jnp.ones_like(res_value),
            dx=dx0,
            dy=dy0,
            trial=jnp.zeros((), jnp.int32),
            done=res_value <= params.newton_tol,
            counters=counters,
        )
        ls = jax.lax.while_loop(ls_cond, ls_body, ls0)
        counters = ls["counters"]

        # exhausted line search = failure -> non-finite step forces rejection
        # (reference raises "Line search failed to converge", newton.py:297)
        failed = jnp.logical_not(ls["done"])
        nan = jnp.full_like(ls["dx"], jnp.nan)
        dx = jnp.where(failed, nan, ls["dx"])
        dy = ls["dy"]

        # final step applied at the *origin* (reference newton.py:299)
        return _result(cfg, orig, dx, dy, active, fact.rcond), carry, counters

    return init, step


# ----------------------------------------------------------------------
# FixedActiveSet Newton: user-pinned active set, derivatives re-evaluated
# and refactored each inner step (reference newton.py:92-178; unreachable
# dead code there — its __init__ dereferences the step_solver *module*,
# newton.py:101 — so semantics here follow this package's convention:
# active = pinned/clipped)
# ----------------------------------------------------------------------


def active_set_from_iterate(
    fns: Fns, it: Iterate, lb, ub, rho=0.0, active_tol=1e-8
):
    """Classify variables as pinned from the sign of the augmented-
    Lagrangian gradient at the bounds (counterpart of the reference's
    ``FixedActiveSetNewtonMethod.active_set_from_iterate``,
    ``newton.py:131-156``): a variable sitting on (or violating) a bound
    whose flow direction ``-d`` points outward stays clipped; everything
    else is free."""
    from .iterate import aug_lag_deriv_x

    x = it.x
    d = aug_lag_deriv_x(it, rho, fns=fns)
    at_lower = x <= lb + active_tol
    at_upper = x >= ub - active_tol
    pin_lower = jnp.logical_and(at_lower, d >= 0.0)
    pin_upper = jnp.logical_and(at_upper, d <= 0.0)
    return jnp.logical_or(pin_lower, pin_upper)


def _fixed_active_set(cfg: NewtonCfg):
    fixed = cfg.params.fixed_active_set

    def init(orig: Iterate, lamb, rho, tau, counters: Counters):
        func = _make_func(cfg, orig, lamb)
        if fixed is None:
            active = active_set_from_iterate(
                cfg.fns, orig, cfg.lb, cfg.ub, rho, cfg.params.active_tol
            )
        else:
            active = jnp.asarray(fixed)
            # the reference asserts both shape and dtype (newton.py:104-105);
            # without this a wrong-length array silently broadcasts into the
            # active-set masking or dies with an opaque trace-time error
            if active.dtype != jnp.bool_:
                raise ValueError(
                    "params.fixed_active_set must be a bool array "
                    f"(got dtype {active.dtype})"
                )
            if active.shape != orig.x.shape:
                raise ValueError(
                    "params.fixed_active_set must cover the TRANSFORMED "
                    f"variables: expected shape {orig.x.shape} (after "
                    f"scaling + slack transform), got {active.shape}"
                )
        return (func, active, rho), counters

    def step(carry, cur: Iterate, counters: Counters):
        func, active, rho = carry
        fact, counters = _factorize(cfg, func, cur, active, rho, counters)
        dx, dy = cfg.ssdef.solve(fact, func, cur, rho)
        return _result(cfg, cur, dx, dy, active, fact.rcond), carry, counters

    return init, step


def make_newton(cfg: NewtonCfg):
    """Factory keyed on NewtonType (reference ``newton.py:307-323``)."""
    nt = cfg.params.newton_type
    if cfg.ssdef.matrix_free and nt == NewtonType.Globalized:
        raise ValueError(
            "GlobalizedNewton needs the dense residual Jacobian for its "
            "line-search slope; unavailable with a matrix-free step solver"
        )
    if nt == NewtonType.Simplified:
        return _simplified(cfg)
    elif nt == NewtonType.Full:
        return _full(cfg)
    elif nt == NewtonType.ActiveSet:
        return _active_set(cfg)
    elif nt == NewtonType.FixedActiveSet:
        return _fixed_active_set(cfg)
    else:
        assert nt == NewtonType.Globalized
        return _globalized(cfg)
