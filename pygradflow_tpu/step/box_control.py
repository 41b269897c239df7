"""Box-reduced step controller.

Counterpart of the reference BoxReducedController
(``pygradflow/step/box_control.py``): eliminates the duals from the
proximally regularized implicit-Euler subproblem, leaving the
box-constrained problem

.. math::
    \\min_x f(x) + \\tfrac{\\rho}{2}\\|c(x)\\|^2 + \\tfrac{\\lambda}{2}
    (\\|x - \\hat x\\|^2 + \\|-c(x)/\\lambda - \\hat y\\|^2)
    \\quad \\text{s.t.} \\; l^x \\le x \\le u^x

solved with the projected-Newton box solver, then recovers
``y = yhat + c(x)/lambda`` and accepts iff the implicit-function residual
is below 1e-6 (halving lambda), else rejects doubling lambda.

The reference offers three interchangeable inner solvers (Ipopt, scipy
TNC — noted unreliable in the reference, ``box_control.py:271-274`` — and
the projected-Newton solver it actually uses); here the projected-Newton
path stands in for all three.  The Ipopt-based ``OptimizingController``
(reference ``opti_control.py``), which solves the same subproblem in
primal-dual form, has its own independent counterpart here: the jitted
primal-dual interior-point method of ``step/ip_solver.py``.
"""

import jax.numpy as jnp

from .. import implicit_func as impl
from ..eval import Counters
from ..iterate import Iterate, evaluate_iterate, iterate_eval_counts
from .box_solver import BOX_OPTIMAL, BOX_UNBOUNDED, solve_box_constrained
from .control import ControlCfg, ControlResult


def make_box_reduced(cfg: ControlCfg):
    params = cfg.params
    fns = cfg.fns
    lb, ub = cfg.lb, cfg.ub
    n = fns.num_vars

    def objective(orig: Iterate, x, lamb, rho):
        obj = fns.obj(x)
        cons = fns.cons(x)
        dx = x - orig.x
        w = -cons / lamb
        dy = w - orig.y
        return (
            obj
            + 0.5 * rho * jnp.dot(cons, cons)
            + 0.5 * lamb * (jnp.dot(dx, dx) + jnp.dot(dy, dy))
        )

    def gradient(orig: Iterate, x, lamb, rho):
        g = fns.obj_grad(x)
        cons = fns.cons(x)
        jac = fns.cons_jac(x)
        dx = x - orig.x
        factor = (rho + 1.0 / lamb) * cons + orig.y
        return g + lamb * dx + jac.T @ factor

    def hessian(orig: Iterate, x, lamb, rho):
        cons = fns.cons(x)
        jac = fns.cons_jac(x)
        cons_factor = 1.0 / lamb + rho
        y = cons_factor * cons + orig.y
        H = fns.lag_hess(x, y)
        return H + lamb * jnp.eye(n, dtype=H.dtype) + cons_factor * (jac.T @ jac)

    def step(orig: Iterate, lamb, rho, error_sum, counters: Counters):
        result = solve_box_constrained(
            orig.x,
            lambda x: objective(orig, x, lamb, rho),
            lambda x: gradient(orig, x, lamb, rho),
            lambda x: hessian(orig, x, lamb, rho),
            lb,
            ub,
            obj_lower=params.obj_lower_limit,
        )

        # solver failure -> poison x so compute_step rejects
        # (unbounded subproblem results are used as-is, box_control.py:246-249)
        solver_ok = jnp.logical_or(
            result.status == BOX_OPTIMAL, result.status == BOX_UNBOUNDED
        )
        x = jnp.where(solver_ok, result.x, jnp.full_like(result.x, jnp.nan))

        # recover duals: y = yhat + c(x)/lambda (box_control.py:277-281)
        cons = fns.cons(x)
        w = -cons / lamb
        y = orig.y - w

        next_it = evaluate_iterate(fns, x, y)
        counters = counters.add(**iterate_eval_counts(cfg.m))

        func = impl.make_step_func(orig, lamb, lb, ub, scaled=False)
        residuum = impl.value_norm(func, next_it, rho)

        accepted = residuum <= 1e-6
        lamb_n = jnp.where(accepted, 0.5 * lamb, 2.0 * lamb)

        active = impl.compute_active_set(func, next_it, rho)
        # no KKT factorization in the box-reduced path: no rcond estimate
        rcond = jnp.full_like(lamb_n, jnp.nan)
        return ControlResult(
            next_it,
            lamb_n,
            accepted,
            error_sum,
            active,
            counters,
            rcond,
            (next_it.x, next_it.y),
        )

    return step
