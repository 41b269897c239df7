"""Primal-dual interior-point solver for the proximal implicit-Euler
subproblem of the Optimizing controller.

The reference hands this subproblem to Ipopt with an L-BFGS Hessian
(``/root/reference/pygradflow/step/opti_control.py:25-249``)::

    min_{x,w}  f(x) + rho/2 ||c(x)||^2 + lamb/2 ||x - xhat||^2
               + 1/2 ||w - sqrt(lamb) yhat||^2
    s.t.       c(x) + sqrt(lamb) w = 0,    lb <= x <= ub

whose optimum is the implicit-Euler step of the augmented Lagrangian
flow; the constraint multiplier nu is the new dual iterate.

This jitted version runs a full primal-dual interior-point
iteration instead (no cyipopt under jit, and no L-BFGS needed — the exact
Hessian comes from autodiff):

- explicit bound duals ``zl, zu >= 0`` with perturbed complementarity
  ``zl (x - lb) = mu``, ``zu (ub - x) = mu`` (infinite bounds masked);
- the free dual block ``w`` and its Newton step are eliminated
  ANALYTICALLY (the w-Hessian is the identity), collapsing each
  iteration to one dense regularized KKT solve of size n+m:

      [H + lamb I + Sigma   J^T] [dx ]   [-r_x]
      [J                -lamb I] [dnu] = [-r_g + sqrt(lamb) r_w]

  with ``H = lag_hess(x, rho c + nu) + rho J^T J`` and
  ``Sigma = zl/(x-lb) + zu/(ub-x)`` — factored by the configured dense
  backend (LDL^T by default, blocked);
- fraction-to-boundary line step, monotone Fiacco-McCormick barrier
  reduction (``mu <- mu/5`` once the inner KKT error drops below mu).

Everything is a ``lax.while_loop`` over fixed shapes: no Python control
flow, vmappable for batched sweeps.
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

IP_MAX_IT = 80
IP_TOL = 1e-8
FTB = 0.995  # fraction-to-boundary
MU_INIT = 1e-1
MU_MIN = 1e-12


class IPResult(NamedTuple):
    x: Any
    nu: Any  # constraint multiplier = new dual iterate
    converged: Any
    iterations: Any


def _sigma_and_barrier(x, lb, ub, zl, zu, mu):
    """Diagonal primal-dual bound term and the barrier contribution to the
    x-gradient, with infinite bounds masked out."""
    has_l = jnp.isfinite(lb)
    has_u = jnp.isfinite(ub)
    sl = jnp.where(has_l, x - lb, 1.0)
    su = jnp.where(has_u, ub - x, 1.0)
    sigma = jnp.where(has_l, zl / sl, 0.0) + jnp.where(has_u, zu / su, 0.0)
    # r_x gets -zl + zu; complementarity residuals target mu
    grad_bnd = -jnp.where(has_l, zl, 0.0) + jnp.where(has_u, zu, 0.0)
    comp = jnp.maximum(
        jnp.max(jnp.where(has_l, jnp.abs(sl * zl - mu), 0.0), initial=0.0),
        jnp.max(jnp.where(has_u, jnp.abs(su * zu - mu), 0.0), initial=0.0),
    )
    return sigma, grad_bnd, comp, (has_l, has_u, sl, su)


def solve_ip(fns, factor_solve, xhat, yhat, lamb, rho, lb, ub,
             tol=IP_TOL, max_it=IP_MAX_IT):
    """Solve the subproblem from the proximal center ``(xhat, yhat)``.

    ``fns``: the problem-function bundle (obj_grad/cons/cons_jac/lag_hess).
    ``factor_solve(K, b) -> x``: dense solver for the reduced KKT matrix.
    Returns :class:`IPResult`; non-convergence is reported, never raised
    (the controller poisons the step so the recovery ladder runs).
    """
    n = xhat.shape[0]
    m = yhat.shape[0]
    dtype = xhat.dtype
    sqrt_l = jnp.sqrt(lamb)

    has_l = jnp.isfinite(lb)
    has_u = jnp.isfinite(ub)

    # strictly interior start near the proximal center
    pad = 1e-4 * jnp.maximum(1.0, jnp.abs(jnp.where(has_l, lb, 0.0)))
    x0 = jnp.clip(
        xhat,
        jnp.where(has_l, lb + pad, -jnp.inf),
        jnp.where(has_u, ub - pad, jnp.inf),
    )
    mu0 = jnp.asarray(MU_INIT, dtype)
    zl0 = jnp.where(has_l, mu0 / jnp.where(has_l, x0 - lb, 1.0), 0.0)
    zu0 = jnp.where(has_u, mu0 / jnp.where(has_u, ub - x0, 1.0), 0.0)
    nu0 = yhat

    # ONE problem-evaluation set (obj_grad, cons, cons_jac) per IP
    # iteration: the set is computed at each accepted point and CARRIED
    # through the loop state — the residuals are mu-independent, so the
    # barrier re-centering and the next iteration's linear system reuse
    # the same evaluations (the controller charges counters accordingly)
    def eval_set(x):
        return dict(cons=fns.cons(x), jac=fns.cons_jac(x), grad=fns.obj_grad(x))

    def residuals(es, x, w, nu, zl, zu):
        """mu-independent KKT residual pieces from a carried eval set."""
        sigma, grad_bnd, _, _ = _sigma_and_barrier(
            x, lb, ub, zl, zu, jnp.zeros((), dtype)
        )
        r_x = (
            es["grad"]
            + rho * (es["jac"].T @ es["cons"])
            + lamb * (x - xhat)
            + es["jac"].T @ nu
            + grad_bnd
        )
        r_w = w - sqrt_l * yhat + sqrt_l * nu
        r_g = es["cons"] + sqrt_l * w
        err_res = jnp.maximum(
            jnp.max(jnp.abs(r_x)),
            jnp.maximum(
                jnp.max(jnp.abs(r_w), initial=0.0),
                jnp.max(jnp.abs(r_g), initial=0.0),
            ),
        )
        return r_x, r_w, r_g, sigma, err_res

    def comp_at(x, zl, zu, mu):
        """Complementarity residual at barrier parameter mu."""
        sl = jnp.where(has_l, x - lb, 1.0)
        su = jnp.where(has_u, ub - x, 1.0)
        return jnp.maximum(
            jnp.max(jnp.where(has_l, jnp.abs(sl * zl - mu), 0.0), initial=0.0),
            jnp.max(jnp.where(has_u, jnp.abs(su * zu - mu), 0.0), initial=0.0),
        )

    es0 = eval_set(x0)
    w0 = -es0["cons"] / jnp.where(sqrt_l == 0.0, 1.0, sqrt_l)

    def body(c):
        x, w, nu, zl, zu, mu = c["x"], c["w"], c["nu"], c["zl"], c["zu"], c["mu"]
        es = c["es"]

        r_x, r_w, r_g, sigma, err_res = residuals(es, x, w, nu, zl, zu)
        cons, jac = es["cons"], es["jac"]
        err = jnp.maximum(err_res, comp_at(x, zl, zu, mu))

        # barrier update: once the inner system is solved to mu accuracy,
        # tighten (monotone Fiacco-McCormick)
        tighten = err <= jnp.maximum(10.0 * mu, tol)
        mu = jnp.where(tighten, jnp.maximum(mu / 5.0, MU_MIN), mu)

        # perturbed-complementarity form of the bound contribution:
        # r_x uses -mu/sl + mu/su after eliminating dzl/dzu
        sl = jnp.where(has_l, x - lb, 1.0)
        su = jnp.where(has_u, ub - x, 1.0)
        r_x_bar = (
            r_x
            + jnp.where(has_l, zl, 0.0)
            - jnp.where(has_u, zu, 0.0)
            - jnp.where(has_l, mu / sl, 0.0)
            + jnp.where(has_u, mu / su, 0.0)
        )

        H = fns.lag_hess(x, rho * cons + nu)
        K11 = (
            H
            + rho * (jac.T @ jac)
            + jnp.diag(lamb + sigma)
        )
        K = jnp.block(
            [
                [K11, jac.T],
                [jac, -lamb * jnp.eye(m, dtype=dtype)],
            ]
        )
        rhs = jnp.concatenate([-r_x_bar, -(r_g - sqrt_l * r_w)])
        sol = factor_solve(K, rhs)
        dx = sol[:n]
        dnu = sol[n:]
        dw = -r_w - sqrt_l * dnu

        # bound-dual steps from linearized complementarity
        dzl = jnp.where(has_l, (mu - zl * dx) / sl - zl, 0.0)
        dzu = jnp.where(has_u, (mu + zu * dx) / su - zu, 0.0)

        # fraction-to-boundary for primal slacks and duals
        def max_step(v, dv, mask):
            neg = jnp.logical_and(mask, dv < 0.0)
            ratio = jnp.where(neg, -FTB * v / jnp.where(neg, dv, -1.0), jnp.inf)
            return jnp.min(ratio, initial=1.0)

        a_p = jnp.minimum(max_step(sl, dx, has_l), max_step(su, -dx, has_u))
        a_d = jnp.minimum(max_step(zl, dzl, has_l), max_step(zu, dzu, has_u))
        a_p = jnp.minimum(a_p, 1.0)
        a_d = jnp.minimum(a_d, 1.0)

        # non-finite step (singular KKT): keep the point, the stall is
        # reported as non-convergence
        finite = jnp.all(jnp.isfinite(sol))
        a_p = jnp.where(finite, a_p, 0.0)
        a_d = jnp.where(finite, a_d, 0.0)

        x_n = x + a_p * dx
        w_n = w + a_p * dw
        nu_n = nu + a_p * dnu
        zl_n = jnp.where(has_l, jnp.maximum(zl + a_d * dzl, MU_MIN), 0.0)
        zu_n = jnp.where(has_u, jnp.maximum(zu + a_d * dzu, MU_MIN), 0.0)

        es_n = eval_set(x_n)
        _, _, _, _, err_res_n = residuals(es_n, x_n, w_n, nu_n, zl_n, zu_n)
        err_n = jnp.maximum(err_res_n, comp_at(x_n, zl_n, zu_n, jnp.zeros_like(mu)))
        return dict(
            x=x_n, w=w_n, nu=nu_n, zl=zl_n, zu=zu_n, mu=mu, es=es_n,
            err=err_n, i=c["i"] + 1, stalled=jnp.logical_not(finite),
        )

    def cond(c):
        return jnp.logical_and(
            c["i"] < max_it,
            jnp.logical_and(c["err"] > tol, jnp.logical_not(c["stalled"])),
        )

    _, _, _, _, err_res0 = residuals(es0, x0, w0, nu0, zl0, zu0)
    err0 = jnp.maximum(err_res0, comp_at(x0, zl0, zu0, jnp.zeros_like(mu0)))
    init = dict(
        x=x0, w=w0, nu=nu0, zl=zl0, zu=zu0, mu=mu0, es=es0,
        err=err0, i=jnp.zeros((), jnp.int32),
        stalled=jnp.zeros((), bool),
    )
    out = jax.lax.while_loop(cond, body, init)

    return IPResult(
        x=out["x"],
        nu=out["nu"],
        converged=out["err"] <= tol,
        iterations=out["i"],
    )
