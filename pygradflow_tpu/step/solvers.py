"""Step solvers: KKT-system assembly and solve for one semismooth Newton step.

Counterparts of the reference's four step solvers
(``pygradflow/step/solver/``), re-designed for static shapes: "reduction" to
the inactive variables is realized by substituting identity rows/columns
(the reference's own Asymmetric in-place trick,
``asymmetric_step_solver.py:38-104``) rather than slicing, so every
formulation assembles a dense ``(n+m, n+m)`` system with static shape,
batchable under vmap.

Formulations (lambda = 1/dt, fact = 1/(1 + lambda*rho)):

- Standard (``standard_step_solver.py``): unscaled residual Jacobian
  ``[[I + dt P'H_rho, dt P'J^T], [-dt J, I]]`` where ``H_rho`` is the full
  augmented Hessian.
- Asymmetric (``asymmetric_step_solver.py``): scaled system
  ``[[H + lambda I, J^T], [J, -lambda*fact I]]`` with identity rows
  substituted for active variables; ``H`` is the plain Lagrangian Hessian
  (rho terms handled analytically through the dual rescaling
  ``dy = fact*(sy - rho*ry)``, ``scaled_step_solver.py:85-107``).
- Symmetric (``symmetric_step_solver.py``): same system with active rows
  *and columns* replaced by identity (rhs condensed accordingly), keeping
  the matrix symmetric for LDL^T/MINRES and the inertia test
  (expected ``m`` negative eigenvalues).
- Extended (``extended_step_solver.py``): in the reference a row-permuted
  sparsity-friendlier version of Asymmetric; dense row permutations do not
  change anything XLA sees, so it shares the Asymmetric assembly here.
"""

from typing import Any, NamedTuple

import jax.numpy as jnp

from .. import implicit_func as impl
from ..iterate import Iterate
from ..linalg import LinearSolver, linear_solver
from ..params import Params, StepSolverType
from ..util import norm_mult


class StepResult(NamedTuple):
    """One Newton step, with the primal update clipped into the box
    (reference ``step/solver/step_solver.py:16-63``)."""

    xn: Any
    yn: Any
    dx: Any
    dy: Any
    diff: Any
    active_set: Any
    rcond: Any  # estimated reciprocal condition number (NaN when disabled)


def make_step_result(it: Iterate, dx, dy, lb, ub, active_set, rcond=None) -> StepResult:
    xn = it.x - dx
    at_lb = xn < lb
    at_ub = xn > ub
    xn = jnp.clip(xn, lb, ub)
    dxc = jnp.where(at_lb, it.x - lb, jnp.where(at_ub, it.x - ub, dx))
    yn = it.y - dy
    if rcond is None:
        rcond = jnp.full((), jnp.nan, dtype=xn.dtype)
    return StepResult(
        xn=xn,
        yn=yn,
        dx=dxc,
        dy=dy,
        diff=norm_mult(dxc, dy),
        active_set=active_set,
        rcond=rcond,
    )


class Factorization(NamedTuple):
    """Assembled + factorized KKT system plus what the rhs path needs."""

    fact: Any  # linear-solver factorization pytree
    active: Any  # bool (n,)
    hess_shifted: Any  # H + lambda I (scaled solvers) for rhs condensation
    jac: Any
    inertia_ok: Any  # scalar bool; False forces NaN -> step rejection
    rcond: Any  # Dixon rcond estimate (NaN when params.report_rcond off)


class StepSolverDef(NamedTuple):
    """Static definition: closures assembling/factoring/solving one
    formulation.  ``scaled`` selects which implicit function the Newton
    layer builds."""

    scaled: bool
    symmetric: bool
    hess_rho_is_runtime: bool  # Standard evaluates H at the runtime rho
    factor: Any  # (func, H, J, active, rho) -> Factorization
    solve: Any  # (factorization, func, cur_it, rho) -> (dx, dy)
    # matrix-free defs take (func, iterate, active, rho) in factor and
    # derive blocks via jvp/vjp/hvp probes (step/schur_staged.py)
    matrix_free: bool = False


def _lower_block(m, lamb, rho, dtype):
    fact = 1.0 / (1.0 + lamb * rho)
    return -(lamb * fact) * jnp.eye(m, dtype=dtype)


def _maybe_rcond(lin: LinearSolver, report: bool, mat, fact):
    """Dixon rcond estimate of the assembled system when requested
    (reference ``step/solver/step_solver.py:100-112``)."""
    if not report:
        return jnp.full((), jnp.nan, dtype=mat.dtype)
    from .cond_estimate import estimate_rcond

    return estimate_rcond(
        mat,
        lambda r: lin.solve(fact, r),
        lambda r: lin.solve_trans(fact, r),
    )


def step_solver_def(params: Params, fns=None) -> StepSolverDef:
    # custom step-solver injection (reference params.step_solver,
    # tests/.../test_solver.py:43-76): a callable params -> StepSolverDef
    if params.step_solver is not None:
        return params.step_solver(params)

    solver_type = params.step_solver_type

    if params.matrix_free and solver_type != StepSolverType.Schur:
        raise ValueError(
            "matrix_free requires StepSolverType.Schur (the other "
            "formulations assemble the dense KKT system)"
        )

    if solver_type == StepSolverType.Schur:
        from .schur import schur_def

        assert params.schur_block_size is not None, (
            "StepSolverType.Schur requires params.schur_block_size"
        )
        from ..params import LinearSolverType

        schur_lin = (
            linear_solver(params.linear_solver_type, symmetric=True)
            if params.linear_solver_type == LinearSolverType.PallasLDLT
            else None
        )
        if params.matrix_free:
            from .schur_staged import schur_staged_def

            assert params.schur_dual_block_size is not None, (
                "matrix_free Schur requires params.schur_dual_block_size "
                "(stage-local constraints)"
            )
            assert fns is not None
            return schur_staged_def(
                schur_lin,
                fns,
                params.schur_block_size,
                dual_block=params.schur_dual_block_size,
            )
        return schur_def(
            schur_lin,
            params.report_rcond,
            params.schur_block_size,
            dual_block=params.schur_dual_block_size,
        )

    lin: LinearSolver = linear_solver(
        params.linear_solver_type,
        symmetric=(solver_type == StepSolverType.Symmetric),
    )
    inertia_correction = params.inertia_correction
    report_rcond = params.report_rcond

    if solver_type == StepSolverType.Standard:
        return _standard_def(lin, report_rcond)
    elif solver_type == StepSolverType.Symmetric:
        return _symmetric_def(lin, inertia_correction, report_rcond)
    else:
        # Asymmetric and Extended share the dense assembly (see module doc)
        return _asymmetric_def(lin, report_rcond)


# ----------------------------------------------------------------------
# Standard (unscaled) formulation
# ----------------------------------------------------------------------


def _standard_def(lin: LinearSolver, report_rcond: bool) -> StepSolverDef:
    def factor(func: impl.StepFunc, H, J, active, rho):
        mat = impl.deriv(func, J, H, active)
        fact = lin.factor(mat)
        return Factorization(
            fact=fact,
            active=active,
            hess_shifted=H,
            jac=J,
            inertia_ok=jnp.array(True),
            rcond=_maybe_rcond(lin, report_rcond, mat, fact),
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        rx, ry = impl.value_at(func, it, rho, f.active)
        rhs = jnp.concatenate([rx, ry])
        sol = lin.solve(f.fact, rhs)
        n = rx.shape[0]
        return sol[:n], sol[n:]

    return StepSolverDef(
        scaled=False,
        symmetric=False,
        hess_rho_is_runtime=True,
        factor=factor,
        solve=solve,
    )


# ----------------------------------------------------------------------
# Asymmetric (scaled) formulation — the jit-natural default shape
# ----------------------------------------------------------------------


def _asymmetric_def(lin: LinearSolver, report_rcond: bool) -> StepSolverDef:
    def factor(func: impl.StepFunc, H, J, active, rho):
        lamb = func.lamb
        n = H.shape[0]
        m = J.shape[0]
        dtype = H.dtype

        Hl = H + lamb * jnp.eye(n, dtype=dtype)
        eye_n = jnp.eye(n, dtype=dtype)
        act_col = active[:, None]

        M11 = jnp.where(act_col, eye_n, Hl)
        M12 = jnp.where(act_col, 0.0, J.T)
        M22 = _lower_block(m, lamb, rho, dtype)

        top = jnp.concatenate([M11, M12], axis=1)
        bot = jnp.concatenate([J, M22], axis=1)
        mat = jnp.concatenate([top, bot], axis=0)

        fact = lin.factor(mat)
        return Factorization(
            fact=fact,
            active=active,
            hess_shifted=Hl,
            jac=J,
            inertia_ok=jnp.array(True),
            rcond=_maybe_rcond(lin, report_rcond, mat, fact),
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        lamb = func.lamb
        dt = 1.0 / lamb
        pfact = 1.0 / (1.0 + lamb * rho)

        rx, ry = impl.value_at(func, it, rho, f.active)
        n = rx.shape[0]

        var_rhs = jnp.where(f.active, dt * rx, rx)
        rhs = jnp.concatenate([var_rhs, pfact * ry])

        sol0 = jnp.concatenate(
            [jnp.where(f.active, dt * rx, 0.0), jnp.zeros_like(ry)]
        )
        sol = lin.solve(f.fact, rhs, initial_sol=sol0)

        dx = sol[:n]
        dy = pfact * (sol[n:] - rho * ry)
        return dx, dy

    return StepSolverDef(
        scaled=True,
        symmetric=False,
        hess_rho_is_runtime=False,
        factor=factor,
        solve=solve,
    )


# ----------------------------------------------------------------------
# Symmetric (scaled) formulation with inertia correction
# ----------------------------------------------------------------------


def _symmetric_def(
    lin: LinearSolver, inertia_correction: bool, report_rcond: bool
) -> StepSolverDef:
    def factor(func: impl.StepFunc, H, J, active, rho):
        lamb = func.lamb
        n = H.shape[0]
        m = J.shape[0]
        dtype = H.dtype

        Hl = H + lamb * jnp.eye(n, dtype=dtype)
        inact = jnp.logical_not(active)
        both_inact = jnp.logical_and(inact[:, None], inact[None, :])

        M11 = jnp.where(both_inact, Hl, 0.0) + jnp.diag(active.astype(dtype))
        M12 = jnp.where(inact[:, None], J.T, 0.0)
        M22 = _lower_block(m, lamb, rho, dtype)

        top = jnp.concatenate([M11, M12], axis=1)
        bot = jnp.concatenate([M12.T, M22], axis=1)
        mat = jnp.concatenate([top, bot], axis=0)

        fact = lin.factor(mat)

        inertia_ok = jnp.array(True)
        if inertia_correction:
            if lin.num_neg_eigvals is None:
                raise ValueError(
                    "Inertia correction requested but linear solver "
                    f"'{lin.name}' provides no inertia"
                )
            # expect exactly m negative eigenvalues
            # (reference symmetric_step_solver.py:146-153)
            inertia_ok = lin.num_neg_eigvals(fact) == m

        return Factorization(
            fact=fact,
            active=active,
            hess_shifted=Hl,
            jac=J,
            inertia_ok=inertia_ok,
            rcond=_maybe_rcond(lin, report_rcond, mat, fact),
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        lamb = func.lamb
        dt = 1.0 / lamb
        pfact = 1.0 / (1.0 + lamb * rho)

        rx, ry = impl.value_at(func, it, rho, f.active)
        n = rx.shape[0]

        b0_full = jnp.where(f.active, dt * rx, 0.0)
        # condensed rhs (reference symmetric_step_solver.py:79-94)
        rhs_x = jnp.where(f.active, b0_full, rx - f.hess_shifted @ b0_full)
        rhs_y = pfact * ry - f.jac @ b0_full
        rhs = jnp.concatenate([rhs_x, rhs_y])

        sol = lin.solve(f.fact, rhs)

        dx = sol[:n]
        dy = pfact * (sol[n:] - rho * ry)

        # failed inertia test -> force rejection via non-finite step
        nan = jnp.full_like(dx, jnp.nan)
        dx = jnp.where(f.inertia_ok, dx, nan)
        return dx, dy

    return StepSolverDef(
        scaled=True,
        symmetric=True,
        hess_rho_is_runtime=False,
        factor=factor,
        solve=solve,
    )
