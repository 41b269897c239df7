"""Linear-solver backends for the KKT systems.

JAX replacements for the reference's native-library zoo
(``pygradflow/linear_solver/``: SuperLU, CHOLMOD, MA57, MUMPS, SSIDS,
MINRES, GMRES).  Every backend here is a pure-JAX dense solver
with the same three-operation interface: factorize, (transpose-)solve, and
inertia query (``num_neg_eigvals``, reference
``linear_solver/linear_solver.py:18-31``).

Error handling differs by necessity: native factorizations raise
``LinearSolverError`` on breakdown; under jit a singular factorization
produces non-finite values in the solution instead, which the step layer
detects and converts into a rejected step (the same recovery ladder as the
reference's ``StepSolverError`` path).
"""

from typing import Any, Callable, NamedTuple, Optional

import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..params import LinearSolverType


class LinearSolverError(Exception):
    """Raised eagerly for unsupported configurations (not inside jit)."""


class LinearSolver(NamedTuple):
    """Bundle of factor/solve closures for one backend (static dispatch)."""

    factor: Callable[[Any], Any]
    solve: Callable[..., Any]  # (fact, rhs, initial_sol=None) -> sol
    solve_trans: Callable[[Any, Any], Any]
    num_neg_eigvals: Optional[Callable[[Any], Any]]
    name: str


# ----------------------------------------------------------------------
# Dense LU (maps reference LUSolver / SuperLU, lu_solver.py): a pure-JAX
# partial-pivot LU in the working precision (f64 by default).
# ----------------------------------------------------------------------

from .plu import plu_factor, plu_solve, plu_solve_trans  # noqa: E402


def _lu() -> LinearSolver:
    def factor(mat):
        return plu_factor(mat)

    def solve(fact, rhs, initial_sol=None):
        return plu_solve(fact, rhs)

    def solve_trans(fact, rhs):
        return plu_solve_trans(fact, rhs)

    return LinearSolver(factor, solve, solve_trans, None, "lu")


# ----------------------------------------------------------------------
# Dense Cholesky (maps CHOLMOD, cholesky_solver.py; posdef only — a
# non-posdef matrix yields NaNs -> rejected step)
# ----------------------------------------------------------------------


def _cholesky() -> LinearSolver:
    def factor(mat):
        return jsl.cho_factor(mat)

    def solve(fact, rhs, initial_sol=None):
        return jsl.cho_solve(fact, rhs)

    def num_neg(fact):
        return jnp.zeros((), dtype=jnp.int32)

    return LinearSolver(factor, solve, solve, num_neg, "cholesky")


# ----------------------------------------------------------------------
# Dense LDL^T with inertia (maps MA57/MUMPS/SSIDS indefinite solvers).
# ----------------------------------------------------------------------

from .blocked_ldlt import ldlt_factor_blocked  # noqa: E402
from .ldlt import ldlt_factor, ldlt_num_neg_eigvals, ldlt_solve  # noqa: E402

# above this size the blocked (GEMM trailing-update) factorization takes
# over from the unblocked rank-1 sweep; chosen on the earlier accelerator,
# not yet re-derived on the GPU
LDLT_BLOCKED_MIN_N = 192


def _ldlt() -> LinearSolver:
    def factor(mat):
        if mat.shape[-1] > LDLT_BLOCKED_MIN_N and mat.ndim == 2:
            return ldlt_factor_blocked(mat)
        return ldlt_factor(mat)

    def solve(fact, rhs, initial_sol=None):
        return ldlt_solve(fact, rhs)

    return LinearSolver(factor, solve, solve, ldlt_num_neg_eigvals, "ldlt")


def _pallas_ldlt() -> LinearSolver:
    """Mixed-precision tier (``LinearSolverType.PallasLDLT``, name kept for
    existing configurations): plain-XLA f32 LDL^T factor + f64 iterative
    refinement + inertia from the f32 pivots (``mixed_ldlt.py``).  Every
    f32 product is traced at full precision (``jit.full_f32``)."""
    from ..jit import full_f32
    from .mixed_ldlt import ldlt_factor_f32, refine_solve

    @full_f32
    def factor(mat):
        return (ldlt_factor_f32(mat), mat)

    @full_f32
    def solve(fact, rhs, initial_sol=None, iters=3):
        """``iters=0`` skips the f64 refinement (raw f32 back-solve) —
        for callers that run their OWN outer refinement around this
        solve (e.g. the mixed-precision Schur saddle refinement), where
        the inner passes are redundant work."""
        packed, mat = fact
        return refine_solve(packed, mat, rhs, iters=iters)

    def num_neg(fact):
        packed, _ = fact
        return ldlt_num_neg_eigvals(packed)

    return LinearSolver(factor, solve, solve, num_neg, "pallas_ldlt")


# ----------------------------------------------------------------------
# Iterative solvers (map minres_solver.py / gmres_solver.py)
# ----------------------------------------------------------------------

from .minres import minres  # noqa: E402


def _minres() -> LinearSolver:
    def factor(mat):
        return mat

    def solve(mat, rhs, initial_sol=None):
        return minres(mat, rhs, x0=initial_sol)

    return LinearSolver(factor, solve, solve, None, "minres")


def _gmres() -> LinearSolver:
    import inspect

    import jax.scipy.sparse.linalg as spla

    # jax renamed ``tol=`` to ``rtol=`` (scipy 1.14 alignment); pick
    # whichever this version exposes instead of pinning the deprecated name
    tol_kw = (
        "rtol"
        if "rtol" in inspect.signature(spla.gmres).parameters
        else "tol"
    )
    kwargs = {tol_kw: 1e-12, "atol": 1e-12, "solve_method": "batched"}

    def factor(mat):
        return mat

    def solve(mat, rhs, initial_sol=None):
        sol, _ = spla.gmres(lambda v: mat @ v, rhs, x0=initial_sol, **kwargs)
        return sol

    def solve_trans(mat, rhs):
        sol, _ = spla.gmres(lambda v: mat.T @ v, rhs, **kwargs)
        return sol

    return LinearSolver(factor, solve, solve_trans, None, "gmres")


def linear_solver(
    solver_type: LinearSolverType, symmetric: bool = False
) -> LinearSolver:
    """Factory keyed on ``LinearSolverType``
    (reference ``linear_solver/__init__.py:8-39``)."""
    if solver_type == LinearSolverType.LU:
        return _lu()
    elif solver_type == LinearSolverType.Cholesky:
        return _cholesky()
    elif solver_type == LinearSolverType.LDLT:
        return _ldlt()
    elif solver_type == LinearSolverType.PallasLDLT:
        return _pallas_ldlt()
    elif solver_type == LinearSolverType.MINRES:
        if not symmetric:
            raise LinearSolverError("MINRES requires a symmetric matrix")
        return _minres()
    elif solver_type == LinearSolverType.GMRES:
        return _gmres()

    raise LinearSolverError(f"Unknown linear solver type {solver_type}")
