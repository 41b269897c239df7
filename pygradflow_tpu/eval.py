"""Evaluation layer: dtype casting, counters, validation.

Counterpart of the reference ``Evaluator`` stack (``pygradflow/eval.py``).
Because evaluations run inside jit, per-component counters are a small int32
pytree carried through the solver loop state instead of Python-side mutable
dicts, and validation cannot raise mid-loop: non-finite evaluations surface
as rejected steps (mirroring the reference's EvalError -> reject-with-
doubled-lambda recovery, ``pygradflow/step/step_control.py:79-107``), while
shape validation and initial-point finiteness checks run eagerly at setup.
"""

from enum import Enum, auto
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .jit import jit
from .params import Params
from .problem import Problem


class EvalError(ValueError):
    def __init__(self, msg, x=None):
        self.x = x
        super().__init__(msg)


class Component(Enum):
    Obj = auto()
    ObjGrad = auto()
    Cons = auto()
    ConsJac = auto()
    LagHess = auto()

    def name(self):
        return {
            Component.Obj: "Objective",
            Component.ObjGrad: "Objective Gradient",
            Component.Cons: "Constraints",
            Component.ConsJac: "Constraint Jacobian",
            Component.LagHess: "Lagrangian Hessian",
        }[self]


class Counters(NamedTuple):
    """Per-component evaluation counters (reference ``eval.py:60-85``)."""

    obj: Any
    obj_grad: Any
    cons: Any
    cons_jac: Any
    lag_hess: Any

    @staticmethod
    def zero():
        z = jnp.zeros((), dtype=jnp.int32)
        return Counters(z, z, z, z, z)

    def add(self, *, obj=0, obj_grad=0, cons=0, cons_jac=0, lag_hess=0):
        return Counters(
            self.obj + obj,
            self.obj_grad + obj_grad,
            self.cons + cons,
            self.cons_jac + cons_jac,
            self.lag_hess + lag_hess,
        )

    def as_dict(self):
        return {
            Component.Obj: int(self.obj),
            Component.ObjGrad: int(self.obj_grad),
            Component.Cons: int(self.cons),
            Component.ConsJac: int(self.cons_jac),
            Component.LagHess: int(self.lag_hess),
        }


def _is_parametric(problem) -> bool:
    """Walk transform wrappers down to the user problem."""
    seen = set()
    while id(problem) not in seen:
        seen.add(id(problem))
        if getattr(problem, "_parametric", False):
            return True
        problem = getattr(problem, "problem", problem)
    return False


class Fns(NamedTuple):
    """dtype-cast JAX evaluation closures for a (transformed) problem."""

    obj: Callable
    obj_grad: Callable
    cons: Callable
    cons_jac: Callable
    lag_hess: Callable
    num_vars: int
    num_cons: int
    # matrix-free products (J^T w, J v, H v) — autodiff, never build (m, n)
    cons_vjp: Callable = None
    cons_jvp: Callable = None
    lag_hvp: Callable = None
    # Params.matrix_free: residual helpers route J^T products through
    # cons_vjp instead of reading the materialized iterate Jacobian (the
    # unused cons_jac evaluation is then dead-code-eliminated by XLA)
    matrix_free: bool = False


def make_fns(problem: Problem, params: Params) -> Fns:
    """Build jitted evaluation closures.

    Each closure is wrapped in ``jax.jit``: inside the solver loop jit
    inlines them for free, while *eager* callers (tests, finite-difference
    checks, the derivative checker) get cached compilations instead of a
    fresh ``jax.grad`` re-trace per call.

    Exception: parametric problems (per-instance data bound at trace time,
    ``parallel/batch.py``) must stay unjitted — a jitted closure would
    capture the vmapped data tracer across a jit boundary.
    """
    dtype = params.dtype
    n = problem.num_vars
    m = problem.num_cons

    maybe_jit = (lambda f: f) if _is_parametric(problem) else jit

    @maybe_jit
    def obj(x):
        return jnp.asarray(problem.obj(x), dtype=dtype)

    @maybe_jit
    def obj_grad(x):
        return jnp.asarray(problem.obj_grad(x), dtype=dtype)

    if m > 0:

        @maybe_jit
        def cons(x):
            return jnp.asarray(problem.cons(x), dtype=dtype)

        @maybe_jit
        def cons_jac(x):
            return jnp.asarray(problem.cons_jac(x), dtype=dtype)

    else:
        # derive the empty arrays from x (not fresh constants) so they
        # carry x's device-varying type under shard_map

        @maybe_jit
        def cons(x):
            return x[:0].astype(dtype)

        @maybe_jit
        def cons_jac(x):
            return (x[:0, None] * x[None, :]).astype(dtype)

    @maybe_jit
    def lag_hess(x, y):
        return jnp.asarray(problem.lag_hess(x, y), dtype=dtype)

    if m > 0:

        @maybe_jit
        def cons_vjp(x, w):
            return jnp.asarray(problem.cons_vjp(x, w), dtype=dtype)

        @maybe_jit
        def cons_jvp(x, v):
            return jnp.asarray(problem.cons_jvp(x, v), dtype=dtype)

    else:

        @maybe_jit
        def cons_vjp(x, w):
            return jnp.zeros_like(x, dtype=dtype)

        @maybe_jit
        def cons_jvp(x, v):
            return x[:0].astype(dtype)

    @maybe_jit
    def lag_hvp(x, y, v):
        return jnp.asarray(problem.lag_hvp(x, y, v), dtype=dtype)

    return Fns(
        obj, obj_grad, cons, cons_jac, lag_hess, n, m,
        cons_vjp=cons_vjp,
        cons_jvp=cons_jvp,
        lag_hvp=lag_hvp,
        matrix_free=getattr(params, "matrix_free", False),
    )


def validate_fns(fns: Fns, x0, y0) -> None:
    """Eager validation of shapes and finiteness at the initial point.

    Raises :class:`EvalError` like the reference ValidatingEvaluator
    (``eval.py:130-211``) / Solver init check (``solver.py:267-270``).
    """
    n, m = fns.num_vars, fns.num_cons

    obj = fns.obj(x0)
    if not np.isfinite(np.asarray(obj)):
        raise EvalError("Infinite objective", x0)

    grad = np.asarray(fns.obj_grad(x0))
    if grad.shape != (n,):
        raise EvalError("Invalid shape of gradient", x0)
    if not np.isfinite(grad).all():
        raise EvalError("Non-finite gradient", x0)

    if m > 0:
        cons = np.asarray(fns.cons(x0))
        if cons.shape != (m,):
            raise EvalError("Invalid shape of constraints", x0)
        if not np.isfinite(cons).all():
            raise EvalError("Non-finite constraints", x0)

        jac = np.asarray(fns.cons_jac(x0))
        if jac.shape != (m, n):
            raise EvalError("Invalid shape of Jacobian", x0)
        if not np.isfinite(jac).all():
            raise EvalError("Non-finite Jacobian", x0)

    hess = np.asarray(fns.lag_hess(x0, y0))
    if hess.shape != (n, n):
        raise EvalError("Invalid shape of Hessian", x0)
    if not np.isfinite(hess).all():
        raise EvalError("Non-finite Hessian", x0)

    if not np.allclose(hess, hess.T):
        from .log import logger

        logger.warning("Hessian not numerically symmetric")


def diagnose_eval_failure(fns: Fns, x, y):
    """Name the user callback that produced non-finite values at ``(x, y)``.

    Host-side replay used by the driver's debug diagnostics (reference
    ValidatingEvaluator raises per call, ``eval.py:130-211``; under jit the
    failure surfaces later as a rejected candidate, so the driver replays
    the recorded point eagerly).  Returns the failing :class:`Component`,
    or ``None`` when every evaluation is finite — which means the
    candidate itself was non-finite, i.e. a singular KKT factorization
    (StepSolverError in the reference), not an evaluation error.
    """
    x = np.asarray(x)
    y = np.asarray(y)
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        return None  # factorization breakdown, not a user-eval failure

    checks = [
        (Component.Obj, lambda: fns.obj(x)),
        (Component.ObjGrad, lambda: fns.obj_grad(x)),
    ]
    if fns.num_cons > 0:
        checks += [
            (Component.Cons, lambda: fns.cons(x)),
            (Component.ConsJac, lambda: fns.cons_jac(x)),
        ]
    checks.append((Component.LagHess, lambda: fns.lag_hess(x, y)))

    for component, evaluate in checks:
        if not np.isfinite(np.asarray(evaluate())).all():
            return component
    return None
