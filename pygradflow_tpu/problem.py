"""User-facing problem definition.

The reference requires users to hand-code ``obj_grad``, ``cons_jac`` and
``lag_hess`` callbacks (``pygradflow/problem.py:112-192``).  Here derivatives
come from autodiff: a subclass only defines ``obj(x)`` (and optionally
``cons(x)``) as JAX-traceable functions; gradients, Jacobians and Lagrangian
Hessians are derived with ``jax.grad`` / ``jax.jacfwd``.  Hand-written
derivative methods still override the autodiff defaults (escape hatch).

All linear algebra is dense: the KKT systems are solved as dense
blocked systems, so Jacobians/Hessians are dense ``(m, n)`` /
``(n, n)`` arrays rather than scipy sparse matrices.
"""

import abc

import jax
import jax.numpy as jnp
import numpy as np


class Problem(abc.ABC):
    """Nonlinear program

    .. math::
        \\min f(x) \\quad \\text{s.t.} \\quad l \\le c(x) \\le u, \\;
        l^x \\le x \\le u^x

    Mirrors the constructor semantics of the reference Problem ABC
    (``pygradflow/problem.py:32-110``): pass ``cons_lb``/``cons_ub`` for
    general constraint bounds, or ``num_cons`` for pure equality
    constraints ``c(x) = 0``.
    """

    _parametric = False
    """Set by ParametricProblem: evaluations read per-instance data bound at
    trace time, so evaluation closures must not be individually jitted."""

    def __init__(self, var_lb, var_ub, **args) -> None:
        var_lb = np.asarray(var_lb, dtype=np.float64)
        var_ub = np.asarray(var_ub, dtype=np.float64)

        assert var_lb.shape == var_ub.shape
        assert var_lb.ndim == 1
        assert (var_lb <= var_ub).all()
        assert (var_lb < np.inf).all()
        assert (var_ub > -np.inf).all()

        self.var_lb = var_lb
        self.var_ub = var_ub

        num_cons = args.get("num_cons", None)
        cons_lb = args.get("cons_lb", None)
        cons_ub = args.get("cons_ub", None)

        if cons_lb is not None or cons_ub is not None:
            assert num_cons is None

            if cons_lb is not None:
                cons_lb = np.asarray(cons_lb, dtype=np.float64)
                (num_cons,) = cons_lb.shape
            else:
                cons_ub = np.asarray(cons_ub, dtype=np.float64)
                (num_cons,) = cons_ub.shape

            if cons_lb is None:
                cons_lb = np.zeros((num_cons,))
            if cons_ub is None:
                cons_ub = np.zeros((num_cons,))

            cons_lb = np.asarray(cons_lb, dtype=np.float64)
            cons_ub = np.asarray(cons_ub, dtype=np.float64)

            assert (cons_lb <= cons_ub).all()
            assert (cons_lb < np.inf).all()
            assert (cons_ub > -np.inf).all()
        else:
            if num_cons is None:
                num_cons = 0
            cons_lb = np.zeros((num_cons,))
            cons_ub = np.zeros((num_cons,))

        self.num_cons = int(num_cons)
        self.cons_lb = cons_lb
        self.cons_ub = cons_ub

    @property
    def var_bounded(self) -> bool:
        """Whether any variable bound is finite."""
        return bool(np.isfinite(self.var_lb).any() or np.isfinite(self.var_ub).any())

    @property
    def num_vars(self) -> int:
        (num_vars,) = self.var_lb.shape
        return num_vars

    # ------------------------------------------------------------------
    # User-supplied functions (JAX-traceable)
    # ------------------------------------------------------------------

    @abc.abstractmethod
    def obj(self, x):
        """Objective value ``f(x)``; must be JAX-traceable."""
        raise NotImplementedError()

    def cons(self, x):
        """Constraint value ``c(x)``; must be JAX-traceable.

        Only required when ``num_cons > 0``.
        """
        raise NotImplementedError()

    # ------------------------------------------------------------------
    # Derivatives: autodiff defaults, overridable
    # ------------------------------------------------------------------

    def obj_grad(self, x):
        """Objective gradient; defaults to ``jax.grad(self.obj)``."""
        return jax.grad(self.obj)(x)

    def cons_jac(self, x):
        """Dense constraint Jacobian ``(m, n)``; defaults to forward-mode
        autodiff (``jax.jacfwd``) of :meth:`cons`."""
        return jax.jacfwd(self.cons)(x)

    def lag_hess(self, x, y):
        """Dense Hessian of the Lagrangian ``f(x) + y^T c(x)``; defaults to
        forward-over-reverse autodiff."""

        def lag_grad(x_):
            g = jax.grad(self.obj)(x_)
            if self.num_cons > 0:
                _, jtv = jax.vjp(self.cons, x_)
                g = g + jtv(y)[0]
            return g

        return jax.jacfwd(lag_grad)(x)

    def lag_hvp(self, x, y, v):
        """Hessian-vector product ``H(x, y) @ v`` without materializing the
        Hessian (used by iterative KKT solvers for large problems)."""

        def lag_grad(x_):
            g = jax.grad(self.obj)(x_)
            if self.num_cons > 0:
                _, jtv = jax.vjp(self.cons, x_)
                g = g + jtv(y)[0]
            return g

        return jax.jvp(lag_grad, (x,), (v,))[1]

    def cons_vjp(self, x, w):
        """Jacobian-transpose product ``J(x)^T w`` without materializing
        the ``(m, n)`` Jacobian; defaults to reverse-mode autodiff of
        :meth:`cons`.  Override together with :meth:`cons_jac` if the
        explicit Jacobian deliberately differs from autodiff."""
        _, jtv = jax.vjp(self.cons, x)
        return jtv(w)[0]

    def cons_jvp(self, x, v):
        """Jacobian product ``J(x) v`` without materializing the Jacobian;
        defaults to forward-mode autodiff of :meth:`cons`."""
        return jax.jvp(self.cons, (x,), (v,))[1]


class FuncProblem(Problem):
    """Problem built from plain functions instead of a subclass.

    Convenience wrapper: ``FuncProblem(lb, ub, obj=f, cons=c, cons_lb=...,
    cons_ub=...)``.
    """

    def __init__(self, var_lb, var_ub, obj, cons=None, **args):
        self._obj = obj
        self._cons = cons
        super().__init__(var_lb, var_ub, **args)

    def obj(self, x):
        return self._obj(x)

    def cons(self, x):
        if self._cons is None:
            raise NotImplementedError()
        return self._cons(x)


class QuadraticProblem(Problem):
    """Quadratic program ``min 1/2 x^T Q x + c^T x  s.t.  l <= Ax <= u`` with
    variable bounds; used by QP/MPS adapters and benchmarks."""

    def __init__(self, Q, c, A=None, cons_lb=None, cons_ub=None, var_lb=None, var_ub=None):
        self.Q = jnp.asarray(Q)
        self.c = jnp.asarray(c)
        (n,) = self.c.shape
        self.A = None if A is None else jnp.asarray(A)

        if var_lb is None:
            var_lb = np.full((n,), -np.inf)
        if var_ub is None:
            var_ub = np.full((n,), np.inf)

        if self.A is None:
            super().__init__(var_lb, var_ub)
        else:
            super().__init__(var_lb, var_ub, cons_lb=cons_lb, cons_ub=cons_ub)

    def obj(self, x):
        return 0.5 * jnp.dot(x, self.Q @ x) + jnp.dot(self.c, x)

    def obj_grad(self, x):
        return self.Q @ x + self.c

    def cons(self, x):
        return self.A @ x

    def cons_jac(self, x):
        return self.A

    def lag_hess(self, x, y):
        return self.Q
