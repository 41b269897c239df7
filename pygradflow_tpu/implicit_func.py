"""Implicit (projection-residual) function of the implicit Euler step.

The mathematical core (reference ``pygradflow/implicit_func.py``): for a step
origin :math:`(\\hat x, \\hat y)` and step size :math:`\\Delta t = 1/\\lambda`
the residual

.. math::
    F(x, y) = \\begin{pmatrix}
        x - P_C(\\hat x - \\Delta t \\nabla_x L_\\rho(x, y)) \\\\
        y - (\\hat y + \\Delta t\\, c(x))
    \\end{pmatrix}

and its scaled-by-:math:`\\lambda` variant (better conditioned for small
:math:`\\Delta t`, reference ``implicit_func.py:202-294``).

Accelerator-first design: the active set is a boolean vector, the projection
derivative a row mask, and the Newton matrices dense ``(n+m, n+m)`` blocks
assembled with ``jnp.where`` — shapes are static under jit, no index
gathers.  Active-set "reduction" is realized by substituting identity rows
(the reference's own Asymmetric formulation,
``asymmetric_step_solver.py:38-104``), which yields identical solutions to
the sliced formulations.
"""

from typing import Any, Optional

import jax
import jax.numpy as jnp

from .iterate import Iterate, aug_lag_deriv_x

ACTIVE_EPS = 1e-8  # strict box tolerance (reference implicit_func.py:44)


@jax.tree_util.register_pytree_node_class
class StepFunc:
    """Description of the step residual: origin iterate, bounds and step
    size.  ``scaled`` selects the lambda-scaled variant; it is registered
    as static pytree metadata so a StepFunc can be carried through
    lax.while_loop / lax.cond without the flag becoming a tracer."""

    def __init__(self, orig: Iterate, lamb, lb, ub, scaled: bool):
        self.orig = orig
        self.lamb = lamb
        self.lb = lb
        self.ub = ub
        self.scaled = scaled

    def tree_flatten(self):
        return (self.orig, self.lamb, self.lb, self.ub), self.scaled

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, scaled=aux)

    @property
    def dt(self):
        return 1.0 / self.lamb

    @property
    def proj_lb(self):
        """Bounds of the projection box (scaled by lambda for the scaled
        variant, reference ``implicit_func.py:211-216``)."""
        return self.lamb * self.lb if self.scaled else self.lb

    @property
    def proj_ub(self):
        return self.lamb * self.ub if self.scaled else self.ub


def make_step_func(orig: Iterate, lamb, lb, ub, scaled: bool = True) -> StepFunc:
    return StepFunc(orig=orig, lamb=lamb, lb=lb, ub=ub, scaled=scaled)


def active_set_at_point(func: StepFunc, p):
    """Boolean mask: entries of ``p`` strictly outside the projection box
    (these get clipped by the projection; reference
    ``implicit_func.py:21-44``)."""
    lb, ub = func.proj_lb, func.proj_ub
    return jnp.logical_or(p < lb - ACTIVE_EPS, p > ub + ACTIVE_EPS)


def project_box(func: StepFunc, p, active_set):
    """Clip only the *active* entries into the box
    (reference ``implicit_func.py:46-60``)."""
    lb, ub = func.proj_lb, func.proj_ub
    return jnp.where(active_set, jnp.clip(p, lb, ub), p)


def projection_initial(
    func: StepFunc, it: Iterate, rho, tau: Optional[Any] = None, fns=None
):
    """Point whose projection defines the x-residual
    (reference ``implicit_func.py:134-147`` / ``:233-246``)."""
    x0 = func.orig.x
    lamb = func.lamb
    d = aug_lag_deriv_x(it, rho, fns)

    if func.scaled:
        if tau is not None:
            f_x = lamb * (1.0 - tau * lamb)
            f_x0 = tau * lamb * lamb
            f_d = tau * lamb
            return f_x * it.x + f_x0 * x0 - f_d * d
        return lamb * x0 - d
    else:
        dt = func.dt
        if tau is not None:
            return (1.0 - tau * lamb) * it.x + (tau * lamb) * x0 - tau * d
        return x0 - dt * d


def compute_active_set(
    func: StepFunc, it: Iterate, rho, tau: Optional[Any] = None, fns=None
):
    p = projection_initial(func, it, rho, tau, fns)
    return active_set_at_point(func, p)


def value_at(func: StepFunc, it: Iterate, rho, active_set=None, fns=None):
    """Residual value ``(rx, ry)`` (reference ``implicit_func.py:150-161`` /
    ``:219-231``)."""
    p = projection_initial(func, it, rho, fns=fns)
    if active_set is None:
        active_set = active_set_at_point(func, p)

    proj = project_box(func, p, active_set)

    if func.scaled:
        lamb = func.lamb
        rx = lamb * it.x - proj
        ry = -(lamb * it.y - (lamb * func.orig.y + it.cons))
    else:
        dt = func.dt
        rx = it.x - proj
        ry = it.y - (func.orig.y + dt * it.cons)

    return rx, ry


def value_norm(func: StepFunc, it: Iterate, rho, active_set=None, fns=None):
    rx, ry = value_at(func, it, rho, active_set, fns=fns)
    return jnp.sqrt(jnp.dot(rx, rx) + jnp.dot(ry, ry))


def deriv(func: StepFunc, jac, hess, active_set):
    """Dense Newton matrix of the residual.

    Unscaled: ``[[I + dt P'H, dt P'J^T], [-dt J, I]]``
    (reference ``implicit_func.py:163-188``);
    scaled: ``[[lamb I + P'H, P'J^T], [-J, lamb I]]``
    (reference ``implicit_func.py:254-283``);
    ``P'`` zeroes the active rows.
    """
    n = hess.shape[0]
    m = jac.shape[0]
    dtype = hess.dtype
    inactive = jnp.logical_not(active_set)[:, None]
    eye_n = jnp.eye(n, dtype=dtype)
    eye_m = jnp.eye(m, dtype=dtype)

    if func.scaled:
        lamb = func.lamb
        F11 = lamb * eye_n + jnp.where(inactive, hess, 0.0)
        F12 = jnp.where(inactive, jac.T, 0.0)
        F21 = -jac
        F22 = lamb * eye_m
    else:
        dt = func.dt
        F11 = eye_n + jnp.where(inactive, dt * hess, 0.0)
        F12 = jnp.where(inactive, dt * jac.T, 0.0)
        F21 = -dt * jac
        F22 = eye_m

    top = jnp.concatenate([F11, F12], axis=1)
    bot = jnp.concatenate([F21, F22], axis=1)
    return jnp.concatenate([top, bot], axis=0)
