"""Penalty (rho) update strategies.

Counterparts of the six reference strategies (``pygradflow/penalty.py``),
as pure state-transition functions running inside the jit-ed outer loop::

    initial(params) -> (rho0, pstate0)
    update(prev_iterate, next_iterate, rho, pstate) -> (rho_n, accept, pstate_n)

The filter strategies maintain a Pareto front; the reference keeps it as an
unbounded Python list (``penalty.py:186-238`` — with a note that it "could
be logarithmic").  Under jit the front lives in a fixed-capacity buffer
(``params.filter_capacity``) with masked dominance checks — an O(capacity)
vectorized sweep, replacing the reference's O(len) Python loop.
"""

from typing import Any, NamedTuple

import jax.numpy as jnp

from .iterate import Iterate, _jac_t, aug_lag_deriv_x, cons_violation
from .params import Params, PenaltyUpdate
from .util import inf_norm


class PenaltyResult(NamedTuple):
    rho: Any
    accept: Any
    state: Any


def _accept(rho, state):
    return PenaltyResult(rho, jnp.array(True), state)


# ----------------------------------------------------------------------


def _constant(params: Params, m: int):
    def initial():
        return params.rho, ()

    def update(prev: Iterate, nxt: Iterate, rho, state):
        return _accept(jnp.asarray(params.rho, nxt.x.dtype), state)

    return initial, update


def _dual_norm(params: Params, m: int):
    """Keep rho within a factor of ||y||_inf (reference ``penalty.py:46-74``,
    the default)."""

    def initial():
        return params.rho, ()

    def update(prev: Iterate, nxt: Iterate, rho, state):
        if m == 0:
            return _accept(rho, state)
        ynorm = inf_norm(nxt.y)
        grow = ynorm >= 10.0 * rho
        rho_n = jnp.where(grow, jnp.minimum(ynorm, 10.0 * rho), rho)
        return _accept(rho_n, state)

    return initial, update


def _dual_equilibration(params: Params, m: int):
    """Target rho = 0.01 |y^T c| / (1/2 ||c||^2)
    (reference ``penalty.py:77-112``)."""

    def initial():
        return params.rho, ()

    def update(prev: Iterate, nxt: Iterate, rho, state):
        if m == 0:
            return _accept(rho, state)
        cons = nxt.cons
        yprod = jnp.abs(jnp.dot(nxt.y, cons))
        viol = 0.5 * jnp.dot(cons, cons)

        target = 0.01 * yprod / jnp.where(viol == 0.0, 1.0, viol)
        grow = jnp.logical_and(viol > 0.0, rho < target)
        rho_n = jnp.where(grow, jnp.maximum(rho * 10.0, target), rho)
        return _accept(rho_n, state)

    return initial, update


def _pareto_decrease(params: Params, m: int, fns=None):
    """Bound rho so the flow direction weakly decreases objective or
    violation (reference ``penalty.py:115-183``)."""

    def initial():
        return params.rho, ()

    def update(prev: Iterate, nxt: Iterate, rho, state):
        if m == 0:
            return _accept(rho, state)

        cons = nxt.cons
        viol = 0.5 * jnp.dot(cons, cons)

        infeas_res = _jac_t(nxt, cons, fns)
        infeas_norm_inf = inf_norm(infeas_res)

        # skip when feasible or locally infeasible
        skip = jnp.logical_or(
            viol <= params.opt_tol, infeas_norm_inf <= params.local_infeas_tol
        )

        obj_grad = nxt.obj_grad
        obj_prod = jnp.dot(obj_grad, infeas_res)
        cons_dual_prod = _jac_t(nxt, nxt.y, fns)

        obj_grad_norm = jnp.linalg.norm(obj_grad)
        lhs_obj = -(obj_grad_norm + jnp.dot(cons_dual_prod, obj_grad))
        safe_prod = jnp.where(jnp.abs(obj_prod) > 1e-10, obj_prod, 1.0)
        obj_bound = jnp.where(jnp.abs(obj_prod) > 1e-10, lhs_obj / safe_prod, jnp.inf)

        infeas_res_norm = jnp.linalg.norm(infeas_res)
        lhs_cons = -jnp.dot(infeas_res, obj_grad + cons_dual_prod)
        cons_bound = lhs_cons / jnp.where(infeas_res_norm == 0.0, 1.0, infeas_res_norm)

        bound = jnp.minimum(obj_bound, cons_bound)
        rho_n = jnp.maximum(jnp.minimum(rho * 10.0, bound), rho)
        rho_n = jnp.where(skip, rho, rho_n)
        return _accept(rho_n, state)

    return initial, update


# ----------------------------------------------------------------------
# Filter strategies (bounded Pareto front)
# ----------------------------------------------------------------------


class FilterState(NamedTuple):
    entries: Any  # (capacity, 2)
    valid: Any  # (capacity,) bool
    cursor: Any  # int32 overwrite position when full
    rho: Any
    """The strategy's own rho.  In the reference the filter mutates its
    internal ``self.rho`` on every rejection while the solver's rho only
    syncs on *accepted* steps (``penalty.py:220-227`` vs
    ``solver.py:357-369``) — so the two can diverge across a run of
    rejections.  Carrying the strategy rho in the state reproduces that."""


def _filter_initial(params: Params):
    cap = params.filter_capacity
    return FilterState(
        entries=jnp.full((cap, 2), jnp.inf),
        valid=jnp.zeros((cap,), dtype=bool),
        cursor=jnp.zeros((), jnp.int32),
        rho=jnp.asarray(params.rho, params.dtype),
    )


def _filter_insert(state: FilterState, first, second):
    """Insert (first, second) into the Pareto front; returns (accepted,
    new_state).  Rejected iff dominated by an existing entry
    (reference ``penalty.py:199-213``)."""
    entry = jnp.stack([first, second])

    dominated = jnp.any(
        jnp.logical_and(
            state.valid,
            jnp.logical_and(
                state.entries[:, 0] <= first, state.entries[:, 1] <= second
            ),
        )
    )

    # drop entries dominated by the new one
    dominates_old = jnp.logical_and(
        first <= state.entries[:, 0], second <= state.entries[:, 1]
    )
    valid = jnp.logical_and(state.valid, jnp.logical_not(dominates_old))

    free = jnp.logical_not(valid)
    any_free = jnp.any(free)
    cap = valid.shape[0]
    idx = jnp.where(any_free, jnp.argmax(free), state.cursor % cap)

    entries_n = state.entries.at[idx].set(entry)
    valid_n = valid.at[idx].set(True)

    new_state = FilterState(
        entries=jnp.where(dominated, state.entries, entries_n),
        valid=jnp.where(dominated, state.valid, valid_n),
        cursor=state.cursor + jnp.where(dominated, 0, 1),
        rho=state.rho,
    )
    return jnp.logical_not(dominated), new_state


def _filter_strategy(params: Params, entry_fn):
    def initial():
        return params.rho, _filter_initial(params)

    def update(prev: Iterate, nxt: Iterate, rho, state):
        first, second = entry_fn(nxt, state.rho)
        inserted, state_n = _filter_insert(state, first, second)
        rho_n = jnp.where(inserted, state.rho, state.rho * 10.0)
        state_n = state_n._replace(rho=rho_n)
        return PenaltyResult(rho_n, inserted, state_n)

    return initial, update


def _objective_filter(params: Params, m: int):
    """Pareto filter on (objective, constraint violation)
    (reference ``penalty.py:229-238``)."""

    def entry(it: Iterate, rho):
        return it.obj, cons_violation(it)

    return _filter_strategy(params, entry)


def _lagrangian_filter(params: Params, m: int, fns=None):
    """Pareto filter on (||grad L||^2, ||c||)
    (reference ``penalty.py:241-255``)."""

    def entry(it: Iterate, rho):
        lag_x = aug_lag_deriv_x(it, rho, fns)
        lag_y = it.cons
        norm_sq = jnp.dot(lag_x, lag_x) + jnp.dot(lag_y, lag_y)
        return norm_sq, jnp.linalg.norm(it.cons)

    return _filter_strategy(params, entry)


def penalty_strategy(params: Params, num_cons: int, fns=None):
    """Factory keyed on PenaltyUpdate (reference ``penalty.py:258-274``).

    ``fns`` routes J^T products through autodiff ``cons_vjp`` in
    matrix-free mode (strategies reading ``it.cons_jac`` otherwise)."""
    pu = params.penalty_update
    if pu == PenaltyUpdate.Constant:
        return _constant(params, num_cons)
    elif pu == PenaltyUpdate.DualNorm:
        return _dual_norm(params, num_cons)
    elif pu == PenaltyUpdate.DualEquilibration:
        return _dual_equilibration(params, num_cons)
    elif pu == PenaltyUpdate.ParetoDecrease:
        return _pareto_decrease(params, num_cons, fns)
    elif pu == PenaltyUpdate.ObjectiveFilter:
        return _objective_filter(params, num_cons)
    elif pu == PenaltyUpdate.LagrangianFilter:
        return _lagrangian_filter(params, num_cons, fns)
    raise ValueError("Invalid penalty update strategy")
