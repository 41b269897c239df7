"""Dense LU with partial pivoting, pure JAX.

The JAX replacement for the reference's default SuperLU backend
(``linear_solver/lu_solver.py``).  It uses only elementwise/matmul
primitives, so it compiles for every dtype on every backend, vmaps over
instance batches, and supports transpose solves (needed by the Dixon condition estimator,
reference ``step/cond_estimate.py:58-114``).

Right-looking rank-1 update form: the k-loop is a ``lax.fori_loop`` whose
body is O(n^2) elementwise work.  Pivoting is done with ``where`` masks and a
permutation vector — no dynamic slicing.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp


UNROLL_MAX_N = 16


class PLUFactorization(NamedTuple):
    lu: jnp.ndarray  # packed: strict lower = L (unit diag), upper = U
    perm: jnp.ndarray  # row permutation: row i of PA is row perm[i] of A


def plu_factor(mat) -> PLUFactorization:
    n = mat.shape[-1]
    idx = jnp.arange(n)

    def body(k, carry):
        a, perm = carry

        col = jnp.abs(a[..., :, k])
        col = jnp.where(idx >= k, col, -jnp.inf)
        p = jnp.argmax(col, axis=-1)

        def swap_rows(a_, p_):
            rk = a_[k, :]
            rp = a_[p_, :]
            a_ = a_.at[k, :].set(rp)
            a_ = a_.at[p_, :].set(rk)
            return a_

        a = swap_rows(a, p) if a.ndim == 2 else jax.vmap(swap_rows)(a, p)

        def swap_perm(perm_, p_):
            pk = perm_[k]
            pp = perm_[p_]
            perm_ = perm_.at[k].set(pp)
            perm_ = perm_.at[p_].set(pk)
            return perm_

        perm = swap_perm(perm, p) if perm.ndim == 1 else jax.vmap(swap_perm)(perm, p)

        piv = a[..., k, k]
        # zero pivot = singular matrix: poison with NaN so the step layer
        # rejects (reference raises LinearSolverError on singular factors)
        inv = jnp.where(piv != 0.0, 1.0 / piv, jnp.nan)

        below = idx > k
        l_col = a[..., :, k] * inv[..., None]
        l_col = jnp.where(below, l_col, 0.0)

        right = idx >= k + 1
        u_row = jnp.where(right, a[..., k, :], 0.0)

        a = a - l_col[..., :, None] * u_row[..., None, :]
        a = a.at[..., :, k].set(
            jnp.where(below, l_col, a[..., :, k])
        )
        return (a, perm)

    perm0 = jnp.broadcast_to(idx, mat.shape[:-2] + (n,)).astype(jnp.int32)
    # derive from `mat` so the carry inherits mat's device-varying type
    # under shard_map (a freshly created constant would be replicated and
    # fail the while-loop carry type check)
    perm0 = perm0 + jnp.zeros_like(mat[..., 0], dtype=jnp.int32)

    if n <= UNROLL_MAX_N:
        # tiny systems (vmap-batched KKT of small NLPs): a static unroll
        # fuses into the surrounding computation instead of a sequential
        # while-loop of launches
        carry = (mat, perm0)
        for k in range(n):
            carry = body(k, carry)
        lu, perm = carry
    else:
        lu, perm = jax.lax.fori_loop(0, n, body, (mat, perm0))
    return PLUFactorization(lu=lu, perm=perm)


def _unpack(fact: PLUFactorization):
    lu = fact.lu
    n = lu.shape[-1]
    lower = jnp.tril(lu, k=-1) + jnp.eye(n, dtype=lu.dtype)
    upper = jnp.triu(lu)
    return lower, upper


def _loop(n, body, init):
    """Column sweep: statically unrolled for tiny systems (the same
    treatment ``plu_factor`` gets — every fori_loop iteration and every
    XLA TriangularSolve is a separate op with a fixed cost, while the
    unrolled sweep fuses into the surrounding computation)."""
    if n <= UNROLL_MAX_N:
        carry = init
        for k in range(n):
            carry = body(k, carry)
        return carry
    return jax.lax.fori_loop(0, n, body, init)


def _fwd_sub_unit(L, b):
    """Solve L z = b with unit-lower L via column sweep."""
    n = L.shape[-1]
    idx = jnp.arange(n)

    def body(k, z):
        zk = z[..., k]
        below = idx > k
        upd = jnp.where(below, L[..., :, k] * zk[..., None], 0.0)
        return z - upd

    return _loop(n, body, b)


def _back_sub(U, b):
    """Solve U x = b with upper-triangular U via column sweep."""
    n = U.shape[-1]
    idx = jnp.arange(n)

    def body(i, x):
        k = n - 1 - i
        diag = U[..., k, k]
        xk = x[..., k] / diag
        x = x.at[..., k].set(xk)
        above = idx < k
        upd = jnp.where(above, U[..., :, k] * xk[..., None], 0.0)
        return x - upd

    return _loop(n, body, b)


def _back_sub_unit_T(L, b):
    """Solve L^T x = b with unit-lower L (i.e. upper-triangular L^T)."""
    n = L.shape[-1]
    idx = jnp.arange(n)

    def body(i, x):
        k = n - 1 - i
        xk = x[..., k]
        above = idx < k
        upd = jnp.where(above, L[..., k, :] * xk[..., None], 0.0)
        return x - upd

    return _loop(n, body, b)


def _fwd_sub_T(U, b):
    """Solve U^T z = b with upper-triangular U (i.e. lower-triangular U^T)."""
    n = U.shape[-1]
    idx = jnp.arange(n)

    def body(k, z):
        diag = U[..., k, k]
        zk = z[..., k] / diag
        z = z.at[..., k].set(zk)
        below = idx > k
        upd = jnp.where(below, U[..., k, :] * zk[..., None], 0.0)
        return z - upd

    return _loop(n, body, b)


def plu_solve(fact: PLUFactorization, rhs):
    """Solve A x = rhs from the packed factorization.  Tiny systems
    (n <= UNROLL_MAX_N) use the statically unrolled substitution sweeps —
    the hot integration/KKT paths issue ~30 solves per work unit, and the
    unrolled sweep fuses into the surrounding computation where each
    TriangularSolve would be an op of its own.  Larger systems use the
    blocked XLA TriangularSolve."""
    lower, upper = _unpack(fact)
    n = lower.shape[-1]
    b = jnp.take_along_axis(rhs, fact.perm, axis=-1)
    if n <= UNROLL_MAX_N:
        return _back_sub(upper, _fwd_sub_unit(lower, b))

    import jax.scipy.linalg as jsl

    z = jsl.solve_triangular(lower, b[..., None], lower=True, unit_diagonal=True)
    x = jsl.solve_triangular(upper, z, lower=False)
    return x[..., 0]


def plu_solve_trans(fact: PLUFactorization, rhs):
    """Solve A^T x = rhs: U^T L^T P x = rhs."""
    lower, upper = _unpack(fact)
    n = lower.shape[-1]
    if n <= UNROLL_MAX_N:
        y = _back_sub_unit_T(lower, _fwd_sub_T(upper, rhs))
    else:
        import jax.scipy.linalg as jsl

        z = jsl.solve_triangular(upper, rhs[..., None], trans=1, lower=False)
        y = jsl.solve_triangular(
            lower, z, trans=1, lower=True, unit_diagonal=True
        )[..., 0]
    # x = P^T y: scatter back through the permutation
    n = y.shape[-1]
    perm = fact.perm
    x = jnp.zeros_like(y)
    if y.ndim == 1:
        x = x.at[perm].set(y)
    else:
        x = jax.vmap(lambda x_, p_, y_: x_.at[p_].set(y_))(x, perm, y)
    return x
