"""Dense LDL^T factorization with inertia extraction, pure JAX.

JAX replacement for the reference's indefinite native factorizations
(MA57 ``ma57_solver.py:76-79``, MUMPS ``mumps_solver.py:81-82``, SSIDS),
whose key extra over LU is the inertia query used for inertia correction
(``symmetric_step_solver.py:146-153``).

Unpivoted (no Bunch-Kaufman 2x2 pivots): the saddle systems solved here are
quasi-definite after the ``+ lambda I`` primal shift — positive-definite
leading block, negative-definite trailing block — for which the unpivoted
factorization exists and is stable [Vanderbei 1995].  A genuine breakdown
(tiny pivot on a very indefinite Hessian at small lambda) produces
non-finite entries, which the step layer converts into a rejected step with
doubled lambda — the same recovery the reference applies on a failed native
factorization.

The factorization loop is a ``lax.fori_loop`` of rank-1 Schur updates:
each step is O(n^2) elementwise work and batches cleanly under vmap.
Blocked variants with GEMM trailing updates live in ``blocked_ldlt.py``
(f64) and ``mixed_ldlt.py`` (f32 with f64 refinement).
"""

import jax
import jax.numpy as jnp


def ldlt_factor(mat):
    """Return the packed factor: strict lower triangle holds L (unit
    diagonal implied), diagonal holds D."""
    n = mat.shape[-1]
    idx = jnp.arange(n)

    def body(k, a):
        d = a[..., k, k]
        # zero pivot = factorization breakdown: poison with NaN (step layer
        # rejects, mirroring the reference's LinearSolverError recovery)
        inv = jnp.where(d != 0.0, 1.0 / d, jnp.nan)
        col = a[..., :, k] * inv[..., None]
        below = idx > k
        col = jnp.where(below, col, 0.0)
        # trailing Schur update; col is zero outside the trailing block
        a = a - d[..., None, None] * col[..., :, None] * col[..., None, :]
        a = a.at[..., :, k].set(jnp.where(below, col, a[..., :, k]))
        return a

    if n <= 16:  # static unroll for tiny batched systems (see plu.py)
        a = mat
        for k in range(n):
            a = body(k, a)
        return a
    return jax.lax.fori_loop(0, n, body, mat)


def ldlt_solve(fact, rhs):
    """Solve ``L D L^T x = rhs`` from the packed factor.

    ``rhs`` may be a vector ``(..., n)`` or a matrix ``(..., k, n)`` of k
    independent right-hand sides (system dimension LAST either way).
    Implemented with XLA's blocked TriangularSolve rather than sequential
    substitution sweeps."""
    import jax.scipy.linalg as jsl

    n = fact.shape[-1]
    lower = jnp.tril(fact, k=-1) + jnp.eye(n, dtype=fact.dtype)
    d = jnp.diagonal(fact, axis1=-2, axis2=-1)

    vector = rhs.ndim == fact.ndim - 1
    b = rhs[..., None] if vector else jnp.swapaxes(rhs, -1, -2)  # (..., n, k)

    z = jsl.solve_triangular(lower, b, lower=True, unit_diagonal=True)
    z = z / d[..., :, None]
    x = jsl.solve_triangular(lower, z, trans=1, lower=True, unit_diagonal=True)

    return x[..., 0] if vector else jnp.swapaxes(x, -1, -2)


def ldlt_num_neg_eigvals(fact):
    """Matrix inertia: by Sylvester's law the number of negative eigenvalues
    equals the number of negative entries of D."""
    d = jnp.diagonal(fact, axis1=-2, axis2=-1)
    return jnp.sum(d < 0.0, axis=-1).astype(jnp.int32)
