"""Mixed-precision LDL^T: f32 panel factorization, f64 refinement.

The factorization runs in f32; a solve reaches f64 accuracy through
iterative refinement against the f64 matrix (``refine_solve``), and the
inertia comes from the signs of the f32 pivots (``ldlt.ldlt_num_neg_eigvals``).
Plain ``jnp``/``lax`` code, compiled by XLA for whatever device runs it.

The factorization is right-looking and blocked by super-blocks of ``SB``
columns, statically unrolled so that every slice has a static shape:

for each super-block k:
    A[k,k]       -> packed LDL^T      rank-1 sweep over the (SB, SB) block
    X            = A[k+1:, k] L_kk^{-T}   one triangular solve
    L[k+1:, k]   = X D_k^{-1}         column scaling
    A[k+1:, k+1:] -= X D_k^{-1} X^T   one GEMM

Leading batch dimensions ride through every step (the rank-1 sweep is
elementwise, the solve and the GEMM are batched), so ``jax.vmap`` and
explicit ``(..., n, n)`` stacks both work.  Unpivoted like ``ldlt.py``: the
saddle systems it serves are quasi-definite, and a zero pivot poisons the
factor with NaN (the step layer rejects the step).
"""

import functools

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from .ldlt import ldlt_factor, ldlt_solve

# super-block width; chosen on the earlier accelerator, not yet re-derived
# on the GPU
DEFAULT_SUPER_BLOCK = 128


@functools.partial(jax.jit, static_argnames=("super_block",))
def ldlt_factor_f32(mat, super_block: int = DEFAULT_SUPER_BLOCK):
    """Packed f32 LDL^T factor of a symmetric ``(..., n, n)`` matrix (same
    layout as ``ldlt.ldlt_factor``: strict lower triangle holds L, the
    diagonal holds D).  ``n`` is padded with identity to a multiple of
    ``super_block`` internally."""
    mat = mat.astype(jnp.float32)
    n = mat.shape[-1]

    num = -(-n // super_block)
    n_pad = num * super_block
    if n_pad != n:
        # identity padding: extra unit pivots decouple from the real block
        shape = mat.shape[:-2] + (n_pad, n_pad)
        eye = jnp.broadcast_to(jnp.eye(n_pad, dtype=jnp.float32), shape)
        mat = eye.at[..., :n, :n].set(mat)

    a = mat
    for k in range(num):
        s, e = k * super_block, (k + 1) * super_block

        packed = ldlt_factor(a[..., s:e, s:e])
        a = a.at[..., s:e, s:e].set(packed)

        if e == n_pad:
            break

        d = jnp.diagonal(packed, axis1=-2, axis2=-1)  # (..., SB)
        lower = jnp.tril(packed, k=-1) + jnp.eye(super_block, dtype=jnp.float32)

        p = a[..., e:, s:e]  # (..., rest, SB)
        y = jsl.solve_triangular(
            lower,
            jnp.swapaxes(p, -1, -2),
            lower=True,
            unit_diagonal=True,
        )
        x = jnp.swapaxes(y, -1, -2)

        inv_d = jnp.where(d != 0.0, 1.0 / d, jnp.nan)
        l_panel = x * inv_d[..., None, :]
        a = a.at[..., e:, s:e].set(l_panel)

        upd = l_panel @ jnp.swapaxes(x, -1, -2)
        a = a.at[..., e:, e:].add(-upd)

    if n_pad != n:
        a = a[..., :n, :n]
    return a


def refine_solve(packed_f32, mat_f64, rhs, iters: int = 3):
    """Mixed-precision solve of ``mat_f64 x = rhs`` (``rhs`` of shape
    ``(..., n)``): f32 LDL^T back-solves + ``iters`` passes of f64 residual
    refinement against the original matrix."""

    def solve32(r):
        return ldlt_solve(packed_f32, r.astype(jnp.float32)).astype(rhs.dtype)

    x = solve32(rhs)

    def body(_, x):
        r = rhs - (mat_f64 @ x[..., None])[..., 0]
        return x + solve32(r)

    return jax.lax.fori_loop(0, iters, body, x)
