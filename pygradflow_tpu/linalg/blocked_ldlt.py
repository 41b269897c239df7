"""Blocked LDL^T factorization: panel rank-1 sweeps + GEMM trailing updates.

The unblocked factorization (``ldlt.py``) performs n sequential rank-1
updates — O(n^2) elementwise work per step and no matrix products.  This
blocked right-looking variant factors NB-column panels with rank-1 sweeps
restricted to the panel, then applies the trailing Schur update for the
whole panel as one (n, NB) x (NB, n) matmul:

    A[k+NB:, k+NB:] -= L_panel * D_panel * L_panel^T

Shapes stay static by always operating on full-height panels with masks;
the panel position enters through ``lax.dynamic_slice``.  FLOP count is the
usual n^3/3 with the dominant term in the GEMMs.
"""

import jax
import jax.numpy as jnp

# panel width; chosen on the earlier accelerator, not yet re-derived on the GPU
DEFAULT_BLOCK = 128


def ldlt_factor_blocked(mat, block: int = DEFAULT_BLOCK):
    """Packed LDL^T factor (same layout as ``ldlt_factor``): strict lower
    triangle holds L, diagonal holds D.  Requires square ``mat``; the size
    is padded up to a multiple of ``block`` internally."""
    n = mat.shape[-1]
    if n <= block:
        from .ldlt import ldlt_factor

        return ldlt_factor(mat)

    num_panels = -(-n // block)
    n_pad = num_panels * block
    if n_pad != n:
        # pad with identity so extra pivots are 1 and decouple
        pad = n_pad - n
        eye_pad = jnp.eye(n_pad, dtype=mat.dtype) * 1.0
        a = eye_pad.at[..., :n, :n].set(mat)
    else:
        a = mat

    idx = jnp.arange(n_pad)

    def panel_body(p, a):
        base = p * block

        # ---- factor the panel columns (rank-1 sweeps on the full height,
        # masked to rows >= column) ----
        def col_body(j, a):
            k = base + j
            d = a[k, k]
            inv = jnp.where(d != 0.0, 1.0 / d, jnp.nan)
            col = a[:, k] * inv
            below = idx > k
            col = jnp.where(below, col, 0.0)

            # update only the remaining columns of this panel: mask columns
            # to (k, base+block)
            panel_cols = jnp.logical_and(idx > k, idx < base + block)
            upd = d * col[:, None] * jnp.where(panel_cols, a[k, :] * inv, 0.0)[None, :]
            a = a - upd
            a = a.at[:, k].set(jnp.where(below, col, a[:, k]))
            return a

        a = jax.lax.fori_loop(0, block, col_body, a)

        # ---- trailing Schur update with one matmul ----
        # L_panel: full-height block of L columns [base, base+block)
        lpanel = jax.lax.dynamic_slice(a, (0, base), (n_pad, block))
        dvals = jax.lax.dynamic_slice(jnp.diagonal(a), (base,), (block,))
        # zero above the trailing region: rows < base+block contribute nothing
        trailing = idx >= base + block
        lpanel = jnp.where(trailing[:, None], lpanel, 0.0)

        upd = (lpanel * dvals[None, :]) @ lpanel.T
        # only the trailing block changes; the mask above already zeroes
        # the rest of the product
        a = a - upd
        return a

    a = jax.lax.fori_loop(0, num_panels, panel_body, a)

    if n_pad != n:
        a = a[..., :n, :n]
    return a
