"""Block-tridiagonal symmetric solver (block-Thomas via ``lax.scan``).

Optimal-control duals have this structure: with a block-diagonal Hessian
(stage-separable Lagrangian) and stage-local constraints (each constraint
couples at most two adjacent stages), the dual Schur complement
``S = -c I - J A^{-1} J^T`` is symmetric block tridiagonal with one
(q, q) block per stage.  A dense factorization costs O(M^3 q^3) and is
what the reference's sparse LU implicitly avoids; this module restores
the O(M q^3) sequential factorization as two ``lax.scan`` sweeps —
latency-bound (M tiny block ops) but asymptotically linear, where the
dense factorization is cubic.

The blocks are factored with the unrolled dense LDL^T (``ldlt.py``,
n <= 16 unrolls completely) in the working precision.

Matrix representation: ``diag`` (M, q, q) diagonal blocks and ``upper``
(M-1, q, q) super-diagonal blocks; symmetry is assumed (the subdiagonal
is ``upper[i].T``), as holds for any Schur complement of a symmetric
KKT system.

Reference counterpart: the role of HSL MA57 / SuperLU on banded KKT
systems (``linear_solver/lu_solver.py``, ``ma57_solver.py``) — written
in JAX instead of bound from Fortran.
"""

import os
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from .blocked_ldlt import ldlt_factor_blocked
from .ldlt import ldlt_factor, ldlt_solve


class BTDFactor(NamedTuple):
    facts: Any  # (M, q, q) packed LDL^T factors of the pivot blocks C_i
    upper: Any  # (M-1, q, q) super-diagonal blocks U_i


def _solve_mat(fact, B):
    """Solve C X = B for a (q, k) matrix rhs with the packed LDL^T
    ``fact`` (ldlt_solve treats the last axis as the system axis)."""
    return ldlt_solve(fact, B.T).T


def btd_factor(diag, upper) -> BTDFactor:
    """Block-Thomas factorization of the symmetric block-tridiagonal
    matrix: C_0 = D_0, C_i = D_i - U_{i-1}^T C_{i-1}^{-1} U_{i-1}."""
    f0 = ldlt_factor(diag[0])

    def step(prev_fact, inputs):
        d_i, u_prev = inputs
        x = _solve_mat(prev_fact, u_prev)  # C_{i-1}^{-1} U_{i-1}
        c_i = d_i - u_prev.T @ x
        fact = ldlt_factor(c_i)
        return fact, fact

    _, facts_rest = jax.lax.scan(step, f0, (diag[1:], upper))
    facts = jnp.concatenate([f0[None], facts_rest], axis=0)
    return BTDFactor(facts=facts, upper=upper)


def btd_solve(fact: BTDFactor, rhs):
    """Solve T x = rhs for rhs of shape (M, q) (or (M*q,) flattened)."""
    facts, upper = fact
    m_blocks, q = facts.shape[0], facts.shape[1]
    flat = rhs.ndim == 1
    r = rhs.reshape(m_blocks, q)

    # forward sweep: z_i = r_i - U_{i-1}^T C_{i-1}^{-1} z_{i-1}
    def fwd(z_prev_and_fact, inputs):
        z_prev, fact_prev = z_prev_and_fact
        r_i, u_prev, fact_i = inputs
        z_i = r_i - u_prev.T @ ldlt_solve(fact_prev, z_prev)
        return (z_i, fact_i), z_i

    (_, _), z_rest = jax.lax.scan(
        fwd, (r[0], facts[0]), (r[1:], upper, facts[1:])
    )
    z = jnp.concatenate([r[0][None], z_rest], axis=0)

    # backward sweep: x_i = C_i^{-1} (z_i - U_i x_{i+1})
    x_last = ldlt_solve(facts[-1], z[-1])

    def bwd(x_next, inputs):
        z_i, u_i, fact_i = inputs
        x_i = ldlt_solve(fact_i, z_i - u_i @ x_next)
        return x_i, x_i

    _, x_rest = jax.lax.scan(
        bwd, x_last, (z[:-1], upper, facts[:-1]), reverse=True
    )
    x = jnp.concatenate([x_rest, x_last[None]], axis=0)
    return x.reshape(-1) if flat else x


def dense_to_btd(S, q):
    """Extract the (diag, upper) block bands of a dense (m, m) matrix that
    is block-tridiagonal with (q, q) blocks.  Entries outside the band are
    ignored (asserted zero in tests, not at runtime)."""
    m = S.shape[0]
    mb = m // q
    sb = S.reshape(mb, q, mb, q)
    idx = jnp.arange(mb)
    diag = sb[idx, :, idx, :]
    upper = sb[idx[:-1], :, idx[:-1] + 1, :]
    return diag, upper


# ----------------------------------------------------------------------
# Block cyclic reduction — the log-depth, batched variant
# ----------------------------------------------------------------------
#
# The Thomas sweeps above are O(M) *sequential* steps, each a tiny op
# paying loop latency.  Cyclic reduction eliminates all odd-indexed blocks at once per
# level (a batched (M/2, q, q) LDL^T + a few batched matmuls) and recurses
# on the even blocks: log2(M) levels of fully-batched work instead of M
# sequential steps.  Classic reference: Buzbee, Golub & Nielson (1970).


class BCRLevel(NamedTuple):
    facts_odd: Any  # (H, q, q) packed LDL^T of odd pivot blocks
    a_left: Any  # (H, q, q) U[2t-1]: couples even 2t to odd 2t-1 (0 at t=0)
    a_right: Any  # (H, q, q) U[2t]: couples even 2t to odd 2t+1
    b_right: Any  # (H, q, q) U[2t+1]: couples odd 2t+1 to even 2t+2 (0 at t=H-1)


@jax.tree_util.register_pytree_node_class
class BCRFactor:
    """Cyclic-reduction factorization.  The shape ints (m_blocks, q,
    m_base) and the root solver kind are static pytree metadata, NOT
    leaves — a factor that round-trips through jit keeps them as Python
    values."""

    def __init__(
        self, levels, root_fact, m_blocks: int, q: int, m_base: int,
        root_kind: str = "ldlt",
    ):
        self.levels = levels  # tuple of BCRLevel, coarsest last
        self.root_fact = root_fact  # factorization of the dense base
        self.m_blocks = m_blocks  # original (unpadded) number of blocks
        self.q = q
        self.m_base = m_base  # block-rows remaining when recursion stopped
        self.root_kind = root_kind  # "ldlt" or "lin" (external tier)

    def tree_flatten(self):
        return (self.levels, self.root_fact), (
            self.m_blocks, self.q, self.m_base, self.root_kind,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)

    def __iter__(self):  # keep tuple-style unpacking working
        return iter((self.levels, self.root_fact, self.m_blocks, self.q, self.m_base))


# stop the reduction once this few block-rows remain and solve the rest as
# ONE dense (m_base*q) LDL^T: each BCR level is a fixed set of small ops
# whatever its width, so the last log2(BCR_BASE) levels cost more than a
# tiny unrolled dense factor (8*2=16 unrolls completely in ldlt_factor).
# Chosen on the earlier accelerator, not yet re-derived on the GPU.
BCR_BASE = 8

# the hybrid regime (bcr_factor(..., base=..., root_lin=...)): stop after
# just a few levels and hand the remaining dense (base*q) system to the
# mixed-precision f32 tier — each level is a fixed ~10 small XLA ops
# while one dense root is a few GEMM-rich kernels, so a shallow reduction
# + one big dense root can beat both the deep reduction (level latency)
# and the full dense factor (O(m^3)).  Chosen on the earlier accelerator,
# not yet re-derived on the GPU.  Env-tunable so the
# control benchmark can sweep the level-count/root-size tradeoff per
# subprocess (benchmarks/bench_control.py)
BCR_HYBRID_BASE = int(os.environ.get("PGF_BCR_HYBRID_BASE", 256))


def _btd_to_dense(d, u):
    """Assemble a (mb*q, mb*q) dense matrix from block-tridiagonal bands
    (symmetric: subdiagonal = upper^T)."""
    mb, q = d.shape[0], d.shape[1]
    idx = jnp.arange(mb)
    S = jnp.zeros((mb, q, mb, q), dtype=d.dtype)
    S = S.at[idx, :, idx, :].set(d)
    if mb > 1:
        S = S.at[idx[:-1], :, idx[:-1] + 1, :].set(u[: mb - 1])
        S = S.at[idx[:-1] + 1, :, idx[:-1], :].set(
            jnp.swapaxes(u[: mb - 1], 1, 2)
        )
    return S.reshape(mb * q, mb * q)


def _solve_mats(facts, B):
    """Batched solve C_i X_i = B_i for (H, q, k) rhs."""
    return jax.vmap(_solve_mat)(facts, B)


def bcr_factor(diag, upper, base: int = BCR_BASE, root_lin=None) -> BCRFactor:
    """Cyclic-reduction factorization of a symmetric block-tridiagonal
    matrix.  Pads the block count to a power of two with decoupled -I
    blocks (keeps negative definiteness, changes nothing else).

    ``base`` stops the reduction once that few block-rows remain;
    ``root_lin`` (a dense LinearSolver, e.g. the mixed f32 tier) factors
    the remaining dense (base*q) system — the hybrid shallow-BCR regime
    for long horizons.  Falls back to the unrolled/blocked LDL^T root
    when ``root_lin`` is None or the base size doesn't fit its tiling."""
    m_blocks, q = diag.shape[0], diag.shape[1]
    mp = 1 << (m_blocks - 1).bit_length()
    if mp != m_blocks:
        pad = mp - m_blocks
        eye = jnp.broadcast_to(-jnp.eye(q, dtype=diag.dtype), (pad, q, q))
        diag = jnp.concatenate([diag, eye], axis=0)
    # upper as (mp, q, q) with upper[i] coupling (i, i+1); last entry 0
    zero = jnp.zeros((1, q, q), dtype=diag.dtype)
    up = jnp.concatenate(
        [upper] + [zero] * (mp - upper.shape[0]), axis=0
    )

    levels = []
    d, u = diag, up
    m_cur = mp
    while m_cur > base:
        h = m_cur // 2
        d_odd = d[1::2]  # (h, q, q)
        facts_odd = jax.vmap(ldlt_factor)(d_odd)

        a_left = jnp.concatenate([zero, u[1::2][:-1]], axis=0) if h > 1 else zero
        a_right = u[0::2]  # (h, q, q) U[2t]
        b_right = u[1::2]  # (h, q, q) U[2t+1]; last is the zero pad
        # note: u[1::2][t] = U[2t+1]; the shift gives a_left[t] = U[2t-1]

        levels.append(
            BCRLevel(
                facts_odd=facts_odd,
                a_left=a_left,
                a_right=a_right,
                b_right=b_right,
            )
        )

        # X_l[t] = F_{t-1}^{-1} A_left[t]  (garbage at t=0, masked by A=0)
        x_left = _solve_mats(jnp.roll(facts_odd, 1, axis=0), a_left)
        x_right = _solve_mats(facts_odd, jnp.swapaxes(a_right, 1, 2))

        d_even = d[0::2]
        d_new = (
            d_even
            - jnp.einsum("tij,tik->tjk", a_left, x_left)
            - jnp.einsum("tij,tkj->tik", a_right, jnp.swapaxes(x_right, 1, 2))
        )
        # U'_t = -A_right[t] F_t^{-1} B_right[t]
        u_new = -jnp.einsum(
            "tij,tjk->tik", a_right, _solve_mats(facts_odd, b_right)
        )

        d, u = d_new, u_new
        m_cur = h

    root_dense = _btd_to_dense(d, u)
    nroot = m_cur * q
    if root_lin is not None and nroot % 128 == 0:
        root_fact = root_lin.factor(root_dense)
        root_kind = "lin"
    else:
        root_fact = (
            ldlt_factor(root_dense)
            if nroot <= 192
            else ldlt_factor_blocked(root_dense)
        )
        root_kind = "ldlt"
    return BCRFactor(
        levels=tuple(levels),
        root_fact=root_fact,
        m_blocks=m_blocks,
        q=q,
        m_base=m_cur,
        root_kind=root_kind,
    )


def bcr_solve(fact: BCRFactor, rhs, root_solve=None):
    """Solve T x = rhs for rhs of shape (M, q) or flattened (M*q,).

    ``root_solve(root_fact, rhs) -> sol`` must be supplied when the
    factorization was built with an external ``root_lin`` tier."""
    m_blocks, q = fact.m_blocks, fact.q
    flat = rhs.ndim == 1
    r = rhs.reshape(m_blocks, q)
    mp = 1 << (m_blocks - 1).bit_length()
    if mp != m_blocks:
        r = jnp.concatenate(
            [r, jnp.zeros((mp - m_blocks, q), dtype=r.dtype)], axis=0
        )

    # down-sweep: reduce rhs level by level, stashing the odd parts
    odd_rhs = []
    for lev in fact.levels:
        b_odd = r[1::2]  # (h, q)
        odd_rhs.append(b_odd)
        f_inv_b = jax.vmap(ldlt_solve)(lev.facts_odd, b_odd)  # (h, q)
        r = (
            r[0::2]
            - jnp.einsum("tij,ti->tj", lev.a_left, jnp.roll(f_inv_b, 1, axis=0))
            - jnp.einsum("tij,tj->ti", lev.a_right, f_inv_b)
        )

    # dense base solve on the remaining m_base block-rows
    if fact.root_kind == "lin":
        assert root_solve is not None, "external root tier needs root_solve"
        x = root_solve(fact.root_fact, r.reshape(-1)).reshape(fact.m_base, q)
    else:
        x = ldlt_solve(fact.root_fact, r.reshape(-1)).reshape(fact.m_base, q)

    # up-sweep: recover odd blocks, interleave with evens
    for lev, b_odd in zip(reversed(fact.levels), reversed(odd_rhs)):
        h = b_odd.shape[0]
        x_right = jnp.concatenate(
            [x[1:], jnp.zeros((1, q), dtype=x.dtype)], axis=0
        )  # x[t+1] for odd t's right even neighbor (0 beyond the end)
        rhs_odd = (
            b_odd
            - jnp.einsum("tij,ti->tj", lev.a_right, x)
            - jnp.einsum("tij,tj->ti", lev.b_right, x_right)
        )
        x_odd = jax.vmap(ldlt_solve)(lev.facts_odd, rhs_odd)
        x = jnp.stack([x, x_odd], axis=1).reshape(2 * h, q)

    x = x[:m_blocks]
    return x.reshape(-1) if flat else x
