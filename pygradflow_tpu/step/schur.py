"""Schur-complement step solver for block-structured KKT systems.

SURVEY §7.5c: optimal-control and other *separable* problems have a
block-diagonal Lagrangian Hessian (per-stage blocks).  Exploiting that, the
scaled saddle system

    [[H + lambda I   J^T ]  [sx]   [rx']
     [J             -c I ]] [sy] = [ry']

is solved by eliminating the primal block: with ``A = H + lambda I`` block
diagonal, ``A^{-1}`` is a batch of small dense factorizations (vmapped
LDL^T), the dual Schur complement

    S = -c I - J A^{-1} J^T       (m x m, dense)

is assembled with two batched matmuls, and the back-substitution costs two
more.  Active-set masking uses the identity-row/column trick *within*
blocks, so shapes stay static.

The distributed variant (``parallel/schur.py``) shards the blocks over a
device mesh and assembles ``S`` with a ``psum`` over the block axis.

Enabled by ``Params(step_solver_type=StepSolverType.Schur,
schur_block_size=b)`` where the (transformed) problem's Hessian is block
diagonal with contiguous ``b x b`` blocks (slack variables appended by the
transform form extra diagonal entries, which are blocks of any size — the
requirement is only that ``H[i, j] = 0`` when ``i // b != j // b``).
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from .. import implicit_func as impl
from ..iterate import Iterate
from ..linalg.blocked_ldlt import ldlt_factor_blocked
from ..linalg.ldlt import ldlt_factor, ldlt_solve
from .solvers import Factorization, StepSolverDef, _lower_block


class SchurFactors(NamedTuple):
    block_inv: Any  # (nb, b, b) explicit inverses of the masked A blocks
    s_fact: Any  # factor of the dual Schur complement
    jac_masked: Any  # J with active columns zeroed (f64)
    ainv_jt: Any  # A^{-1} J^T, reused in back-substitution (n, m)
    # (nb, b, b) diagonal blocks of the masked primal matrix in f64 for
    # mixed-precision refinement (the full M11 IS block diagonal — the
    # Schur path requires a block-diagonal Hessian — so the residual
    # matvec is a batched small GEMM, not a dense n^2 f64 matvec)
    m11_blocks: Any


def _block_diag_blocks(H, b):
    """Extract contiguous (b, b) diagonal blocks of an (n, n) matrix."""
    n = H.shape[0]
    nb = n // b
    return H.reshape(nb, b, nb, b)[jnp.arange(nb), :, jnp.arange(nb), :]


def _block_inverses(blocks):
    """Explicit inverses of a batch of small (b, b) blocks via the
    unrolled LDL^T (the blocks are lambda-shifted Hessian blocks or
    identity rows — well conditioned by construction).

    Rationale: batched *substitution* solves with b=3 are 3-wide sequential
    sweeps; with explicit inverses every application becomes one batched
    GEMM."""
    b = blocks.shape[-1]
    eye = jnp.eye(b, dtype=blocks.dtype)

    def inv_one(blk):
        fact = ldlt_factor(blk)
        return ldlt_solve(fact, eye).T  # columns solve C x = e_j

    return jax.vmap(inv_one)(blocks)


def _blocks_apply(block_inv, v, b):
    """Apply the block-diagonal A^{-1} to a vector (n,) or matrix (n, k)
    as one batched GEMM."""
    n = v.shape[0]
    nb = n // b
    if v.ndim == 1:
        return jnp.einsum("rij,rj->ri", block_inv, v.reshape(nb, b)).reshape(n)
    k = v.shape[1]
    vb = v.reshape(nb, b, k)
    return jnp.einsum("rij,rjk->rik", block_inv, vb).reshape(n, k)


def schur_def(
    lin, report_rcond: bool, block_size: int, dual_block=None
) -> StepSolverDef:
    """``lin`` is the configured dense LinearSolver for the dual Schur
    complement, or None for the default f64 LDL^T path.  Passing the
    ``PallasLDLT`` (mixed-precision) tier factors ``S`` in f32 with f64
    iterative refinement on the back-solve.

    ``dual_block`` (``params.schur_dual_block_size``): when the problem's
    constraints are stage-local (each couples at most two adjacent
    stages), ``S`` is symmetric block *tridiagonal* with (dual_block,
    dual_block) blocks and is factored in O(m) with the block-Thomas
    sweeps of ``linalg/block_tridiag.py`` instead of O(m^3) dense —
    the JAX equivalent of the reference's sparse LU on banded
    optimal-control KKT systems."""
    b = int(block_size)
    has_pallas = lin is not None and lin.name == "pallas_ldlt"
    use_lin = dual_block is None and has_pallas
    use_btd = dual_block is not None
    # mixed precision: f32 block inverses / Schur assembly / elimination,
    # f64 accuracy recovered by iterative refinement on the masked saddle
    # system in solve().  Applied to both dual tiers that use the
    # mixed-precision LinearSolver: dense (use_lin) and block-tridiag
    # (use_btd).  Every f32 product is traced at full precision
    # (``jit.full_f32``)
    mixed = has_pallas and (use_lin or use_btd)

    def factor(func: impl.StepFunc, H, J, active, rho):
        lamb = func.lamb
        n = H.shape[0]
        m = J.shape[0]
        dtype = H.dtype
        assert n % b == 0, f"schur_block_size {b} must divide n={n}"

        Hl = H + lamb * jnp.eye(n, dtype=dtype)

        # symmetric active-set masking: identity rows+cols for active vars
        inact = jnp.logical_not(active)
        both_inact = jnp.logical_and(inact[:, None], inact[None, :])
        M11 = jnp.where(both_inact, Hl, 0.0) + jnp.diag(active.astype(dtype))
        Jm = jnp.where(inact[None, :], J, 0.0)  # active columns zeroed

        work_dtype = jnp.float32 if mixed else dtype
        M11w = M11.astype(work_dtype)
        Jmw = Jm.astype(work_dtype)

        blocks = _block_diag_blocks(M11w, b)
        block_inv = _block_inverses(blocks)

        ainv_jt = _blocks_apply(block_inv, Jmw.T, b)  # (n, m)

        if use_btd:
            # band-only Schur assembly: with stage-local constraints only
            # the tridiagonal blocks of S are nonzero, so assembling the
            # dense (m, m) product Jm @ ainv_jt would waste O(m^2 n)
            # work on known zeros.  Build the (M, q, q) diagonal and
            # (M-1, q, q) super-diagonal bands directly: O(M q^2 n).
            from ..linalg.block_tridiag import BCR_HYBRID_BASE, bcr_factor

            q = int(dual_block)
            mb = m // q
            fact_s = 1.0 / (1.0 + lamb * rho)
            jb = Jmw.reshape(mb, q, n)
            ab = ainv_jt.reshape(n, mb, q)
            diag = -jnp.einsum("rqn,nrp->rqp", jb, ab) - jnp.asarray(
                lamb * fact_s, work_dtype
            ) * jnp.eye(q, dtype=work_dtype)
            upper = -jnp.einsum("rqn,nrp->rqp", jb[:-1], ab[:, 1:])
            # hybrid shallow reduction + dense f32 root when the mixed
            # tier is configured (see BCR_HYBRID_BASE)
            s_fact = bcr_factor(
                diag,
                upper,
                base=BCR_HYBRID_BASE if has_pallas else 8,
                root_lin=lin if has_pallas else None,
            )
        elif use_lin:
            # lamb is a traced f64 scalar; build the diagonal block in f64
            # (O(m^2) trivia) and cast so the big GEMM stays in f32
            S = _lower_block(m, lamb, rho, dtype).astype(work_dtype) - Jmw @ ainv_jt
            s_fact = lin.factor(S)
        else:
            S = _lower_block(m, lamb, rho, dtype) - Jm @ ainv_jt
            # dense dual factorization: blocked (GEMM trailing updates)
            # above a few hundred rows, the rank-1 sweep below
            s_fact = ldlt_factor_blocked(S) if m > 192 else ldlt_factor(S)

        return Factorization(
            fact=SchurFactors(
                block_inv=block_inv,
                s_fact=s_fact,
                jac_masked=Jmw,
                ainv_jt=ainv_jt,
                m11_blocks=_block_diag_blocks(M11, b) if mixed else None,
            ),
            active=active,
            hess_shifted=Hl,
            jac=J,
            inertia_ok=jnp.array(True),
            rcond=jnp.full((), jnp.nan, dtype=dtype),
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        lamb = func.lamb
        dt = 1.0 / lamb
        pfact = 1.0 / (1.0 + lamb * rho)

        rx, ry = impl.value_at(func, it, rho, f.active)

        # condensed rhs like the symmetric solver: active entries pinned
        b0_full = jnp.where(f.active, dt * rx, 0.0)
        rhs_x = jnp.where(f.active, b0_full, rx - f.hess_shifted @ b0_full)
        rhs_y = pfact * ry - f.jac @ b0_full

        sf: SchurFactors = f.fact

        def eliminate(rx_, ry_):
            """Block-elimination solve of the masked saddle system in the
            factorization's working precision."""
            az = _blocks_apply(sf.block_inv, rx_, b)
            s_rhs = ry_ - sf.jac_masked @ az
            if use_btd:
                from ..linalg.block_tridiag import bcr_solve

                # raw f32 root back-solve under the mixed tier: the
                # outer saddle refinement recovers f64
                root_solve = (
                    (lambda fct, b_: lin.solve(fct, b_, iters=0))
                    if has_pallas
                    else None
                )
                sy_ = bcr_solve(sf.s_fact, s_rhs, root_solve=root_solve)
            elif use_lin:
                if mixed:
                    # raw f32 back-solve: the outer saddle refinement
                    # below recovers f64, the tier's inner refinement
                    # passes would be redundant work
                    sy_ = lin.solve(sf.s_fact, s_rhs, iters=0)
                else:
                    sy_ = lin.solve(sf.s_fact, s_rhs)
            else:
                sy_ = ldlt_solve(sf.s_fact, s_rhs)
            return az - sf.ainv_jt @ sy_, sy_

        if mixed:
            # f32 elimination + f64 iterative refinement on the masked
            # saddle system [[M11, Jm^T], [Jm, -lamb*pfact*I]]
            dtype = rx.dtype
            wd = sf.jac_masked.dtype

            def inner(rx_, ry_):
                sx_, sy_ = eliminate(rx_.astype(wd), ry_.astype(wd))
                return sx_.astype(dtype), sy_.astype(dtype)

            inact = jnp.logical_not(f.active)
            jm64 = jnp.where(inact[None, :], f.jac, 0.0)
            mu = lamb * pfact

            # one refinement pass: the f32 elimination gives ~1e-6
            # relative error and each pass restores ~5-6 digits against
            # the f64 saddle system (-> ~1e-11, well past the 1e-8
            # trajectory-parity bar; verified in tests/test_schur.py).
            # The M11 residual term rides the block structure: a batched
            # (nb, b, b) GEMM instead of a dense n^2 f64 matvec
            sx, sy = inner(rhs_x, rhs_y)
            for _ in range(1):
                r_x = rhs_x - _blocks_apply(sf.m11_blocks, sx, b) - jm64.T @ sy
                r_y = rhs_y - jm64 @ sx + mu * sy
                cx, cy = inner(r_x, r_y)
                sx = sx + cx
                sy = sy + cy
        else:
            sx, sy = eliminate(rhs_x, rhs_y)

        dx = sx
        dy = pfact * (sy - rho * ry)
        return dx, dy

    return StepSolverDef(
        scaled=True,
        symmetric=True,
        hess_rho_is_runtime=False,
        factor=factor,
        solve=solve,
    )
