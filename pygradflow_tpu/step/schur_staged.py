"""Matrix-free staged Schur step solver for long-horizon optimal control.

The dense Schur path (``step/schur.py``) already exploits block structure
in the *factorization*, but still materializes O(n^2)/O(m n) objects every
outer iteration: the dense Lagrangian Hessian (via ``jacfwd`` of the
gradient), the dense constraint Jacobian, their n^2 active-set masks, and
the (n, m) elimination intermediates.  At horizon N=1024 (n=3075, m=2050,
f64) those are 50-75 MB apiece — the measured per-iteration cost scales
with them, not with the factorization (``benchmarks/artifacts/
r2_control_1024.json``; the reference wins that regime with SuperLU on the
banded KKT, ``pygradflow/linear_solver/lu_solver.py:19-21`` inside
``step/solver/symmetric_step_solver.py:129-158``).

This module removes every super-linear object.  Under the Schur tier's
structural contract —

- Lagrangian Hessian block diagonal with contiguous ``b x b`` stage blocks
  (``params.schur_block_size``), and
- stage-local constraints: dual block ``r`` (size ``q =
  params.schur_dual_block_size``) depends only on stage variables ``r-1``
  and ``r`` (block 0 only on stage 0), with equally many stages and dual
  blocks —

the step matrix is fully determined by O(N) data, which is extracted
directly by autodiff *probes* instead of slicing dense derivatives:

- ``b`` Hessian-vector products against comb vectors (1 at position ``j``
  of every stage) yield all ``(nb, b, b)`` diagonal blocks at the cost of
  one fused, vmapped Hessian evaluation;
- ``2 b`` Jacobian-vector products against parity combs (1 at position
  ``j`` of every *even* / *odd* stage) yield the block-bidiagonal bands
  ``Jd[r] = dc_r/dx_r`` and ``Jsub[r] = dc_r/dx_{r-1}`` — adjacent stages
  have opposite parity, so each probe isolates one band entry per
  constraint block.

Assembly, masking, the dual Schur band, and the entire back-substitution
are then batched ``(N, small, small)`` einsums; the band is factored by
the hybrid block-cyclic-reduction of ``linalg/block_tridiag.py`` (shallow
reduction + one dense root on the mixed-precision f32 tier, f64 recovered
by saddle-system iterative refinement exactly as in ``step/schur.py``).
Per-iteration cost drops from O(n^2) memory traffic to O(N).

Enabled by ``Params(matrix_free=True, step_solver_type=StepSolverType.
Schur, schur_block_size=b, schur_dual_block_size=q)``.  The KKT-residual
path (``implicit_func.value_at`` etc.) rides the same flag through
``Fns.cons_vjp`` so the dense Jacobian is never evaluated anywhere in the
solve loop (``iterate.evaluate_iterate`` stores a (0, n) placeholder).
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from .. import implicit_func as impl
from ..eval import Fns
from ..iterate import Iterate
from ..linalg.block_tridiag import BCR_HYBRID_BASE, bcr_factor, bcr_solve
from .schur import _block_inverses, _blocks_apply
from .solvers import Factorization, StepSolverDef


class StagedFactors(NamedTuple):
    block_inv: Any  # (nb, b, b) work-dtype inverses of the masked blocks
    s_fact: Any  # BCRFactor of the dual Schur band
    jd_m: Any  # (mb, q, b) masked own-stage Jacobian band, work dtype
    jsub_m: Any  # (mb, q, b) masked previous-stage band, work dtype
    jd: Any  # unmasked f64 bands (rhs condensation path)
    jsub: Any
    hl_blocks: Any  # (nb, b, b) unmasked H + lambda I blocks, f64
    # masked f64 data for the mixed-precision saddle refinement
    # (None in the pure-f64 regime)
    m11_blocks: Any
    jd_m64: Any
    jsub_m64: Any


def _band_apply(jd, jsub, v):
    """``J v`` for the block-bidiagonal band: block ``r`` reads
    ``jd[r] x_r + jsub[r] x_{r-1}``.  ``v`` is (n,), returns (m,)."""
    nb, _, b = jd.shape[0], jd.shape[1], jd.shape[2]
    vb = v.reshape(nb, b)
    own = jnp.einsum("rqb,rb->rq", jd, vb)
    prev = jnp.concatenate([vb[:1] * 0.0, vb[:-1]], axis=0)
    return (own + jnp.einsum("rqb,rb->rq", jsub, prev)).reshape(-1)


def _band_t_apply(jd, jsub, w):
    """``J^T w``: stage ``s`` collects ``jd[s]^T w_s + jsub[s+1]^T
    w_{s+1}``.  ``w`` is (m,), returns (n,)."""
    mb, q = jd.shape[0], jd.shape[1]
    wb = w.reshape(mb, q)
    own = jnp.einsum("rqb,rq->rb", jd, wb)
    wn = jnp.concatenate([wb[1:], wb[:1] * 0.0], axis=0)
    jn = jnp.concatenate([jsub[1:], jsub[:1] * 0.0], axis=0)
    return (own + jnp.einsum("rqb,rq->rb", jn, wn)).reshape(-1)


def _extract_stage_data(fns: Fns, it: Iterate, b: int, q: int):
    """Probe out the Hessian stage blocks and Jacobian bands.

    Comb-basis trick: with H block diagonal, ``(H e_comb_j)`` restricted
    to stage ``r`` is column ``j`` of block ``r`` — ``b`` hvp probes
    recover every block.  With constraints stage-local, adjacent stages
    have opposite parity, so splitting the combs by stage parity isolates
    the two bands — ``2 b`` jvp probes.  All probes are vmapped: XLA sees
    one batched evaluation each, not ``3 b`` sequential ones.
    """
    n, m = fns.num_vars, fns.num_cons
    nb, mb = n // b, m // q
    x, y = it.x, it.y
    dtype = x.dtype

    eye_b = jnp.eye(b, dtype=dtype)
    combs = jnp.tile(eye_b, (1, nb))  # (b, n): 1 at position j of each stage

    hcols = jax.vmap(lambda v: fns.lag_hvp(x, y, v))(combs)  # (b, n)
    hblocks = hcols.reshape(b, nb, b).transpose(1, 2, 0)  # (nb, b, b)

    par = (jnp.arange(nb) % 2).astype(dtype)
    stage_combs = combs.reshape(b, nb, b)
    probes = jnp.stack(
        [
            (stage_combs * (1.0 - par)[None, :, None]).reshape(b, n),
            (stage_combs * par[None, :, None]).reshape(b, n),
        ]
    )  # (2, b, n): even-stage combs, odd-stage combs
    jcols = jax.vmap(jax.vmap(lambda v: fns.cons_jvp(x, v)))(probes)
    jc = jcols.reshape(2, b, mb, q)

    rpar = jnp.arange(mb) % 2
    ridx = jnp.arange(mb)
    # jc[p, j, r, i] = J[row i of block r, position j of the parity-p
    # stage it touches]; own stage of block r has parity r % 2
    jd = jc[rpar, :, ridx, :].transpose(0, 2, 1)  # (mb, q, b)
    jsub = jc[1 - rpar, :, ridx, :].transpose(0, 2, 1)
    # block 0 touches stage 0 only (no previous stage)
    jsub = jnp.concatenate([jsub[:1] * 0.0, jsub[1:]], axis=0)
    return hblocks, jd, jsub


def schur_staged_def(lin, fns: Fns, block_size: int, dual_block: int) -> StepSolverDef:
    """Matrix-free staged Schur ``StepSolverDef``.

    ``lin`` is the mixed-precision f32 dense tier for the BCR root (or None for
    pure f64 — CPU tests / small problems); mixed precision + saddle
    refinement mirror ``schur_def`` and were verified to reproduce its
    trajectories (``tests/test_schur_staged.py``).
    """
    b = int(block_size)
    q = int(dual_block)
    n, m = fns.num_vars, fns.num_cons
    assert n % b == 0, f"schur_block_size {b} must divide n={n}"
    assert m % q == 0, f"schur_dual_block_size {q} must divide m={m}"
    nb, mb = n // b, m // q
    assert nb == mb, (
        "staged Schur requires one dual block per stage "
        f"(got {nb} stages, {mb} dual blocks)"
    )
    has_pallas = lin is not None and lin.name == "pallas_ldlt"
    mixed = has_pallas

    def factor(func: impl.StepFunc, it: Iterate, active, rho):
        lamb = func.lamb
        dtype = it.x.dtype
        eye_b = jnp.eye(b, dtype=dtype)

        hblocks, jd, jsub = _extract_stage_data(fns, it, b, q)
        hl = hblocks + lamb * eye_b  # (nb, b, b)

        # symmetric active-set masking within stages (identity rows+cols
        # for active variables), as in schur.py but on O(N) data
        inact = jnp.logical_not(active).reshape(nb, b)
        act = active.reshape(nb, b)
        both = jnp.logical_and(inact[:, :, None], inact[:, None, :])
        m11 = jnp.where(both, hl, 0.0) + eye_b * act[:, None, :].astype(dtype)

        jd_m64 = jnp.where(inact[:, None, :], jd, 0.0)
        prev_inact = jnp.concatenate(
            [jnp.zeros_like(inact[:1]), inact[:-1]], axis=0
        )
        jsub_m64 = jnp.where(prev_inact[:, None, :], jsub, 0.0)

        work = jnp.float32 if mixed else dtype
        m11w = m11.astype(work)
        block_inv = _block_inverses(m11w)
        jdw = jd_m64.astype(work)
        jsw = jsub_m64.astype(work)

        # dual Schur band: S_rr = -mu I - (Jd_r Ainv_r Jd_r^T
        #   + Jsub_r Ainv_{r-1} Jsub_r^T), S_{r,r+1} = -Jd_r Ainv_r
        #   Jsub_{r+1}^T (shared stage r)
        fact_s = 1.0 / (1.0 + lamb * rho)
        mu = jnp.asarray(lamb * fact_s, work)
        ainv_prev = jnp.concatenate([block_inv[:1] * 0.0, block_inv[:-1]], axis=0)
        t_own = jnp.einsum("rqb,rbc,rpc->rqp", jdw, block_inv, jdw)
        t_sub = jnp.einsum("rqb,rbc,rpc->rqp", jsw, ainv_prev, jsw)
        diag = -(t_own + t_sub) - mu * jnp.eye(q, dtype=work)
        upper = -jnp.einsum("rqb,rbc,rpc->rqp", jdw[:-1], block_inv[:-1], jsw[1:])

        s_fact = bcr_factor(
            diag,
            upper,
            base=BCR_HYBRID_BASE if has_pallas else 8,
            root_lin=lin if has_pallas else None,
        )

        return Factorization(
            fact=StagedFactors(
                block_inv=block_inv,
                s_fact=s_fact,
                jd_m=jdw,
                jsub_m=jsw,
                jd=jd,
                jsub=jsub,
                hl_blocks=hl,
                m11_blocks=m11 if mixed else None,
                jd_m64=jd_m64 if mixed else None,
                jsub_m64=jsub_m64 if mixed else None,
            ),
            active=active,
            hess_shifted=None,  # banded data lives in fact; nothing dense
            jac=None,
            inertia_ok=jnp.array(True),
            rcond=jnp.full((), jnp.nan, dtype=dtype),
        )

    def solve(f: Factorization, func: impl.StepFunc, it: Iterate, rho):
        lamb = func.lamb
        dt = 1.0 / lamb
        pfact = 1.0 / (1.0 + lamb * rho)
        sf: StagedFactors = f.fact

        rx, ry = impl.value_at(func, it, rho, f.active, fns=fns)
        dtype = rx.dtype

        # condensed rhs (identical to schur.py, banded operators)
        b0_full = jnp.where(f.active, dt * rx, 0.0)
        hb0 = _blocks_apply(sf.hl_blocks, b0_full, b)
        rhs_x = jnp.where(f.active, b0_full, rx - hb0)
        rhs_y = pfact * ry - _band_apply(sf.jd, sf.jsub, b0_full)

        root_solve = (
            (lambda fct, b_: lin.solve(fct, b_, iters=0)) if has_pallas else None
        )

        def eliminate(rx_, ry_):
            az = _blocks_apply(sf.block_inv, rx_, b)
            s_rhs = ry_ - _band_apply(sf.jd_m, sf.jsub_m, az)
            sy_ = bcr_solve(sf.s_fact, s_rhs, root_solve=root_solve)
            jt_sy = _band_t_apply(sf.jd_m, sf.jsub_m, sy_)
            return az - _blocks_apply(sf.block_inv, jt_sy, b), sy_

        if mixed:
            wd = sf.jd_m.dtype

            def inner(rx_, ry_):
                sx_, sy_ = eliminate(rx_.astype(wd), ry_.astype(wd))
                return sx_.astype(dtype), sy_.astype(dtype)

            mu = lamb * pfact
            sx, sy = inner(rhs_x, rhs_y)
            # one f64 refinement pass on the masked saddle system — all
            # residual terms banded O(N) (cf. schur.py solve())
            for _ in range(1):
                r_x = (
                    rhs_x
                    - _blocks_apply(sf.m11_blocks, sx, b)
                    - _band_t_apply(sf.jd_m64, sf.jsub_m64, sy)
                )
                r_y = rhs_y - _band_apply(sf.jd_m64, sf.jsub_m64, sx) + mu * sy
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
        matrix_free=True,
    )
