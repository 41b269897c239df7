"""Matrix-free staged Schur: probe-extracted stage blocks and banded
elimination must reproduce the dense Schur path's trajectory (which in
turn matches the dense symmetric solver, ``test_schur.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pygradflow_tpu import LinearSolverType, NewtonType, Params, Solver, StepSolverType
from pygradflow_tpu.runners.control import PendulumControlInterleaved

COMMON = dict(iteration_limit=500, validate_input=False)


def _params(matrix_free, **kw):
    return Params(
        step_solver_type=StepSolverType.Schur,
        schur_block_size=3,
        schur_dual_block_size=2,
        matrix_free=matrix_free,
        **COMMON,
        **kw,
    )


def test_extracted_blocks_match_dense():
    """Probe extraction == slicing the dense autodiff derivatives."""
    from pygradflow_tpu.eval import make_fns
    from pygradflow_tpu.iterate import evaluate_iterate
    from pygradflow_tpu.step.schur_staged import _extract_stage_data

    N = 13
    prob = PendulumControlInterleaved(N=N)
    params = _params(False)
    fns = make_fns(prob, params)
    rng = np.random.default_rng(0)
    x = jnp.asarray(prob.x0_trajectory() + 0.1 * rng.standard_normal(prob.num_vars))
    y = jnp.asarray(rng.standard_normal(prob.num_cons))
    it = evaluate_iterate(fns, x, y)

    b, q = 3, 2
    hblocks, jd, jsub = _extract_stage_data(fns, it, b, q)

    H = np.asarray(fns.lag_hess(x, y))
    J = np.asarray(fns.cons_jac(x))
    nb, mb = prob.num_vars // b, prob.num_cons // q
    for r in range(nb):
        np.testing.assert_allclose(
            np.asarray(hblocks)[r], H[r * b : (r + 1) * b, r * b : (r + 1) * b],
            rtol=1e-12, atol=1e-14,
        )
    for r in range(mb):
        np.testing.assert_allclose(
            np.asarray(jd)[r], J[r * q : (r + 1) * q, r * b : (r + 1) * b],
            rtol=1e-12, atol=1e-14,
        )
        expect_sub = (
            np.zeros((q, b))
            if r == 0
            else J[r * q : (r + 1) * q, (r - 1) * b : r * b]
        )
        np.testing.assert_allclose(
            np.asarray(jsub)[r], expect_sub, rtol=1e-12, atol=1e-14
        )


def test_staged_matches_dense_schur():
    """Full-solve parity on the pendulum swing-up: identical iteration
    counts, solutions to 1e-9."""
    prob = PendulumControlInterleaved(N=24)
    x0 = prob.x0_trajectory()
    ref = Solver(prob, _params(False)).solve(x0)
    staged = Solver(prob, _params(True)).solve(x0)

    assert ref.success and staged.success
    assert staged.iterations == ref.iterations
    np.testing.assert_allclose(staged.x, ref.x, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(staged.y, ref.y, rtol=1e-8, atol=1e-10)


def test_staged_pallas_tier_matches():
    """Mixed-precision staged path (f32 root + f64 refinement) must
    track the f64 staged path."""
    prob = PendulumControlInterleaved(N=24)
    x0 = prob.x0_trajectory()
    ref = Solver(prob, _params(True)).solve(x0)
    mixed = Solver(
        prob, _params(True, linear_solver_type=LinearSolverType.PallasLDLT)
    ).solve(x0)

    assert ref.success and mixed.success
    np.testing.assert_allclose(mixed.x, ref.x, rtol=1e-7, atol=1e-9)


def test_staged_other_newton_types():
    """Full and ActiveSet Newton re-probe each step; trajectories must
    still match the dense Schur path variant-for-variant."""
    prob = PendulumControlInterleaved(N=16)
    x0 = prob.x0_trajectory()
    for nt in (NewtonType.Full, NewtonType.ActiveSet):
        ref = Solver(prob, _params(False, newton_type=nt)).solve(x0)
        staged = Solver(prob, _params(True, newton_type=nt)).solve(x0)
        assert staged.iterations == ref.iterations, nt
        np.testing.assert_allclose(staged.x, ref.x, rtol=1e-8, atol=1e-10)


def test_staged_batched_matches_single():
    """Lockstep-batched staged solves == per-instance staged solves."""
    from pygradflow_tpu.parallel.batch import BatchedSolver

    prob = PendulumControlInterleaved(N=12)
    rng = np.random.default_rng(3)
    base = prob.x0_trajectory()
    x0 = np.stack([base + 0.02 * rng.standard_normal(base.shape) for _ in range(4)])

    params = _params(True)
    res = BatchedSolver(prob, params).solve(x0)
    assert bool(res.success.all())

    for i in range(4):
        ri = Solver(prob, params).solve(x0[i])
        np.testing.assert_allclose(res.x[i], ri.x, rtol=1e-9, atol=1e-11)
        assert int(res.iterations[i]) == ri.iterations


def test_matrix_free_requires_schur():
    prob = PendulumControlInterleaved(N=8)
    with pytest.raises(ValueError, match="matrix_free requires"):
        Solver(
            prob,
            Params(
                step_solver_type=StepSolverType.Symmetric,
                matrix_free=True,
                **COMMON,
            ),
        )


def test_matrix_free_rejects_globalized():
    prob = PendulumControlInterleaved(N=8)
    with pytest.raises(ValueError, match="Globalized"):
        Solver(prob, _params(True, newton_type=NewtonType.Globalized))


def test_matrix_free_jacobian_never_materialized():
    """The dense cons_jac closure must not be traced into the solve loop:
    evaluate_iterate stores a (0, n) placeholder in matrix-free mode."""
    from pygradflow_tpu.eval import make_fns
    from pygradflow_tpu.iterate import evaluate_iterate

    prob = PendulumControlInterleaved(N=8)
    fns = make_fns(prob, _params(True))
    x = jnp.asarray(prob.x0_trajectory())
    it = evaluate_iterate(fns, x, jnp.zeros(prob.num_cons))
    assert it.cons_jac.shape == (0, prob.num_vars)
