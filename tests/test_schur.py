"""Schur-complement step solver: block-diagonal Hessian elimination must
reproduce the dense symmetric solver's trajectory exactly."""

import jax.numpy as jnp
import numpy as np

from pygradflow_tpu import Params, Solver, StepSolverType
from pygradflow_tpu.problem import Problem


class SeparableCoupled(Problem):
    """Sum of per-block quartics (block-diagonal Hessian, blocks of 2)
    coupled through linear equality constraints."""

    NB = 6  # number of 2-blocks

    def __init__(self):
        n = 2 * self.NB
        lb = np.full(n, -2.0)
        ub = np.full(n, 2.0)
        super().__init__(lb, ub, num_cons=2)

    def obj(self, x):
        x2 = x.reshape(self.NB, 2)
        # per-block: rosenbrock-ish quartic (no cross-block terms)
        return jnp.sum(
            (1.0 - x2[:, 0]) ** 2 + 5.0 * (x2[:, 1] - x2[:, 0] ** 2) ** 2
        )

    def cons(self, x):
        return jnp.array([jnp.sum(x) - 3.0, x[0] - x[2]])


def _solve(step_solver_type, **kw):
    params = Params(step_solver_type=step_solver_type, **kw)
    problem = SeparableCoupled()
    return Solver(problem, params).solve(np.zeros(12))


def test_schur_matches_symmetric():
    ref = _solve(StepSolverType.Symmetric)
    schur = _solve(StepSolverType.Schur, schur_block_size=2)

    assert ref.success and schur.success
    assert schur.iterations == ref.iterations
    np.testing.assert_allclose(schur.x, ref.x, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(schur.y, ref.y, rtol=1e-8, atol=1e-10)


def test_schur_requires_block_size():
    import pytest

    with pytest.raises(AssertionError):
        _solve(StepSolverType.Schur)


def test_distributed_schur_matches_dense():
    """Sharded psum-assembled Schur solve == dense solve (8-device CPU mesh)."""
    import jax
    from pygradflow_tpu.parallel.schur import distributed_schur_solve

    if len(jax.devices()) < 2:
        import pytest

        pytest.skip("needs a multi-device mesh")

    rng = np.random.default_rng(3)
    nb, b, m = 16, 4, 6
    n = nb * b

    blocks = []
    for _ in range(nb):
        Bk = rng.standard_normal((b, b))
        blocks.append(Bk @ Bk.T + b * np.eye(b))
    h_blocks = np.stack(blocks)
    A = np.zeros((n, n))
    for k in range(nb):
        A[k * b : (k + 1) * b, k * b : (k + 1) * b] = h_blocks[k]

    J = rng.standard_normal((m, n))
    M22 = -0.7 * np.eye(m)
    rhs_x = rng.standard_normal(n)
    rhs_y = rng.standard_normal(m)

    K = np.block([[A, J.T], [J, M22]])
    dense = np.linalg.solve(K, np.concatenate([rhs_x, rhs_y]))

    sx, sy = distributed_schur_solve(
        jnp.asarray(h_blocks), jnp.asarray(J), jnp.asarray(M22),
        jnp.asarray(rhs_x), jnp.asarray(rhs_y),
    )

    np.testing.assert_allclose(np.asarray(sx), dense[:n], rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(sy), dense[n:], rtol=1e-9, atol=1e-10)


def test_block_tridiag_solve_matches_dense():
    """Block-Thomas factor/solve vs a dense solve on a random symmetric
    negative-definite block-tridiagonal matrix."""
    from pygradflow_tpu.linalg.block_tridiag import (
        btd_factor,
        btd_solve,
        dense_to_btd,
    )

    rng = np.random.default_rng(5)
    M, q = 37, 2
    m = M * q
    S = np.zeros((m, m))
    for i in range(M):
        B = rng.standard_normal((q, q))
        S[i * q : (i + 1) * q, i * q : (i + 1) * q] = -(B @ B.T + 5 * np.eye(q))
    for i in range(M - 1):
        U = 0.3 * rng.standard_normal((q, q))
        S[i * q : (i + 1) * q, (i + 1) * q : (i + 2) * q] = U
        S[(i + 1) * q : (i + 2) * q, i * q : (i + 1) * q] = U.T
    rhs = rng.standard_normal(m)

    fact = btd_factor(*dense_to_btd(jnp.asarray(S), q))
    x = btd_solve(fact, jnp.asarray(rhs))
    np.testing.assert_allclose(
        np.asarray(x), np.linalg.solve(S, rhs), rtol=1e-10, atol=1e-12
    )


def test_pendulum_schur_btd_matches_dense():
    """The block-tridiagonal dual solver must reproduce the dense Schur
    trajectory on the interleaved pendulum (whose per-stage constraint
    ordering makes S exactly block tridiagonal with 2x2 blocks)."""
    from pygradflow_tpu.runners.control import PendulumControlInterleaved

    p = PendulumControlInterleaved(N=16)
    x0 = p.x0_trajectory()
    common = dict(
        step_solver_type=StepSolverType.Schur,
        schur_block_size=3,
        validate_input=False,
    )
    r_dense = Solver(p, Params(**common)).solve(x0)
    r_btd = Solver(p, Params(schur_dual_block_size=2, **common)).solve(x0)

    assert r_dense.status == r_btd.status
    assert r_dense.iterations == r_btd.iterations
    np.testing.assert_allclose(
        np.asarray(r_btd.x), np.asarray(r_dense.x), rtol=1e-9, atol=1e-10
    )


def test_pendulum_schur_btd_mixed_precision():
    """f32 cyclic-reduction elimination + f64 saddle refinement
    (``schur_dual_block_size`` + ``LinearSolverType.PallasLDLT``) must
    recover the f64 trajectory."""
    from pygradflow_tpu import LinearSolverType
    from pygradflow_tpu.runners.control import PendulumControlInterleaved

    p = PendulumControlInterleaved(N=16)
    x0 = p.x0_trajectory()
    common = dict(
        step_solver_type=StepSolverType.Schur,
        schur_block_size=3,
        validate_input=False,
    )
    r_dense = Solver(p, Params(**common)).solve(x0)
    r_mixed = Solver(
        p,
        Params(
            schur_dual_block_size=2,
            linear_solver_type=LinearSolverType.PallasLDLT,
            **common,
        ),
    ).solve(x0)

    assert r_dense.status == r_mixed.status
    assert r_dense.iterations == r_mixed.iterations
    np.testing.assert_allclose(
        np.asarray(r_mixed.x), np.asarray(r_dense.x), rtol=1e-8, atol=1e-9
    )


def test_pendulum_schur_dense_dual_mixed_precision():
    """The DENSE dual tier with PallasLDLT now also runs f32 block
    inverses/assembly/elimination with f64 saddle refinement; the
    trajectory must still match the all-f64 dense Schur path."""
    from pygradflow_tpu import LinearSolverType
    from pygradflow_tpu.runners.control import PendulumControlInterleaved

    p = PendulumControlInterleaved(N=16)
    x0 = p.x0_trajectory()
    common = dict(
        step_solver_type=StepSolverType.Schur,
        schur_block_size=3,
        validate_input=False,
    )
    r_dense = Solver(p, Params(**common)).solve(x0)
    r_mixed = Solver(
        p,
        Params(linear_solver_type=LinearSolverType.PallasLDLT, **common),
    ).solve(x0)

    assert r_dense.status == r_mixed.status
    assert r_dense.iterations == r_mixed.iterations
    np.testing.assert_allclose(
        np.asarray(r_mixed.x), np.asarray(r_dense.x), rtol=1e-8, atol=1e-9
    )


def test_bcr_solve_matches_dense():
    """Cyclic-reduction factor/solve vs a dense solve, covering both the
    base-only path (mb <= BCR_BASE: no reduction levels, one dense
    unrolled factor) and the leveled path (mb >> BCR_BASE)."""
    from pygradflow_tpu.linalg.block_tridiag import (
        BCR_BASE,
        bcr_factor,
        bcr_solve,
        dense_to_btd,
    )

    rng = np.random.default_rng(11)
    for M, q in [(5, 2), (37, 2), (21, 3)]:
        m = M * q
        S = np.zeros((m, m))
        for i in range(M):
            B = rng.standard_normal((q, q))
            S[i * q : (i + 1) * q, i * q : (i + 1) * q] = -(
                B @ B.T + 5 * np.eye(q)
            )
        for i in range(M - 1):
            U = 0.3 * rng.standard_normal((q, q))
            S[i * q : (i + 1) * q, (i + 1) * q : (i + 2) * q] = U
            S[(i + 1) * q : (i + 2) * q, i * q : (i + 1) * q] = U.T
        rhs = rng.standard_normal(m)

        fact = bcr_factor(*dense_to_btd(jnp.asarray(S), q))
        if M <= BCR_BASE:
            assert len(fact.levels) == 0  # base-only path
        else:
            assert len(fact.levels) > 0
        x = bcr_solve(fact, jnp.asarray(rhs))
        np.testing.assert_allclose(
            np.asarray(x), np.linalg.solve(S, rhs), rtol=1e-9, atol=1e-11
        )


def test_bcr_hybrid_base_matches_thomas():
    """Shallow reduction + dense root (incl. the external mixed-tier
    root) must agree with the sequential block-Thomas factorization."""
    import numpy as np

    from pygradflow_tpu.linalg import LinearSolverType, linear_solver
    from pygradflow_tpu.linalg.block_tridiag import (
        bcr_factor,
        bcr_solve,
        btd_factor,
        btd_solve,
    )

    rng = np.random.default_rng(5)
    mb, q = 67, 2  # odd count: exercises the power-of-two padding
    diag = rng.standard_normal((mb, q, q))
    diag = -(diag @ diag.transpose(0, 2, 1)) - 2.0 * np.eye(q)  # neg def
    upper = 0.1 * rng.standard_normal((mb - 1, q, q))
    rhs = rng.standard_normal(mb * q)

    ref = btd_solve(btd_factor(jnp.asarray(diag), jnp.asarray(upper)), jnp.asarray(rhs))

    for base, root_lin in [(8, None), (32, None), (64, None)]:
        fact = bcr_factor(
            jnp.asarray(diag), jnp.asarray(upper), base=base, root_lin=root_lin
        )
        sol = bcr_solve(fact, jnp.asarray(rhs))
        np.testing.assert_allclose(np.asarray(sol), np.asarray(ref), rtol=1e-10)

    # external root tier (f32 factor + f64 refinement):
    # root size 32*q=64 is not 128-aligned, so pad the problem to 64 blocks
    mb2 = 128
    diag2 = rng.standard_normal((mb2, q, q))
    diag2 = -(diag2 @ diag2.transpose(0, 2, 1)) - 2.0 * np.eye(q)
    upper2 = 0.1 * rng.standard_normal((mb2 - 1, q, q))
    rhs2 = rng.standard_normal(mb2 * q)
    ref2 = btd_solve(
        btd_factor(jnp.asarray(diag2), jnp.asarray(upper2)), jnp.asarray(rhs2)
    )
    lin = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)
    fact2 = bcr_factor(
        jnp.asarray(diag2), jnp.asarray(upper2), base=64, root_lin=lin
    )
    sol2 = bcr_solve(
        fact2, jnp.asarray(rhs2), root_solve=lambda f, b: lin.solve(f, b)
    )
    np.testing.assert_allclose(np.asarray(sol2), np.asarray(ref2), rtol=1e-6)
