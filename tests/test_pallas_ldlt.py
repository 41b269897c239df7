"""The mixed-precision LDL^T tier (``LinearSolverType.PallasLDLT``): plain
f32 factorization (``linalg/mixed_ldlt.py``) + f64 refinement + inertia,
and the f64 blocked factorization it is checked against."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pygradflow_tpu.linalg import linear_solver
from pygradflow_tpu.linalg.blocked_ldlt import ldlt_factor_blocked
from pygradflow_tpu.linalg.ldlt import (
    ldlt_factor,
    ldlt_num_neg_eigvals,
)
from pygradflow_tpu.linalg.mixed_ldlt import ldlt_factor_f32, refine_solve
from pygradflow_tpu.params import LinearSolverType

rng = np.random.default_rng(7)


def _saddle(n, m):
    H = rng.standard_normal((n, n))
    K = H @ H.T + n * np.eye(n)
    J = rng.standard_normal((m, n))
    return np.block([[K, J.T], [J, -0.1 * np.eye(m)]])


def _backward_error(A, x, b):
    """Normwise backward error ||Ax - b|| / (||A|| ||x||), inf-norms."""
    r = A @ x - b
    return np.abs(r).max() / (np.abs(A).sum(axis=-1).max() * np.abs(x).max())


def _split(size):
    n = (3 * size) // 4
    return n, size - n


@pytest.mark.parametrize("n,m", [(40, 12), (100, 28)])
def test_blocked_matches_unblocked(n, m):
    A = _saddle(n, m)
    f_blocked = np.asarray(ldlt_factor_blocked(jnp.asarray(A), block=32))
    f_ref = np.asarray(ldlt_factor(jnp.asarray(A)))
    # only the lower triangle + diagonal are defined (the strict upper
    # triangle holds algorithm-dependent leftovers in both variants)
    np.testing.assert_allclose(
        np.tril(f_blocked), np.tril(f_ref), rtol=1e-9, atol=1e-9
    )


def test_pallas_linear_solver_tier():
    """The tier's factor/solve/inertia through the ``linear_solver``
    factory: f64-accurate solve from the f32 factor, exact inertia."""
    lin = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)
    assert lin.name == "pallas_ldlt"
    A = _saddle(50, 14)
    fact = lin.factor(jnp.asarray(A))
    packed, _ = fact
    assert packed.dtype == jnp.float32
    b = rng.standard_normal(64)
    x = np.asarray(lin.solve(fact, jnp.asarray(b)))
    np.testing.assert_allclose(A @ x, b, atol=1e-8)
    assert int(lin.num_neg_eigvals(fact)) == 14

    # iters=0 is the raw f32 back-solve: f32-accurate only
    x32 = np.asarray(lin.solve(fact, jnp.asarray(b), iters=0))
    assert _backward_error(A, x32, b) > 1e-12


# sizes across the thresholds the earlier kernel routing used (512, 1280,
# 2048 rows): one code path now serves all of them
@pytest.mark.parametrize("size", [64, 256, 640, 1300])
def test_tier_factor_refine_inertia(size):
    n, m = _split(size)
    A = _saddle(n, m)
    b = rng.standard_normal(size)

    lin = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)
    fact = jax.jit(lin.factor)(jnp.asarray(A))
    x = np.asarray(jax.jit(lin.solve)(fact, jnp.asarray(b)))

    # f32 factor refined three times in f64 on a well-conditioned system:
    # the backward error reaches the f64 floor
    assert _backward_error(A, x, b) <= 1e-12
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-9, atol=1e-12)
    assert int(lin.num_neg_eigvals(fact)) == m


@pytest.mark.parametrize("batching", ["vmap", "leading_dims"])
@pytest.mark.parametrize("size", [200, 520])
def test_tier_batched(batching, size):
    """Below and above one 512-row panel stack; ``jax.vmap`` and explicit
    ``(B, n, n)`` stacks give the same factors as one-by-one calls."""
    n, m = _split(size)
    mats = np.stack([_saddle(n, m) for _ in range(2)])
    rhs = rng.standard_normal((2, size))
    lin = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)

    if batching == "vmap":
        fact = jax.vmap(lin.factor)(jnp.asarray(mats))
        x = np.asarray(jax.vmap(lin.solve)(fact, jnp.asarray(rhs)))
    else:
        fact = lin.factor(jnp.asarray(mats))
        x = np.asarray(lin.solve(fact, jnp.asarray(rhs)))

    packed = np.asarray(fact[0])
    assert packed.shape == (2, size, size)
    for i in range(2):
        single = np.asarray(ldlt_factor_f32(jnp.asarray(mats[i])))
        np.testing.assert_allclose(np.tril(packed[i]), np.tril(single), rtol=1e-6, atol=1e-6)
        assert _backward_error(mats[i], x[i], rhs[i]) <= 1e-12
    np.testing.assert_array_equal(np.asarray(lin.num_neg_eigvals(fact)), [m, m])


def test_tier_host_reconstruction():
    """Independent host-f64 reconstruction of the f32 factor at n+m = 640:
    L D L^T reproduces the input to f32 accuracy."""
    n, m = _split(640)
    A = _saddle(n, m)
    packed = np.asarray(ldlt_factor_f32(jnp.asarray(A)), dtype=np.float64)
    L = np.tril(packed, -1) + np.eye(n + m)
    recon = (L * np.diag(packed)[None, :]) @ L.T
    rel = np.abs(recon - A).max() / np.abs(A).max()
    assert rel < 5e-5, rel


def test_batched_panels_matches_single_and_recon():
    """Batched panel factor: per instance the packed factor must match the
    single-instance reference loop at f32 accuracy, the host-f64
    reconstruction must be f32-clean, inertia exact, and the f64
    refine_solve must still converge."""
    B = 3
    mats = np.stack([_saddle(272, 112) for _ in range(B)])  # n=384: 3 SBs
    packed = ldlt_factor_f32(jnp.asarray(mats), super_block=128)

    for b in range(B):
        f_ref = np.asarray(ldlt_factor(jnp.asarray(mats[b], dtype=jnp.float32)))
        np.testing.assert_allclose(
            np.tril(np.asarray(packed[b])), np.tril(f_ref), rtol=2e-3, atol=2e-3
        )
        # independent host-f64 reconstruction
        pk = np.asarray(packed[b], dtype=np.float64)
        L = np.tril(pk, -1) + np.eye(384)
        recon = (L * np.diag(pk)[None, :]) @ L.T
        rel = np.abs(recon - mats[b]).max() / np.abs(mats[b]).max()
        assert rel < 5e-5, rel

    np.testing.assert_array_equal(
        np.asarray(ldlt_num_neg_eigvals(packed)), [112] * B
    )

    rhs = rng.standard_normal((B, 384))
    x = np.asarray(
        jnp.stack(
            [
                refine_solve(packed[b], jnp.asarray(mats[b]), jnp.asarray(rhs[b]))
                for b in range(B)
            ]
        )
    )
    for b in range(B):
        np.testing.assert_allclose(mats[b] @ x[b], rhs[b], atol=1e-7)
