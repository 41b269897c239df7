"""f32 matrix products on the solver's path ask for full f32 precision.

On a GPU an f32 product with DEFAULT precision may run in TF32 (about 10
mantissa bits).  The lowered programs must carry ``HIGHEST`` on every f32
``dot_general``: the mixed-precision tier's factor and solve, and a whole
``Precision.Single`` solver chunk."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pygradflow_tpu import Params, Precision
from pygradflow_tpu.linalg import linear_solver
from pygradflow_tpu.params import LinearSolverType
from pygradflow_tpu.solver import Solver

from tests.problems import hs71_instance


def _dots(hlo, dtype="f32"):
    dots = [ln for ln in hlo.splitlines() if "dot_general" in ln and dtype in ln]
    assert dots, f"no {dtype} dot_general in the lowered program"
    return dots


def _assert_highest(hlo, dtype="f32"):
    for ln in _dots(hlo, dtype):
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln


def test_default_precision_is_not_highest():
    """The check below is not vacuous: a bare jit of an f32 product lowers
    with DEFAULT precision."""
    a = jnp.ones((4, 4), jnp.float32)
    hlo = jax.jit(lambda a: a @ a).lower(a).as_text()
    assert "HIGHEST" not in "".join(_dots(hlo))


@pytest.mark.parametrize("op", ["factor", "solve"])
def test_mixed_tier_lowers_highest(op):
    lin = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)
    A = jnp.asarray(np.eye(300) * 2.0 + 0.01)
    b = jnp.ones(300)
    if op == "factor":
        _assert_highest(jax.jit(lin.factor).lower(A).as_text())
    else:
        # the f32 back-solves are triangular solves; the refinement's
        # residual product is f64 and traced under the same setting
        fact = lin.factor(A)
        _assert_highest(jax.jit(lin.solve).lower(fact, b).as_text(), "f64")


def test_single_precision_chunk_lowers_highest():
    inst = hs71_instance()
    solver = Solver(inst.problem, Params(precision=Precision.Single))
    loop = solver._loop
    x, y = solver.transform.create_transformed_initial(inst.x_0, inst.y_0)
    state = loop._init_state(x, y)
    hlo = loop._run_chunk.lower(state, jnp.asarray(8, jnp.int32)).as_text()
    _assert_highest(hlo)
