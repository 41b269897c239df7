"""Multi-start global optimization helper.

Nonconvex NLPs converge to different KKT points from different starts; the
natural tool is the batched solver — solve every start in lockstep
and pick the best optimal one.  (No reference counterpart; the batched
sweep makes it nearly free.)
"""

from typing import Optional

import numpy as np

from ..params import Params
from ..problem import Problem
from ..status import SolverStatus
from .batch import BatchedSolver, BatchResult


class MultistartResult:
    def __init__(self, batch: BatchResult, objs, best: Optional[int]):
        self.batch = batch
        self.objs = objs
        self.best_index = best

    @property
    def success(self):
        return self.best_index is not None

    @property
    def x(self):
        return self.batch.x[self.best_index]

    @property
    def y(self):
        return self.batch.y[self.best_index]

    @property
    def obj(self):
        return self.objs[self.best_index]

    @property
    def num_optimal(self):
        return int(self.batch.success.sum())


def multistart_solve(
    problem: Problem,
    x0s,
    params: Optional[Params] = None,
    y0s=None,
) -> MultistartResult:
    """Solve from every row of ``x0s`` in lockstep; the result exposes the
    lowest-objective optimal point."""
    solver = BatchedSolver(problem, params)
    batch = solver.solve(np.asarray(x0s), y0s)

    import jax
    import jax.numpy as jnp

    objs = np.asarray(
        jax.vmap(lambda x: problem.obj(jnp.asarray(x)))(jnp.asarray(batch.x))
    )

    ok = batch.status == int(SolverStatus.Optimal)
    if not ok.any():
        return MultistartResult(batch, objs, None)

    masked = np.where(ok, objs, np.inf)
    return MultistartResult(batch, objs, int(np.argmin(masked)))
