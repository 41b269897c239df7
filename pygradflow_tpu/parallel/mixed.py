"""Mixed-precision batched sweeps: f32 bulk loop + f64 polish.

f32 alone only reaches ~1e-4 KKT residuals.  The KKT linear-algebra tier
uses the classic escape (f32 factor + f64 refinement reaches 1e-10); this
module applies the same pattern at the HOMOTOPY-LOOP level:

1. run the whole batched homotopy loop in f32 to ``f32_tol`` (default
   1e-4), which covers the bulk of the distance;
2. promote every lane's (x, y) to f64 and warm-start the f64 batched
   loop from there to the real ``params.opt_tol`` (1e-6/1e-8) — a few
   polish iterations instead of the full trajectory.  Lanes whose f32
   stage produced non-finite values restart from their original x0.

The reference has no counterpart (it solves everything in numpy f64;
``params.py`` notes lamb_min should be ~1e-6 in single precision but
ships no mixed pipeline).  Equivalence: the polish stage converges to
the same optima as a pure-f64 solve (tested in ``tests/test_mixed.py``)
— trajectories differ (they may take different homotopy paths), optima
and statuses agree.
"""

from dataclasses import replace
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..params import Params, Precision
from ..problem import Problem
from .batch import BatchedSolver, BatchResult


class MixedPrecisionSolver:
    """Batched solver running an f32 bulk stage then an f64 polish stage.

    ``params`` is the TARGET configuration (f64 precision, final
    ``opt_tol``); the f32 stage derives from it with
    ``precision=Single``, ``opt_tol=f32_tol`` and the single-precision
    ``lamb_min`` floor (reference ``params.py:210-211`` notes ~1e-6 for
    single precision).
    """

    def __init__(
        self,
        problem: Problem,
        params: Optional[Params] = None,
        f32_tol: float = 1e-4,
        compact: Optional[bool] = None,
    ):
        if params is None:
            params = Params()
        assert params.precision == Precision.Double, (
            "MixedPrecisionSolver polishes in f64; pass f64 target params"
        )
        self.params = params
        p32 = replace(
            params,
            precision=Precision.Single,
            opt_tol=float(f32_tol),
            lamb_min=max(params.lamb_min, 1e-6),
        )
        self.bulk = BatchedSolver(problem, p32, compact=compact)
        self.polish = BatchedSolver(problem, params, compact=compact)

    def solve(self, x0, y0=None, data=None) -> BatchResult:
        x0 = np.asarray(x0, dtype=np.float64)
        B = x0.shape[0]
        if y0 is None:
            y0 = np.zeros(
                (B, self.bulk.orig_problem.num_cons), dtype=np.float64
            )
        else:
            y0 = np.asarray(y0, dtype=np.float64)

        r32 = self.bulk.solve(x0, y0, data=data)
        self.bulk_result = r32  # stage stats for benchmarks/diagnosis

        # promote: f32 solutions as f64 warm starts; non-finite lanes
        # (f32 overflow/divergence) restart from the original point
        x_warm = np.asarray(r32.x, dtype=np.float64)
        y_warm = np.asarray(r32.y, dtype=np.float64)
        bad = ~(
            np.isfinite(x_warm).all(axis=1) & np.isfinite(y_warm).all(axis=1)
        )
        if bad.any():
            x_warm[bad] = x0[bad]
            y_warm[bad] = y0[bad]

        r64 = self.polish.solve(x_warm, y_warm, data=data)
        # combined per-lane iteration accounting (bulk + polish)
        return r64._replace(
            iterations=r64.iterations + np.asarray(r32.iterations),
            accepted_steps=r64.accepted_steps + np.asarray(r32.accepted_steps),
        )
