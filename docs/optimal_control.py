"""Example: block-structured optimal control with the Schur step solver.

Solves the discretized pendulum swing-up NLP.  The interleaved
formulation orders variables per stage ``(theta_k, omega_k, u_k)`` so the
Lagrangian Hessian is 3x3-block-diagonal, which the Schur step solver
exploits: the primal block is factored as a batch of tiny LDL^T
factorizations and only the dual Schur complement needs a real
factorization — here block-cyclic reduction with a dense root on the
mixed-precision tier (``LinearSolverType.PallasLDLT``: plain-XLA f32
factor + f64 iterative refinement).

Solve times on the GPU: not measured yet.
"""

import numpy as np

from pygradflow_tpu import LinearSolverType, Params, Solver, StepSolverType
from pygradflow_tpu.runners.control import PendulumControlInterleaved


def main():
    problem = PendulumControlInterleaved(N=64)

    params = Params(
        step_solver_type=StepSolverType.Schur,
        schur_block_size=3,  # (theta, omega, u) per stage
        # stage-local constraints (dual block r touches stages r-1, r):
        # with matrix_free=True the dense Jacobian/Hessian are never
        # materialized — stage blocks are probed out by batched jvp/hvp
        # and the per-iteration cost is O(N), the long-horizon regime's
        # winning tier (step/schur_staged.py)
        schur_dual_block_size=2,
        matrix_free=True,
        linear_solver_type=LinearSolverType.PallasLDLT,
        validate_input=False,
    )

    solver = Solver(problem, params)
    result = solver.solve(problem.x0_trajectory())

    print("status:", result.status.name)
    print("iterations:", result.iterations)
    print("objective:", result.final_scaled_obj)

    # final state of the swing-up: theta should be near pi (upright)
    x = np.asarray(result.x)
    theta_final = x[3 * (problem.N - 1)]
    print("final angle:", theta_final, "(target pi = %.6f)" % np.pi)


if __name__ == "__main__":
    main()
