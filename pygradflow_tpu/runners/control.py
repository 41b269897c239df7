"""Discretized optimal-control NLP family (BASELINE config #4,
Pearson-Potschka style).

A pendulum swing-up style problem: minimize quadratic tracking + control
cost subject to explicit-Euler discretized nonlinear dynamics (equality
constraints) and control bounds.  Variables are the stacked state
trajectory and controls; the KKT systems are large and block-banded — the
workload for the blocked and mixed-precision LDL^T paths.
"""

import jax.numpy as jnp
import numpy as np

from ..problem import Problem


class PendulumControl(Problem):
    """Swing-up of a damped pendulum.

    States (theta, omega), control torque u with |u| <= u_max.
    Dynamics: theta' = omega; omega' = -sin(theta) - c*omega + u.
    Objective: sum_k h * (w1*(theta_k - pi)^2 + w2*omega_k^2 + alpha*u_k^2).
    Variables: [theta_0..theta_N, omega_0..omega_N, u_0..u_{N-1}],
    n = 2(N+1) + N; equality constraints: initial conditions + N Euler
    steps for each state, m = 2(N+1).
    """

    def __init__(self, N: int = 32, h: float = 0.1, u_max: float = 2.5, alpha=1e-2):
        self.N = N
        self.h = h
        self.alpha = alpha

        n_states = 2 * (N + 1)
        n = n_states + N

        lb = np.full(n, -np.inf)
        ub = np.full(n, np.inf)
        lb[n_states:] = -u_max
        ub[n_states:] = u_max

        m = 2 * (N + 1)
        super().__init__(lb, ub, num_cons=m)

    def _split(self, z):
        N = self.N
        theta = z[: N + 1]
        omega = z[N + 1 : 2 * (N + 1)]
        u = z[2 * (N + 1) :]
        return theta, omega, u

    def obj(self, z):
        theta, omega, u = self._split(z)
        h = self.h
        track = jnp.sum((theta - jnp.pi) ** 2) + 0.1 * jnp.sum(omega**2)
        effort = self.alpha * jnp.sum(u**2)
        return h * (track + effort)

    def cons(self, z):
        theta, omega, u = self._split(z)
        h = self.h
        c = 0.2  # damping

        # explicit Euler dynamics residuals
        dtheta = theta[1:] - theta[:-1] - h * omega[:-1]
        domega = (
            omega[1:]
            - omega[:-1]
            - h * (-jnp.sin(theta[:-1]) - c * omega[:-1] + u)
        )

        # initial conditions theta_0 = 0, omega_0 = 0
        init = jnp.stack([theta[0], omega[0]])
        return jnp.concatenate([init, dtheta, domega])

    def x0_trajectory(self):
        """A feasible-ish warm start: linear sweep to the target."""
        N = self.N
        theta = np.linspace(0.0, np.pi, N + 1)
        omega = np.zeros(N + 1)
        u = np.zeros(N)
        return np.concatenate([theta, omega, u])


class PendulumControlInterleaved(Problem):
    """Same swing-up problem with per-timestep variable interleaving
    ``[(theta_k, omega_k, u_k)]_k``: the Lagrangian Hessian becomes block
    diagonal with 3x3 blocks (the objective is stage-separable and the only
    constraint curvature, sin(theta_k), is diagonal), enabling the
    Schur-complement step solver (``StepSolverType.Schur``,
    ``schur_block_size=3``).  A bounds-fixed dummy variable pads the final
    stage (theta_N, omega_N have no control)."""

    def __init__(self, N: int = 32, h: float = 0.1, u_max: float = 2.5, alpha=1e-2):
        self.N = N
        self.h = h
        self.alpha = alpha

        n = 3 * (N + 1)
        lb = np.full(n, -np.inf)
        ub = np.full(n, np.inf)
        # controls at positions 3k+2 for k < N; dummy at 3N+2 fixed to 0
        for k in range(N):
            lb[3 * k + 2] = -u_max
            ub[3 * k + 2] = u_max
        lb[3 * N + 2] = 0.0
        ub[3 * N + 2] = 0.0

        super().__init__(lb, ub, num_cons=2 * (N + 1))

    def _split(self, z):
        N = self.N
        stages = z.reshape(N + 1, 3)
        return stages[:, 0], stages[:, 1], stages[:N, 2]

    def obj(self, z):
        theta, omega, u = self._split(z)
        h = self.h
        track = jnp.sum((theta - jnp.pi) ** 2) + 0.1 * jnp.sum(omega**2)
        return h * (track + self.alpha * jnp.sum(u**2))

    def cons(self, z):
        """Constraints interleaved per stage: block 0 is the initial
        condition (theta_0, omega_0), block k >= 1 is the dynamics pair
        (dtheta_{k-1}, domega_{k-1}) coupling stages k-1 and k.  With
        this ordering adjacent constraint blocks share at most one stage,
        so the dual Schur complement is block *tridiagonal* with 2x2
        blocks — enabling ``schur_dual_block_size=2``."""
        theta, omega, u = self._split(z)
        h = self.h
        c = 0.2
        dtheta = theta[1:] - theta[:-1] - h * omega[:-1]
        domega = (
            omega[1:]
            - omega[:-1]
            - h * (-jnp.sin(theta[:-1]) - c * omega[:-1] + u)
        )
        init = jnp.stack([theta[0], omega[0]])
        pairs = jnp.stack([dtheta, domega], axis=1).reshape(-1)
        return jnp.concatenate([init, pairs])

    def x0_trajectory(self):
        N = self.N
        stages = np.zeros((N + 1, 3))
        stages[:, 0] = np.linspace(0.0, np.pi, N + 1)
        return stages.reshape(-1)
