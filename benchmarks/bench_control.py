"""Large optimal-control NLP benchmark (BASELINE config #4).

Solves the discretized pendulum swing-up (``runners/control.py``) at a
size whose KKT systems exceed 1000 rows, comparing step/linear-solver
tiers on per-iteration KKT time and total solve wall time.

Tiers:
  - ``LU`` / ``LDLT`` / ``PallasLDLT``: dense full-KKT factorizations on
    the flat ``PendulumControl`` formulation.
  - ``Schur``: block-elimination on ``PendulumControlInterleaved`` whose
    per-stage variable ordering makes the Hessian 3x3-block-diagonal
    (SURVEY §7.5c) — batched LDL^T blocks + dense dual Schur complement.
  - ``Schur+BCR``: additionally exploits the stage-local constraint
    ordering (dual Schur complement block-tridiagonal, 2x2 blocks):
    band-only assembly + block cyclic reduction, O(m) per factorization.

Usage: python benchmarks/bench_control.py [N] [--batch B]

With ``--batch B`` the script additionally solves B perturbed instances
of the interleaved problem in lockstep with :class:`BatchedSolver` and
the Schur step solver — a fleet of optimal control problems
(model-predictive control across scenarios).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def bench_batched(inter, N, B):
    import jax
    import numpy as np

    from pygradflow_tpu import LinearSolverType, Params, StepSolverType
    from pygradflow_tpu.parallel.batch import BatchedSolver

    # matrix-free staged tier: O(N) data per lane, so a fleet of long
    # horizons fits easily; the vmapped mixed-precision root factor
    # batches natively
    params = Params(
        step_solver_type=StepSolverType.Schur,
        schur_block_size=3,
        schur_dual_block_size=2,
        matrix_free=True,
        linear_solver_type=LinearSolverType.PallasLDLT,
        iteration_limit=3000,
        validate_input=False,
    )
    bs = BatchedSolver(inter, params)
    rng = np.random.default_rng(0)
    base = inter.x0_trajectory()
    x0 = np.stack(
        [base + 0.02 * rng.standard_normal(base.shape) for _ in range(B)]
    )

    res = bs.solve(x0)  # compile
    t0 = time.perf_counter()
    res = bs.solve(x0)
    wall = time.perf_counter() - t0

    n_opt = int(res.success.sum())
    out = dict(
        batch=B,
        optimal=n_opt,
        wall_s=round(wall, 3),
        solves_per_sec=round(B / wall, 1),
        ms_per_instance=round(wall / B * 1e3, 2),
        max_iters=int(np.max(res.iterations)),
    )
    print(f"  batched Schur+MF: {out}", file=sys.stderr)
    return out


def main():
    import jax

    from pygradflow_tpu import LinearSolverType, Params, Solver, StepSolverType
    from pygradflow_tpu.runners.control import (
        PendulumControl,
        PendulumControlInterleaved,
    )

    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    N = int(argv[0]) if argv else 256
    B = 0
    if "--batch" in sys.argv:
        i = sys.argv.index("--batch")
        if i + 1 >= len(sys.argv):
            sys.exit("error: --batch requires a value (number of instances)")
        B = int(sys.argv[i + 1])
        argv.remove(sys.argv[i + 1]) if sys.argv[i + 1] in argv else None
    only_tiers = None
    if "--tiers" in sys.argv:
        i = sys.argv.index("--tiers")
        only_tiers = sys.argv[i + 1].split(",")
        if sys.argv[i + 1] in argv:
            argv.remove(sys.argv[i + 1])
        N = int(argv[0]) if argv else 256

    flat = PendulumControl(N=N)
    inter = PendulumControlInterleaved(N=N)
    n = flat.num_vars
    m = flat.num_cons
    print(
        f"pendulum N={N}: n={n} vars, m={m} cons, KKT size {n + m} "
        f"on {jax.devices()[0].platform}",
        file=sys.stderr,
    )

    common = dict(iteration_limit=3000, validate_input=False)
    tiers = {
        "LU": (flat, Params(linear_solver_type=LinearSolverType.LU, **common)),
        "LDLT": (flat, Params(linear_solver_type=LinearSolverType.LDLT, **common)),
        "PallasLDLT": (
            flat,
            Params(linear_solver_type=LinearSolverType.PallasLDLT, **common),
        ),
        "Schur": (
            inter,
            Params(
                step_solver_type=StepSolverType.Schur, schur_block_size=3, **common
            ),
        ),
        "Schur+Pallas": (
            inter,
            Params(
                step_solver_type=StepSolverType.Schur,
                schur_block_size=3,
                linear_solver_type=LinearSolverType.PallasLDLT,
                **common,
            ),
        ),
        # block-tridiagonal dual via cyclic reduction: O(m) per factor,
        # the asymptotic winner for long horizons
        "Schur+BCR": (
            inter,
            Params(
                step_solver_type=StepSolverType.Schur,
                schur_block_size=3,
                schur_dual_block_size=2,
                **common,
            ),
        ),
        # matrix-free staged Schur (step/schur_staged.py): probe-extracted
        # stage blocks, banded elimination, hybrid shallow-BCR + mixed
        # dense root — O(N) data per iteration, no dense J/H anywhere
        "Schur+MF": (
            inter,
            Params(
                step_solver_type=StepSolverType.Schur,
                schur_block_size=3,
                schur_dual_block_size=2,
                matrix_free=True,
                linear_solver_type=LinearSolverType.PallasLDLT,
                **common,
            ),
        ),
    }

    if only_tiers is not None:
        tiers = {k: v for k, v in tiers.items() if k in only_tiers}

    results = {}
    for tier, (problem, params) in tiers.items():
        solver = Solver(problem, params)
        x0 = problem.x0_trajectory()

        r = solver.solve(x0)  # includes compile
        # min over repeats: single timed runs right after compile can
        # read slow; the reference baseline is likewise best-of-3
        # (measure_baseline.py)
        wall = np.inf
        for _ in range(5):
            t0 = time.perf_counter()
            r = solver.solve(x0)
            wall = min(wall, time.perf_counter() - t0)

        # marginal ms/iteration: subtract the fixed per-solve dispatch
        # overhead (measured via a 2-iteration solve) so the number
        # reflects the actual per-iteration cost.  BENCH_NO_MARGINAL=1
        # skips it (saves the extra compile at fresh sizes)
        if os.environ.get("BENCH_NO_MARGINAL"):
            results[tier] = dict(
                status=r.status.name,
                iterations=r.iterations,
                wall_s=round(wall, 3),
                ms_per_iter=round(wall / max(r.iterations, 1) * 1e3, 2),
            )
            print(f"  {tier:>10s}: {results[tier]}", file=sys.stderr)
            continue
        p2 = dict(vars(params))
        p2["iteration_limit"] = 2
        short = Solver(problem, Params(**p2))
        short.solve(x0)  # compile
        w2 = np.inf
        for _ in range(5):
            t0 = time.perf_counter()
            short.solve(x0)
            w2 = min(w2, time.perf_counter() - t0)
        marginal = (wall - w2) / max(r.iterations - 2, 1) * 1e3

        per_iter = wall / max(r.iterations, 1) * 1e3
        results[tier] = dict(
            status=r.status.name,
            iterations=r.iterations,
            wall_s=round(wall, 3),
            ms_per_iter=round(per_iter, 2),
            ms_per_iter_marginal=round(marginal, 2),
            fixed_overhead_ms=round(w2 * 1e3, 1),
        )
        print(f"  {tier:>10s}: {results[tier]}", file=sys.stderr)

    if B:
        results["batched"] = bench_batched(inter, N, B)

    from baseline_cache import ART, load_baseline, write_artifact

    artifact = os.environ.get(
        "BENCH_ARTIFACT",
        "control.json" if N == 256 else f"control_{N}.json",
    )

    # merge with a prior partial run (--tiers splits the sweep over
    # several invocations)
    prior = os.path.join(ART, artifact)
    if only_tiers is not None and os.path.exists(prior):
        with open(prior) as f:
            old = json.load(f)
        if old.get("metric", "").startswith(f"pendulum-control N={N}"):
            results = {**old.get("results", {}), **results}

    ref = load_baseline(f"control_pendulum_{N}") or load_baseline("control_pendulum")
    payload = {
        "metric": f"pendulum-control N={N} (KKT {n + m}) ms/outer-iteration",
        "results": results,
        "reference": ref if (ref and ref.get("N") == N) else None,
    }
    write_artifact(artifact, payload)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
