"""Integration-engine benchmark: this framework's jitted TR-BDF2 /
implicit-Euler segment integrators vs the reference's scipy-BDF engine
(``/root/reference/pygradflow/integration/integration_solver.py:264-356``)
on the reference's own integration test problems (HS71, Tame).

Both sides run on CPU (the reference is CPU-only) with the same
tolerances (rtol=1e-6/atol=1e-9 — the scipy defaults the reference
inherits are coarser, so this is conservative for us).  Reports
segments, steps, Newton/function-eval work and wall-clock, and writes
``benchmarks/artifacts/integration.json``.

Usage: env PYTHONPATH= python benchmarks/bench_integration.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

REF = "/root/reference"
ART = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")

_STARTS = {
    "hs71": (np.array([1.0, 5.0, 5.0, 1.0, 0.0]), np.array([0.0, 0.0])),
    "tame": (np.array([0.0, 0.0]), np.array([0.0])),
}


def run_reference(problem_name, repeats=3):
    """Reference IntegrationSolver; total BDF steps / evals accumulated by
    wrapping perform_integration (they are otherwise display-only)."""
    import logging

    logging.getLogger("gradflow").setLevel(logging.ERROR)
    sys.path.insert(0, REF)
    sys.path.insert(0, os.path.join(REF, "tests/pygradflow"))

    from hs71 import HS71 as RefHS71
    from tame import Tame as RefTame

    from pygradflow.integration.integration_solver import (
        IntegrationSolver as RefIntegrationSolver,
    )
    from pygradflow.params import Params as RefParams

    problems = {"hs71": RefHS71, "tame": RefTame}
    x0, y0 = _STARTS[problem_name]

    totals = {"steps": 0, "fev": 0, "jev": 0}
    orig = RefIntegrationSolver.perform_integration

    def counting(self, *a, **k):
        r = orig(self, *a, **k)
        totals["steps"] += r.num_steps
        totals["fev"] += r.num_func_evals
        totals["jev"] += r.num_jac_evals
        return r

    RefIntegrationSolver.perform_integration = counting
    try:
        best = np.inf
        for _ in range(repeats):
            for k in totals:
                totals[k] = 0
            solver = RefIntegrationSolver(
                problems[problem_name](), RefParams(iteration_limit=1000, rho=1e-2)
            )
            t0 = time.perf_counter()
            result = solver.solve(np.asarray(x0), np.asarray(y0))
            best = min(best, time.perf_counter() - t0)
    finally:
        RefIntegrationSolver.perform_integration = orig

    return {
        "status": result.status.name,
        "segments": result.iterations,
        "steps": totals["steps"],
        "func_evals": totals["fev"],
        "jac_evals": totals["jev"],
        "wall_s": best,
    }


def run_ours(problem_name, method_name, repeats=3):
    from pygradflow_tpu import IntegrationMethod, Params
    from pygradflow_tpu.integration import IntegrationSolver

    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests")
    )
    from problems import HS71, Tame

    problems = {"hs71": HS71, "tame": Tame}
    x0, y0 = _STARTS[problem_name]
    device_loop = method_name.endswith("+device")
    params = Params(
        iteration_limit=1000,
        rho=1e-2,
        integration_method=IntegrationMethod[method_name.split("+")[0]],
        integration_device_loop=device_loop,
    )

    solver = IntegrationSolver(problems[problem_name](), params)
    result = solver.solve(x0, y0)  # warm-up: compile
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = solver.solve(x0, y0)
        best = min(best, time.perf_counter() - t0)

    return {
        "status": result.status.name,
        "segments": result.iterations,
        "steps": result.num_integration_steps,
        "newton_its": result.num_newton_steps,
        "wall_s": best,
    }


def main():
    rows = []
    for prob in ["hs71", "tame"]:
        ref = run_reference(prob)
        print(
            f"{prob:<6s} reference/BDF   {ref['status']:<8s} "
            f"segments={ref['segments']:<3d} steps={ref['steps']:<6d} "
            f"fev={ref['func_evals']:<6d} jev={ref['jac_evals']:<4d} "
            f"wall={ref['wall_s']*1e3:8.1f} ms"
        )
        for method in [
            "SDIRK4",
            "SDIRK4+device",
            "TRBDF2",
            "TRBDF2+device",
            "ImplicitEuler",
        ]:
            ours = run_ours(prob, method)
            print(
                f"{prob:<6s} ours/{method:<11s}{ours['status']:<8s} "
                f"segments={ours['segments']:<3d} steps={ours['steps']:<6d} "
                f"newton={ours['newton_its']:<6d} "
                f"wall={ours['wall_s']*1e3:8.1f} ms "
                f"({ref['wall_s']/ours['wall_s']:.2f}x ref, "
                f"{ours['steps']/max(ref['steps'],1):.1f}x ref steps)"
            )
            rows.append(
                {
                    "problem": prob,
                    "engine": f"ours/{method}",
                    **ours,
                    "ref_wall_s": ref["wall_s"],
                    "ref_steps": ref["steps"],
                    "ref_segments": ref["segments"],
                    "speedup_vs_ref": ref["wall_s"] / ours["wall_s"],
                }
            )
        rows.append({"problem": prob, "engine": "reference/BDF", **ref})

    os.makedirs(ART, exist_ok=True)
    out = os.path.join(ART, os.environ.get("BENCH_ARTIFACT", "integration.json"))
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
