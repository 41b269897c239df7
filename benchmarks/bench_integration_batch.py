"""Batched continuous-flow throughput: HS71 instances solved in lockstep
by the device-resident integration loop (``BatchedIntegrationSolver``).

The reference's scipy-BDF IntegrationSolver is sequential per instance;
its measured single-instance rate is the baseline
(``benchmarks/artifacts/baseline_reference.json`` has the discrete-engine
rate; the continuous engine is slower still, so this comparison is
conservative when it reuses the reference wall-clock that
``bench_integration.py`` wrote to ``artifacts/integration.json``).

Usage: python benchmarks/bench_integration_batch.py [batch]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

BATCH = int(sys.argv[1]) if len(sys.argv) > 1 else 256


def _reference_same_instances(x0s, y0s):
    """Sequential reference IntegrationSolver over the given starts
    (CPU); returns wall/status accounting.  Mirrors
    bench_integration.run_reference but without step counting."""
    import logging
    import time

    logging.getLogger("gradflow").setLevel(logging.ERROR)
    sys.path.insert(0, "/root/reference")
    sys.path.insert(0, "/root/reference/tests/pygradflow")

    from hs71 import HS71 as RefHS71

    from pygradflow.integration.integration_solver import (
        IntegrationSolver as RefIntegrationSolver,
    )
    from pygradflow.params import Params as RefParams

    statuses = []
    t0 = time.perf_counter()
    for x0, y0 in zip(x0s, y0s):
        solver = RefIntegrationSolver(
            RefHS71(), RefParams(iteration_limit=1000, rho=1e-2)
        )
        try:
            result = solver.solve(np.asarray(x0), np.asarray(y0))
            statuses.append(result.status.name)
        except Exception:
            # the reference's own event handler asserts the located event
            # point is at the bound (integration_solver.py:171) and
            # crashes on some perturbed starts; count it as an error
            # instance (our lockstep engine solves the same start)
            statuses.append("error")
    wall = time.perf_counter() - t0
    n = len(statuses)
    return {
        "sample": n,
        "wall_s": round(wall, 3),
        "solves_per_sec": round(n / wall, 4),
        "optimal": statuses.count("Optimal"),
        "errors": statuses.count("error"),
        "statuses": sorted(set(statuses)),
    }


def _sequential_device_loop(problem, params, x0s, y0s):
    """Internal baseline: the single-instance device-resident loop
    (`integration/device_loop.py`, the 20x-vs-reference engine) replayed
    sequentially over the SAME instances.  This is the number the batched
    engine must beat for lockstep batching to be worth anything (round-4
    verdict, weak item #2)."""
    import time

    from pygradflow_tpu.integration import IntegrationSolver

    solver = IntegrationSolver(problem, params)
    # warm-up/compile on the first instance
    solver.solve(x0s[0], y0s[0])
    statuses = []
    t0 = time.perf_counter()
    for x0, y0 in zip(x0s, y0s):
        r = solver.solve(x0, y0)
        statuses.append(r.status.name)
    wall = time.perf_counter() - t0
    n = len(statuses)
    return {
        "sample": n,
        "wall_s": round(wall, 3),
        "solves_per_sec": round(n / wall, 4),
        "optimal": statuses.count("Optimal"),
    }


def main():
    from baseline_cache import ART, write_artifact

    from pygradflow_tpu import Params
    from pygradflow_tpu.integration import BatchedIntegrationSolver

    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests")
    )
    from problems import hs71_instance

    inst = hs71_instance()
    rng = np.random.default_rng(7)
    lo = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
    hi = np.array([5.0, 5.0, 5.0, 5.0, 2.0])
    # lockstep batching runs until the SLOWEST lane terminates, and a
    # few % of perturbed starts grind ~70x the typical step count before
    # converging (slow dual creep near the optimum, see PARITY.md).  The
    # step cap bounds any truly runaway lane: it finishes as
    # IterationLimit and is counted against success_fraction.
    x0s = np.clip(
        inst.x_0[None, :] + rng.uniform(-0.1, 0.1, size=(BATCH, 5)), lo, hi
    )
    y0s = np.tile(inst.y_0, (BATCH, 1))

    from pygradflow_tpu.params import IntegrationMethod

    params = Params(
        iteration_limit=1000,
        rho=1e-2,
        integration_max_steps=50_000,
        # SDIRK4 (order 4): ~2.2x fewer steps than TR-BDF2 at these
        # tolerances, and the slowest lane sets the lockstep wall
        integration_method=IntegrationMethod.SDIRK4,
    )
    solver = BatchedIntegrationSolver(inst.problem, params)
    res = solver.solve(x0s, y0s)  # warm-up/compile
    t0 = time.perf_counter()
    res = solver.solve(x0s, y0s)
    wall = time.perf_counter() - t0

    frac = float(res.success.mean())
    rate = BATCH / wall

    # internal baseline: sequential single-instance device loop over the
    # SAME instances (skip with BENCH_SEQ_SAMPLE=0)
    seq = None
    seq_sample = int(os.environ.get("BENCH_SEQ_SAMPLE", min(BATCH, 64)))
    if seq_sample > 0:
        from dataclasses import replace

        seq = _sequential_device_loop(
            inst.problem,
            replace(params, integration_device_loop=True),
            x0s[:seq_sample],
            y0s[:seq_sample],
        )

    # reference continuous-engine wall-clock for the SAME problem
    ref_wall = None
    try:
        with open(os.path.join(ART, "integration.json")) as f:
            for row in json.load(f):
                if row["problem"] == "hs71" and row["engine"] == "reference/BDF":
                    ref_wall = row["wall_s"]
    except Exception:
        pass

    # the honest baseline: the reference solving the SAME perturbed
    # instances sequentially (the nominal-start wall above is its best
    # case; perturbed starts include the grinding lanes that bound OUR
    # lockstep wall too).  Subsample via BENCH_REF_SAMPLE to stay inside
    # a watchdog budget; rate extrapolates from the subsample mean.
    ref_same = None
    sample = int(os.environ.get("BENCH_REF_SAMPLE", min(BATCH, 64)))
    if sample > 0 and os.path.isdir("/root/reference"):
        try:
            ref_same = _reference_same_instances(x0s[:sample], y0s[:sample])
        except Exception:  # pragma: no cover - env-dependent
            import traceback

            traceback.print_exc()

    import jax

    payload = {
        "metric": f"batched continuous-flow HS71 solves/sec (B={BATCH})",
        "platform": jax.devices()[0].platform,
        "value": round(rate, 3),
        "unit": "solves/sec",
        "success_fraction": round(frac, 4),
        "wall_s": round(wall, 3),
        "max_segments": int(np.max(res.iterations)),
        "vs_baseline": round(rate * ref_wall, 3) if ref_wall else None,
        "baseline_note": "reference scipy-BDF IntegrationSolver, sequential CPU "
        f"({ref_wall}s/instance measured, nominal start)" if ref_wall else None,
        "reference_same_instances": ref_same,
        "vs_reference_same_instances": (
            round(rate / ref_same["solves_per_sec"], 3) if ref_same else None
        ),
        "sequential_device_loop_same_instances": seq,
        "vs_sequential_device_loop": (
            round(rate / seq["solves_per_sec"], 3) if seq else None
        ),
    }
    write_artifact(
        os.environ.get("BENCH_ARTIFACT", "integration_batch.json"), payload
    )
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
