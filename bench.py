"""Benchmark: batched NLP solves/sec vs the reference PyGradFlow on CPU.

Headline configuration (BASELINE.md #1/#3): a batch of perturbed-start 2D
Rosenbrock instances solved to the default opt_tol=1e-6 KKT residual.
Ours runs the vmapped homotopy loop on the GPU, in this one process; the
baseline is the reference chrhansk/pygradflow solver's sequential CPU rate,
cached in ``benchmarks/artifacts/baseline_reference.json`` (measured once
by ``benchmarks/measure_baseline.py`` on a 4-core host).

Prints one JSON line: {"metric", "value", "unit", "vs_baseline",
"platform", "device_kind", "device_count"}.  Exits non-zero when JAX finds
no GPU or when any solve fails.
"""

import json
import os
import sys
import time

import numpy as np

BATCH = int(os.environ.get("BENCH_BATCH", 16384))
SEED = 0


def _metric_name():
    kind = os.environ.get("BENCH_PRECISION", "Double")
    desc = {
        "Single": "f32, opt_tol=1e-4",
        "Mixed": "mixed f32+f64-polish, opt_tol=1e-6",
    }.get(kind, "opt_tol=1e-6")
    return f"batched Rosenbrock solves/sec (B={BATCH}, {desc})"


def make_starts(batch):
    rng = np.random.default_rng(SEED)
    return rng.uniform(-1.5, 1.5, size=(batch, 2))


def run_ours(x0s):
    from pygradflow_tpu import LinearSolverType, Params, Precision
    from pygradflow_tpu.parallel import BatchedSolver

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    from problems import Rosenbrock

    kind = os.environ.get("BENCH_PRECISION", "Double")
    # BENCH_COMPACT=0/1 overrides the auto harvest+compaction decision
    compact_env = os.environ.get("BENCH_COMPACT")
    compact = None if compact_env is None else bool(int(compact_env))

    if kind == "Mixed":
        # mixed-precision homotopy: f32 bulk loop to 1e-4 + f64 polish to
        # the real 1e-6 tolerance
        from pygradflow_tpu.parallel import MixedPrecisionSolver

        params = Params(
            validate_input=False,
            linear_solver_type=LinearSolverType[
                os.environ.get("BENCH_LINSOLVER", "LU")
            ],
            jit_chunk=int(os.environ.get("BENCH_CHUNK", 128)),
        )
        solver = MixedPrecisionSolver(Rosenbrock(), params, compact=compact)
    else:
        precision = Precision[kind]
        params = Params(
            validate_input=False,
            linear_solver_type=LinearSolverType[
                os.environ.get("BENCH_LINSOLVER", "LU")
            ],
            jit_chunk=int(os.environ.get("BENCH_CHUNK", 128)),
            precision=precision,
        )
        if precision == Precision.Single:
            # f32 mode: loosened tolerances (reference params.py:210-211
            # notes lamb_min ~1e-6 for single precision)
            params.opt_tol = 1e-4
            params.lamb_min = 1e-6
        solver = BatchedSolver(Rosenbrock(), params, compact=compact)

    # warmup: populate compile caches with the same shapes
    warm = solver.solve(x0s)
    if not warm.success.all():
        raise RuntimeError("warmup solve failed")

    # min over repeats: single timed runs right after compile can read slow
    elapsed = np.inf
    for _ in range(5):
        t0 = time.perf_counter()
        res = solver.solve(x0s)
        elapsed = min(elapsed, time.perf_counter() - t0)

    if not res.success.all():
        raise RuntimeError("bench solve failed")
    tol = 1e-2 if kind == "Single" else 1e-4
    if np.abs(res.x - 1.0).max() >= tol:
        raise RuntimeError("bench solve off the optimum")

    return x0s.shape[0] / elapsed, res


def run_baseline():
    """Reference pygradflow sequential-CPU solves/sec: the cached measured
    number (128 instances, benchmarks/measure_baseline.py), or None."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "benchmarks"))
    from baseline_cache import load_baseline

    cached = load_baseline("rosenbrock")
    return cached.get("solves_per_sec") if cached else None


def main():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {devices[0].platform!r}")

    x0s = make_starts(BATCH)
    solves_per_sec, _ = run_ours(x0s)
    baseline = run_baseline()
    vs = (solves_per_sec / baseline) if baseline else None

    print(
        json.dumps(
            {
                "metric": _metric_name(),
                "value": round(solves_per_sec, 3),
                "unit": "solves/sec",
                "vs_baseline": round(vs, 3) if vs is not None else None,
                "platform": devices[0].platform,
                "device_kind": devices[0].device_kind,
                "device_count": len(devices),
            }
        )
    )


if __name__ == "__main__":
    main()
