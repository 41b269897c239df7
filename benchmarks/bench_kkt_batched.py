"""Batched KKT factor+solve throughput of the mixed-precision tier.

``jax.vmap`` of the tier (``LinearSolverType.PallasLDLT``: plain-XLA f32
LDL^T + f64 refinement) batches every step natively: the rank-1 sweeps
are elementwise over the batch, the panel solves and trailing updates are
batched triangular solves and GEMMs.

Sweeps batch x size, times ``vmap(factor)+vmap(solve)`` as ONE jitted
dispatch (min over repeats), and reports effective f32 TFLOP/s for the
factorization (n^3/3 FLOPs per instance).  Per-instance correctness is
asserted against the f64 direct solve at every cell.  Runs on whatever
device JAX selects and records it; a GPU measurement needs a GPU.

Usage: python benchmarks/bench_kkt_batched.py [--batches 8 32 128]
       [--sizes 512 1024 2048] [--out artifacts/kkt_batched.json]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def make_kkt(n, m, rng):
    H = rng.standard_normal((n, n))
    K = H @ H.T + n * np.eye(n)
    J = rng.standard_normal((m, n))
    return np.block([[K, J.T], [J, -0.1 * np.eye(m)]])


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batches", type=int, nargs="+", default=[8, 32, 128])
    parser.add_argument("--sizes", type=int, nargs="+", default=[512, 1024, 2048])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--max-cell-gb", type=float, default=14.0)
    parser.add_argument(
        "--out",
        type=str,
        default=os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "artifacts",
            "kkt_batched.json",
        ),
    )
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    import pygradflow_tpu  # noqa: F401  (x64 + compile cache)
    from pygradflow_tpu.linalg import linear_solver
    from pygradflow_tpu.params import LinearSolverType

    lin = linear_solver(LinearSolverType.PallasLDLT, symmetric=True)
    platform = jax.devices()[0].platform

    rng = np.random.default_rng(7)

    # device-memory guard: f64 input + f32 working copy + packed f32
    # factor + refine-loop temps, estimated at ~8x the f64 input (XLA
    # double-buffers the while-loop carries)
    def guard_skips(size, batch):
        return batch * size * size * 8 * 8 / 1e9 > args.max_cell_gb

    # merge with a prior partial run (cells are independent, so a sweep
    # can be split over several invocations).  Guard-skipped cells
    # will NOT be re-measured below, so they must not count as
    # "requested" — otherwise a re-run that includes a too-large cell
    # silently deletes its prior measurement from the artifact
    records = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            prior = json.load(f)
        requested = {
            (s, b)
            for s in args.sizes
            for b in args.batches
            if not guard_skips(s, b)
        }
        records = [
            r
            for r in prior
            if "skipped" not in r and (r["size"], r["batch"]) not in requested
        ]

    for size in args.sizes:
        n, m = 3 * size // 4, size // 4
        # one well-conditioned saddle base + per-instance perturbations:
        # every instance is a distinct matrix, same sparsity of work
        base = make_kkt(n, m, rng)

        for batch in args.batches:
            if guard_skips(size, batch):
                est_gb = batch * size * size * 8 * 8 / 1e9
                print(
                    json.dumps(
                        {"size": size, "batch": batch, "skipped": f"~{est_gb:.0f} GB"}
                    ),
                    flush=True,
                )
                continue
            pert = 0.01 * rng.standard_normal((batch, size, size))
            pert = (pert + np.swapaxes(pert, -1, -2)) / 2.0
            A = jnp.asarray(base[None] + pert)  # f64 (B, size, size)
            b = jnp.asarray(rng.standard_normal((batch, size)))

            @jax.jit
            def fact_solve(A, b):
                fact = jax.vmap(lin.factor)(A)
                return jax.vmap(lin.solve)(fact, b)

            x = jax.block_until_ready(fact_solve(A, b))
            relres = jnp.linalg.norm(
                jnp.einsum("bij,bj->bi", A, x) - b, axis=-1
            ) / jnp.linalg.norm(b, axis=-1)
            max_relres = float(relres.max())
            # the f32 factor bounds refinement at large n; within the
            # solver that level is re-refined by the outer Newton anyway,
            # so gate on a size-aware envelope and report the measured
            # residual in the artifact
            tol = 1e-8 if size <= 1024 else 1e-6
            assert max_relres < tol, (size, batch, max_relres)

            best = np.inf
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fact_solve(A, b))
                best = min(best, time.perf_counter() - t0)

            factor_flops = batch * size**3 / 3.0
            rec = {
                "platform": platform,
                "size": size,
                "batch": batch,
                "total_ms": best * 1e3,
                "ms_per_instance": best * 1e3 / batch,
                "instances_per_sec": batch / best,
                "factor_tflops": factor_flops / best / 1e12,
                "max_relres": max_relres,
            }
            records.append(rec)
            print(json.dumps(rec), flush=True)
            # write incrementally: a late-cell failure or watchdog kill
            # must not lose the completed cells
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
