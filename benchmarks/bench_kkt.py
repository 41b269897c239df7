"""KKT factorize+solve microbenchmark on the GPU.

Times one factor + solve of a saddle-point KKT system for each dense
linear-solver tier (``LU``, ``LDLT``, and the mixed-precision
``PallasLDLT`` tier), and the two plain f32 LDL^T factorizations the
mixed tier could use (``blocked_ldlt.ldlt_factor_blocked`` on full-height
masked panels, ``mixed_ldlt.ldlt_factor_f32`` on statically unrolled
super-blocks).  Median of repeated warm calls, each ending in
``block_until_ready``.  Exits non-zero when JAX finds no GPU.

Usage: python benchmarks/bench_kkt.py [sizes...]    (default 1024 4096)

Prints one JSON line per size, tagged with the device.
"""

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


def median_ms(fn, args, reps=7):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def main():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench_kkt: needs a GPU, JAX found {devices[0].platform!r}")

    import jax.numpy as jnp

    import pygradflow_tpu  # noqa: F401  (x64 + compile cache)
    from pygradflow_tpu.jit import full_f32
    from pygradflow_tpu.linalg import linear_solver
    from pygradflow_tpu.linalg.blocked_ldlt import ldlt_factor_blocked
    from pygradflow_tpu.linalg.ldlt import ldlt_factor
    from pygradflow_tpu.linalg.mixed_ldlt import ldlt_factor_f32
    from pygradflow_tpu.params import LinearSolverType

    sizes = [int(s) for s in sys.argv[1:]] or [1024, 4096]
    rng = np.random.default_rng(0)
    tiers = {
        "lu": LinearSolverType.LU,
        "ldlt": LinearSolverType.LDLT,
        "pallas_ldlt": LinearSolverType.PallasLDLT,
    }
    candidates = {
        "ldlt_factor_blocked_f32": jax.jit(
            full_f32(lambda a: ldlt_factor_blocked(a.astype(jnp.float32)))
        ),
        "ldlt_factor_f32_sb128": jax.jit(full_f32(ldlt_factor_f32)),
        "ldlt_factor_f32_sb256": jax.jit(
            full_f32(lambda a: ldlt_factor_f32(a, super_block=256))
        ),
    }
    rank1_sweep = jax.jit(ldlt_factor)

    for size in sizes:
        n = (3 * size) // 4
        m = size - n
        A = jnp.asarray(make_kkt(n, m, rng))
        b = jnp.asarray(rng.standard_normal(size))
        row = {
            "size": size,
            "n": n,
            "m": m,
            "platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
        }
        for name, kind in tiers.items():
            lin = linear_solver(kind, symmetric=True)
            fn = jax.jit(lambda A, b, lin=lin: lin.solve(lin.factor(A), b))
            x = fn(A, b)
            row[f"{name}_resid"] = float(
                jnp.linalg.norm(A @ x - b) / jnp.linalg.norm(b)
            )
            row[f"{name}_ms"] = median_ms(fn, (A, b))
        for name, fn in candidates.items():
            row[f"{name}_ms"] = median_ms(fn, (A,))
        # the serial part of ldlt_factor_f32: one (128, 128) rank-1 sweep,
        # and that times the number of super-blocks
        block = jnp.asarray(A[:128, :128], jnp.float32)
        sweep_ms = median_ms(rank1_sweep, (block,))
        row["rank1_sweep_128_ms"] = sweep_ms
        row["rank1_sweeps_total_ms"] = sweep_ms * -(-size // 128)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
