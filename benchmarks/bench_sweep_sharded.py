"""Sharded scenario sweep (BASELINE config #5): perturbed NLP instances
distributed over the available device mesh with the psum convergence
reduction.

Two modes:

- default (one measurement, current process topology): on one GPU the
  mesh has one device (pure vmap throughput); on a host with several
  GPUs the same script shards the batch over all of them unchanged.
  Writes ``artifacts/sweep_sharded.json``.
- ``--weak-scaling`` (round-4 verdict weak #6 / BASELINE "scaling
  efficiency"): the scaling curve is measured on the virtual CPU
  mesh — subprocesses with ``--xla_force_host_platform_device_count=N``
  for N in 1/2/4/8, FIXED per-device batch (weak scaling).  This pins
  the sharding overhead (shard_map + psum lockstep) and catches
  collective regressions; it is NOT a hardware-throughput claim.

Usage (GPUs):     python benchmarks/bench_sweep_sharded.py
      (CPU mesh): python benchmarks/bench_sweep_sharded.py --weak-scaling
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

BATCH = int(os.environ.get("BENCH_BATCH", 10240))


def measure(batch_env=None):
    import jax

    import jax.numpy as jnp

    from pygradflow_tpu import Params
    from pygradflow_tpu.parallel import ShardedSolver
    from pygradflow_tpu.parallel.batch import ParametricProblem

    class ParamRosenbrock(ParametricProblem):
        def __init__(self):
            super().__init__(
                np.array([-np.inf, -np.inf]),
                np.array([np.inf, np.inf]),
                example_data=(jnp.asarray(1.0), jnp.asarray(100.0)),
            )

        def p_obj(self, v, data):
            a, b = data
            return (a - v[0]) ** 2 + b * (v[1] - v[0] ** 2) ** 2

    devices = jax.devices()
    nd = len(devices)
    B = ((batch_env or BATCH) // nd) * nd

    rng = np.random.default_rng(0)
    x0s = rng.uniform(-1.5, 1.5, size=(B, 2))
    a = jnp.asarray(rng.uniform(0.5, 2.0, B))
    b = jnp.asarray(rng.uniform(50.0, 150.0, B))

    solver = ShardedSolver(
        ParamRosenbrock(), Params(validate_input=False, jit_chunk=128)
    )

    warm = solver.solve(x0s, data=(a, b))
    assert warm.success.all()

    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        res = solver.solve(x0s, data=(a, b))
        best = min(best, time.perf_counter() - t0)
    assert res.success.all()

    return {
        "metric": f"sharded perturbed-NLP sweep solves/sec (B={B}, devices={nd})",
        "value": round(B / best, 3),
        "unit": "solves/sec",
        "batch": B,
        "devices": nd,
        "wall_s": round(best, 4),
        "per_device": round(B / best / nd, 3),
        "platform": devices[0].platform,
    }


def weak_scaling(per_device_batch, device_counts):
    """Spawn one clean CPU subprocess per device count (device count is
    process-global in XLA) with a fixed per-device batch."""
    here = os.path.abspath(__file__)
    rows = []
    for nd in device_counts:
        env = {
            k: v
            for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")
        }
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={nd}"
        env["JAX_PLATFORMS"] = "cpu"
        env["BENCH_BATCH"] = str(per_device_batch * nd)
        out = subprocess.run(
            [sys.executable, here, "--single-json"],
            env=env,
            capture_output=True,
            text=True,
            timeout=1200,
        )
        if out.returncode != 0:
            raise RuntimeError(f"devices={nd} failed:\n{out.stderr[-2000:]}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(json.dumps(row), flush=True)

    base = rows[0]["value"]  # 1-device rate at the same per-device batch
    for row in rows:
        # weak-scaling efficiency: rate should grow linearly with devices
        row["weak_scaling_efficiency"] = round(
            row["value"] / (base * row["devices"]), 4
        )
    return rows


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--weak-scaling", action="store_true")
    parser.add_argument(
        "--single-json",
        action="store_true",
        help="internal: print one measurement row as JSON (subprocess mode)",
    )
    parser.add_argument("--per-device-batch", type=int, default=1024)
    parser.add_argument(
        "--devices", type=int, nargs="+", default=[1, 2, 4, 8]
    )
    args = parser.parse_args()

    if args.single_json:
        print(json.dumps(measure()), flush=True)
        return

    from baseline_cache import write_artifact

    if args.weak_scaling:
        rows = weak_scaling(args.per_device_batch, args.devices)
        payload = {
            "metric": "sharded sweep weak scaling (virtual CPU mesh, "
            f"per-device batch {args.per_device_batch})",
            "note": "sharding-overhead probe on the 8-device CPU mesh, "
            "not a hardware throughput claim",
            "rows": rows,
            "efficiency_at_max": rows[-1]["weak_scaling_efficiency"],
        }
        write_artifact("sweep_weak_scaling.json", payload)
        print(json.dumps(payload), flush=True)
        return

    row = measure()
    # merge: keep whichever platform rows exist (GPU + CPU-mesh)
    out_name = "sweep_sharded.json"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts", out_name)
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            prior = json.load(f)
        rows = [
            r
            for r in (prior if isinstance(prior, list) else [prior])
            if r.get("platform") != row["platform"]
            or r.get("devices") != row["devices"]
        ]
    rows.append(row)
    write_artifact(out_name, rows)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
