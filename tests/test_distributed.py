"""Multi-host initialization and cross-process sweep test (SURVEY §5
"jax.distributed for multi-host init").

Spawns two REAL processes, each simulating a 4-device host, connected
through the JAX coordination service (CPU Gloo collectives), and checks
that DistributedSolver returns the same full-batch result on every host
— and the same result the single-process BatchedSolver computes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pygradflow_tpu import Params
from pygradflow_tpu.parallel import BatchedSolver
from pygradflow_tpu.parallel.distributed import host_batch_slice, init_distributed

from tests.problems import Rosenbrock

PORT = "12421"


def test_init_distributed_single_process_noop():
    """Without a coordinator configured this degrades to topology info."""
    info = init_distributed()
    assert info.num_processes == 1
    assert info.process_id == 0
    assert info.local_devices == info.global_devices


def test_host_batch_slice():
    assert host_batch_slice(12, process_id=0, num_processes=3) == slice(0, 4)
    assert host_batch_slice(12, process_id=2, num_processes=3) == slice(8, 12)
    with pytest.raises(ValueError, match="divisible"):
        host_batch_slice(10, process_id=0, num_processes=3)


@pytest.mark.slow
def test_two_process_sweep(tmp_path):
    """2 hosts x 4 devices: both processes must converge every lane and
    agree bitwise on the gathered full-batch result."""
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "distributed_worker.py")
    env = {
        k: v
        for k, v in os.environ.items()
        # start each worker from a clean import path and device selection
        if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")
    }
    outs = [str(tmp_path / f"p{i}.npz") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), PORT, outs[i]],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            cwd=os.path.dirname(worker),
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-3000:]}"

    r0, r1 = [np.load(o) for o in outs]
    np.testing.assert_array_equal(r0["status"], r1["status"])
    # skewed-clock TimeLimit run stopped collectively on both hosts
    np.testing.assert_array_equal(r0["status_timelimit"], r1["status_timelimit"])
    np.testing.assert_array_equal(r0["x"], r1["x"])
    np.testing.assert_array_equal(r0["iterations"], r1["iterations"])

    from pygradflow_tpu.status import SolverStatus

    assert (r0["status"] == int(SolverStatus.Optimal)).all()
    np.testing.assert_allclose(r0["x"], 1.0, atol=1e-5)

    # cross-check against the single-process batched solve
    x0s = np.stack(
        [np.array([0.1 * i - 0.4, 0.05 * i]) for i in range(8)], axis=0
    )
    ref = BatchedSolver(Rosenbrock(), Params()).solve(x0s)
    np.testing.assert_array_equal(r0["iterations"], np.asarray(ref.iterations))
    np.testing.assert_allclose(r0["x"], np.asarray(ref.x), rtol=1e-12)
