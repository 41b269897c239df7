"""Multi-device instance sweeps: ``shard_map`` over a device mesh.

The counterpart of the reference's multiprocessing benchmark fan-out
(``runners/runner.py:107-153``), scaled past one device: the instance
batch is sharded along a 1-D mesh axis over ``jax.devices()`` (the GPUs
of one host, all joined to each other by NVLink, so the mesh needs no
topology), every device advances its shard of instances in lockstep
(vmapped solver loop), and the only cross-device communication is the
convergence reduction — a ``psum`` of per-shard running-lane counts
deciding when the chunk loop may stop.

Works identically on GPUs and on the CPU simulation mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``).
"""

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..jit import jit
from ..params import Params
from ..problem import Problem
from ..status import RUNNING, SolverStatus
from ..timer import Timer
from .batch import BatchedSolver, BatchResult

AXIS = "instances"


class ShardedSolver:
    """Solves an instance batch sharded over a device mesh."""

    def __init__(
        self,
        problem: Problem,
        params: Optional[Params] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.batched = BatchedSolver(problem, params)
        self.params = self.batched.params

        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), (AXIS,))
        self.mesh = mesh
        self.num_devices = mesh.devices.size

        loop = self.batched.loop
        chunk = self.params.jit_chunk
        parametric = self.batched.parametric

        def shard_chunk(states, datas):
            """Per-shard chunk runner (executes inside shard_map)."""

            def cond(carry):
                states, i = carry
                local_running = jnp.any(states.status == RUNNING).astype(jnp.int32)
                # collective: all shards agree on continuation
                global_running = jax.lax.psum(local_running, AXIS)
                return jnp.logical_and(i < chunk, global_running > 0)

            def body(carry):
                states, i = carry
                if parametric:
                    states = jax.vmap(self.batched._body_one)(states, datas)
                else:
                    states = jax.vmap(
                        lambda s: self.batched._body_one(s, None)
                    )(states)
                return (states, i + 1)

            (states, _) = jax.lax.while_loop(
                cond, body, (states, jnp.zeros((), jnp.int32))
            )
            return states

        spec = P(AXIS)

        def specs_like(tree):
            return jax.tree_util.tree_map(lambda _: spec, tree)

        self._shard_chunk = shard_chunk
        self._spec = spec
        self._specs_like = specs_like
        # the jitted shard_map is built ONCE per (states, data) structure:
        # rebuilding it per solve() call creates a fresh closure each time,
        # which defeats jax's jit cache and recompiles on EVERY solve
        self._runs = {}

    def solve(self, x0, y0=None, data=None) -> BatchResult:
        params = self.params
        batched = self.batched

        x0 = jnp.asarray(x0, dtype=params.dtype)
        B = x0.shape[0]
        nd = self.num_devices
        assert B % nd == 0, (
            f"batch size {B} must be divisible by the mesh size {nd} "
            "(pad the batch)"
        )

        if y0 is None:
            y0 = jnp.zeros((B, batched.orig_problem.num_cons), dtype=params.dtype)
        else:
            y0 = jnp.asarray(y0, dtype=params.dtype)

        # initialize states (vmapped, unsharded, via the batched solver's
        # CACHED jitted init — per-call closures re-trace every solve),
        # then shard
        if batched.parametric:
            assert data is not None
            states = batched._init_jit(x0, y0, data)
        else:
            states = batched._init_jit(x0, y0)

        sharding = NamedSharding(self.mesh, self._spec)
        states = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, sharding), states
        )
        if data is not None:
            data = jax.tree_util.tree_map(
                lambda a: jax.device_put(jnp.asarray(a), sharding), data
            )

        key = (
            jax.tree_util.tree_structure(states),
            jax.tree_util.tree_structure(data),
            jax.tree_util.tree_map(lambda a: a.shape, states),
        )
        run = self._runs.get(key)
        if run is None:
            run = jit(
                jax.shard_map(
                    self._shard_chunk,
                    mesh=self.mesh,
                    in_specs=(self._specs_like(states), self._specs_like(data)),
                    out_specs=self._specs_like(states),
                    # the body is purely per-shard work (the only collective
                    # is the psum in the loop condition); skip the varying-
                    # manual-axes checker, which rejects replicated constants
                    # created inside lax control flow
                    check_vma=False,
                )
            )
            self._runs[key] = run

        timer = Timer(params.time_limit)
        while True:
            states = run(states, data)
            if not bool(jnp.any(states.status == RUNNING)):
                break
            if timer.reached_time_limit():
                states = states._replace(
                    status=jnp.where(
                        states.status == RUNNING,
                        int(SolverStatus.TimeLimit),
                        states.status,
                    )
                )
                break

        return batched._collect(states, data)
