"""Multi-process initialization and host-local batch slicing.

Closes SURVEY §5 "jax.distributed for multi-host init": the reference's
instance sweeps scale with a single-machine process pool
(``runners/runner.py:107-153``).  Here one process drives all the GPUs of
a host (``ShardedSolver`` over a 1-D mesh of ``jax.devices()``); several
processes, one per host or one per GPU, join through JAX's coordination
service and lay the instance batch over the global device mesh, so the
only cross-device traffic is the convergence psum.

Typical multi-process recipe (same program in every process)::

    from pygradflow_tpu.parallel import init_distributed, DistributedSolver

    init_distributed("host0:1234", num_processes=N, process_id=i)
    solver = DistributedSolver(problem, params)
    result = solver.solve(x0_global)      # every process passes the FULL batch

Each process feeds only its local slice of the batch to its local
devices (``jax.make_array_from_process_local_data``); results are
gathered back so every process returns the full ``BatchResult``.

On CPU, the same code runs multi-process for testing:
``jax.distributed.initialize(coordinator_address="localhost:<port>",
num_processes=N, process_id=i)`` with
``--xla_force_host_platform_device_count`` (see
``tests/test_distributed.py``).
"""

import os
from typing import NamedTuple, Optional

import jax
import numpy as np
from jax.sharding import Mesh

from ..jit import jit
from ..params import Params
from ..problem import Problem
from .shard import AXIS, ShardedSolver


@jit
def _any_running(status):
    import jax.numpy as jnp

    from ..status import RUNNING

    return jnp.any(status == RUNNING)


class DistributedInfo(NamedTuple):
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> DistributedInfo:
    """Join the multi-process runtime and report the global topology.

    The coordinator is either passed explicitly or taken from
    ``JAX_COORDINATOR_ADDRESS`` (with ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``, as set by a launcher).  Safe to call when already
    initialized or when genuinely single-process: both degrade to a no-op
    that just reports topology.
    """
    # must not touch jax.process_count()/devices() before initialize —
    # they'd spin up the single-process backend first
    already = jax.distributed.is_initialized()
    explicit = coordinator_address is not None
    env_driven = bool(os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if not already and (explicit or env_driven):
        kwargs = {}
        if explicit:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        if local_device_ids is not None:
            kwargs["local_device_ids"] = local_device_ids
        jax.distributed.initialize(**kwargs)

    return DistributedInfo(
        process_id=jax.process_index(),
        num_processes=jax.process_count(),
        local_devices=jax.local_device_count(),
        global_devices=jax.device_count(),
    )


def host_batch_slice(
    batch_size: int,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> slice:
    """The contiguous rows of a global instance batch owned by one host.

    Row-sharding along the mesh axis maps batch rows to global devices in
    device order, so with each host's devices contiguous in
    ``jax.devices()`` (the JAX guarantee for a 1-D process-major listing)
    each host owns one contiguous block of ``batch_size / num_processes``
    rows.
    """
    pid = jax.process_index() if process_id is None else process_id
    np_ = jax.process_count() if num_processes is None else num_processes
    if batch_size % np_ != 0:
        raise ValueError(
            f"batch size {batch_size} must be divisible by the process "
            f"count {np_} (pad the batch)"
        )
    per = batch_size // np_
    return slice(pid * per, (pid + 1) * per)


class DistributedSolver(ShardedSolver):
    """ShardedSolver over the GLOBAL device mesh of a multi-process run.

    Every process calls :meth:`solve` with the same full batch; the
    solver slices out the host-local rows, initializes states on local
    devices only, stitches them into global arrays, runs the shard_map
    chunk loop (cross-host psum for the convergence vote), and
    all-gathers the results so each host returns the complete
    ``BatchResult``.
    """

    def __init__(self, problem: Problem, params: Optional[Params] = None):
        mesh = Mesh(np.array(jax.devices()), (AXIS,))
        super().__init__(problem, params, mesh=mesh)

    def solve(self, x0, y0=None, data=None):
        if jax.process_count() == 1:
            return super().solve(x0, y0, data=data)
        return self._solve_multiprocess(x0, y0, data)

    def _solve_multiprocess(self, x0, y0, data):
        import jax.numpy as jnp
        from jax.sharding import NamedSharding

        from ..status import RUNNING, SolverStatus
        from ..timer import Timer

        params = self.params
        batched = self.batched

        x0 = np.asarray(x0, dtype=params.dtype)
        B = x0.shape[0]
        nd = self.num_devices
        if B % nd != 0:
            raise ValueError(
                f"batch size {B} must be divisible by the global device "
                f"count {nd} (pad the batch)"
            )

        if y0 is None:
            y0 = np.zeros((B, batched.orig_problem.num_cons), dtype=params.dtype)
        else:
            y0 = np.asarray(y0, dtype=params.dtype)

        rows = host_batch_slice(B)
        x_loc = jnp.asarray(x0[rows])
        y_loc = jnp.asarray(y0[rows])
        data_loc = (
            jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)[rows]), data)
            if data is not None
            else None
        )

        # init the local rows on local devices (via the batched solver's
        # CACHED jitted init — per-call closures re-trace every solve),
        # then stitch into global arrays spanning the full mesh
        if batched.parametric:
            assert data is not None
            states_loc = batched._init_jit(x_loc, y_loc, data_loc)
        else:
            states_loc = batched._init_jit(x_loc, y_loc)

        sharding = NamedSharding(self.mesh, self._spec)

        def globalize(local):
            return jax.make_array_from_process_local_data(
                sharding, np.asarray(local)
            )

        states = jax.tree_util.tree_map(globalize, states_loc)
        if data is not None:
            data = jax.tree_util.tree_map(globalize, data_loc)

        # cache the jitted shard_map per argument structure (a fresh
        # closure per solve() defeats the jit cache and recompiles every
        # call — see parallel/shard.py)
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
                    check_vma=False,
                )
            )
            self._runs[key] = run

        # every process must iterate in lockstep: the continuation vote is
        # a collective over the global status array, replicated to all

        from jax.experimental import multihost_utils

        timer = Timer(params.time_limit)
        has_time_limit = np.isfinite(params.time_limit)
        while True:
            states = run(states, data)
            if not bool(_any_running(states.status)):
                break
            # the stop decision must be collectively consistent: clock /
            # start skew could make one host break with TimeLimit while
            # others re-enter run(), whose shard_map psum is a cross-host
            # collective (mismatched collectives hang every process) — so
            # process 0's verdict is broadcast and used by every host
            timed_out = timer.reached_time_limit()
            if has_time_limit and jax.process_count() > 1:
                timed_out = bool(
                    multihost_utils.broadcast_one_to_all(
                        np.asarray(timed_out)
                    )
                )
            if timed_out:
                states = states._replace(
                    status=jnp.where(
                        states.status == RUNNING,
                        int(SolverStatus.TimeLimit),
                        states.status,
                    )
                )
                break

        # replicate results on every host before the host-side collect:
        # pull each host's contiguous row block out of the global arrays,
        # then allgather the blocks in process order (= row order)
        def local_rows(a):
            # extract this host's global row block by shard INDEX rather
            # than concatenating shard data: XLA may mark degenerate
            # leaves (zero-element arrays) replicated, where every shard
            # spans all rows and naive concatenation inflates the batch
            out = np.empty(
                (rows.stop - rows.start,) + a.shape[1:], dtype=a.dtype
            )
            for s in a.addressable_shards:
                idx0 = s.index[0] if s.index else slice(None)
                start = idx0.start or 0
                stop = a.shape[0] if idx0.stop is None else idx0.stop
                lo, hi = max(start, rows.start), min(stop, rows.stop)
                if hi > lo:
                    data = np.asarray(s.data)
                    out[lo - rows.start : hi - rows.start] = data[
                        lo - start : hi - start
                    ]
            return out

        def gather(a):
            return multihost_utils.process_allgather(local_rows(a), tiled=True)

        states = jax.tree_util.tree_map(gather, states)
        if data is not None:
            data = jax.tree_util.tree_map(gather, data)
        return batched._collect(states, data)
