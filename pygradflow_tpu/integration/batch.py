"""Batched continuous-flow solves on the flat chunked engine.

The reference's scipy-BDF IntegrationSolver is inherently sequential per
instance; this runs a whole batch of continuous-homotopy solves on one
chip (and under ``shard_map`` across a mesh), the same instance-axis
parallelism as ``parallel/batch.py`` for the discrete engine.

Round-2 lesson (``artifacts/r2_integration_batch.json``: 0.08x the
sequential reference): vmapping the NESTED device loop synchronizes
lanes at every nesting level and pays both sides of every ``lax.cond``.
This version uses ``integration/flat_loop.py`` — one uniform work unit
per loop iteration, so lanes progress independently — and executes in
chunks of ``params.integration_chunk`` work units:

- ``params.time_limit`` is enforced between dispatches (no dispatch is
  unboundedly long, so a straggler lane cannot hold the device past it);
- converged lanes are harvested at chunk boundaries and the active
  remainder is compacted to the next power-of-two tier, so late-stage
  straggler chunks run on small batches (pays off on CPU and in
  HBM/step cost on wide batches; the lockstep critical path itself is
  already solved by the flat engine).
"""

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..iterate import bounds_dual, evaluate_iterate
from ..jit import jit
from ..params import Params
from ..status import RUNNING, SolverStatus
from ..timer import Timer
from . import flow as fl
from .flat_loop import make_flat_loop
from .integration_solver import IntegrationSolver

_HARVEST_KEYS = ("z", "status", "iteration", "rho", "steps", "newtons")
_MIN_TIER = 8


class BatchedIntegrationResult(NamedTuple):
    """Structure-of-arrays result (leading dim = batch)."""

    x: Any
    y: Any
    d: Any
    status: Any  # int32 (B,) SolverStatus values
    iterations: Any  # segments per lane
    rho: Any
    num_integration_steps: Any
    num_newton_steps: Any

    @property
    def success(self):
        return np.asarray(self.status) == int(SolverStatus.Optimal)


class ShardedIntegrationSolver:
    """Continuous-engine instance sweep sharded over a device mesh — the
    multi-chip counterpart of :class:`BatchedIntegrationSolver`, mirroring
    the discrete engine's ``parallel.ShardedSolver``.

    The instance batch is split along a 1-D mesh axis; every device
    advances its shard of lanes through the flat chunked engine
    (``integration/flat_loop.py``) in lockstep.  There is NO cross-shard
    collective inside a chunk: each shard's vmapped work loop is bounded
    by ``params.integration_chunk`` units and exits early once its local
    lanes terminate, so shards never wait on one another mid-chunk; the
    host checks global termination between dispatches.  Per-lane results
    match the single-chip batched engine (statuses and solutions; segment
    counts can differ by one where a borderline event crossing rounds
    differently under the different vectorization width — tested in
    ``tests/test_integration_batch.py``)."""

    AXIS = "instances"

    def __init__(self, problem, params=None, mesh=None):
        import numpy as _np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        self.batched = BatchedIntegrationSolver(problem, params)
        self.params = self.batched.params
        if mesh is None:
            mesh = Mesh(_np.array(jax.devices()), (self.AXIS,))
        self.mesh = mesh
        self.num_devices = mesh.devices.size
        self._P = P
        self._NamedSharding = NamedSharding

        chunk_fn = self.batched._chunk_fn
        budget = int(self.params.integration_chunk)

        def local_chunk(states):
            return jax.vmap(lambda s: chunk_fn(s, budget))(states)

        spec = P(self.AXIS)

        def specs_like(tree):
            return jax.tree_util.tree_map(lambda _: spec, tree)

        self._local_chunk = local_chunk
        self._spec = spec
        self._specs_like = specs_like
        self._run = None  # built lazily once the state structure is known

    def solve(self, x0s, y0s=None) -> BatchedIntegrationResult:
        params = self.params
        batched = self.batched
        x0s = jnp.asarray(x0s, dtype=params.dtype)
        B = x0s.shape[0]
        nd = self.num_devices
        assert B % nd == 0, (
            f"batch size {B} must be divisible by the mesh size {nd} "
            "(pad the batch)"
        )
        if y0s is None:
            y0s = jnp.zeros(
                (B, batched.inner.orig_problem.num_cons), dtype=params.dtype
            )
        else:
            y0s = jnp.asarray(y0s, dtype=params.dtype)

        states = batched._init(x0s, y0s)
        sharding = self._NamedSharding(self.mesh, self._spec)
        states = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, sharding), states
        )
        if self._run is None:
            self._run = jit(
                jax.shard_map(
                    self._local_chunk,
                    mesh=self.mesh,
                    in_specs=(self._specs_like(states),),
                    out_specs=self._specs_like(states),
                    # per-shard work only (no collectives); skip the
                    # varying-manual-axes checker, which rejects
                    # replicated constants created inside lax control flow
                    check_vma=False,
                )
            )

        timer = Timer(params.time_limit)
        while True:
            states = self._run(states)
            if not bool(jnp.any(states["status"] == RUNNING)):
                break
            if timer.reached_time_limit():
                states = dict(
                    states,
                    status=jnp.where(
                        states["status"] == RUNNING,
                        int(SolverStatus.TimeLimit),
                        states["status"],
                    ),
                )
                break

        xr, yr, dr = jax.device_get(batched._post(states["z"]))
        return BatchedIntegrationResult(
            x=xr,
            y=yr,
            d=dr,
            status=np.asarray(states["status"], dtype=np.int32),
            iterations=np.asarray(states["iteration"], dtype=np.int32),
            rho=np.asarray(states["rho"]),
            num_integration_steps=np.asarray(states["steps"], dtype=np.int32),
            num_newton_steps=np.asarray(states["newtons"], dtype=np.int32),
        )


class BatchedIntegrationSolver:
    """Solves a batch of instances of ONE problem with the continuous
    engine, fully on device."""

    def __init__(self, problem, params: Optional[Params] = None):
        self.inner = IntegrationSolver(problem, params or Params())
        self.params = self.inner.params

        inner = self.inner
        transform = inner.transform
        fns = inner.fns
        lb, ub = inner.lb, inner.ub
        active_tol = inner.params.active_tol
        ctx = inner.ctx

        init_fn, chunk_fn, _ = make_flat_loop(
            inner.cfg, fns, lb, ub, inner.params
        )
        self._chunk_fn = chunk_fn

        def init_one(x0, y0):
            xt, yt = transform.transform_sol(x0, y0)
            return init_fn(xt, yt)

        self._init = jit(jax.vmap(init_one))

        def post_one(z):
            x, y = fl.split(ctx, z)
            it = evaluate_iterate(fns, x, y)
            d = bounds_dual(it, lb, ub, active_tol)
            return transform.restore_sol(it.x, it.y, d)

        self._post = jit(jax.vmap(post_one))
        self._chunks = {}  # padded tier size -> jitted vmapped chunk

    def _chunk_for(self, tier: int):
        if tier not in self._chunks:
            budget = int(self.params.integration_chunk)
            self._chunks[tier] = jit(
                jax.vmap(lambda s: self._chunk_fn(s, budget))
            )
        return self._chunks[tier]

    # ------------------------------------------------------------------

    def solve(self, x0s, y0s=None) -> BatchedIntegrationResult:
        params = self.params
        x0s = jnp.asarray(x0s, dtype=params.dtype)
        B = x0s.shape[0]
        if y0s is None:
            y0s = jnp.zeros(
                (B, self.inner.orig_problem.num_cons), dtype=params.dtype
            )
        else:
            y0s = jnp.asarray(y0s, dtype=params.dtype)

        states = self._init(x0s, y0s)
        timer = Timer(params.time_limit)

        final = {k: [None] * B for k in _HARVEST_KEYS}
        active_orig = np.arange(B)

        def harvest(rows_local, rows_orig, states, timed_out=False):
            # ONE packed transfer: each eager fetch is a device round trip
            sub = jax.device_get(
                {k: states[k][rows_local] for k in _HARVEST_KEYS}
            )
            if timed_out:
                sub["status"] = np.where(
                    sub["status"] == RUNNING,
                    int(SolverStatus.TimeLimit),
                    sub["status"],
                )
            for j, orig in enumerate(rows_orig):
                for k in _HARVEST_KEYS:
                    final[k][orig] = sub[k][j]

        while active_orig.size:
            L = int(active_orig.size)
            tier = max(_MIN_TIER, 1 << (L - 1).bit_length())
            if tier > L:
                # pad with frozen copies of lane 0 (status DONE-equivalent)
                pad = tier - L

                def pad_leaf(a, key=None):
                    fill = jnp.repeat(a[:1], pad, axis=0)
                    return jnp.concatenate([a, fill], axis=0)

                states = {
                    k: pad_leaf(v) for k, v in states.items()
                }
                states["status"] = states["status"].at[L:].set(
                    int(SolverStatus.IterationLimit)
                )

            states = self._chunk_for(tier)(states)
            status = np.asarray(states["status"][:L])
            done_local = np.where(status != RUNNING)[0]

            if timer.reached_time_limit():
                harvest(np.arange(L), active_orig, states, timed_out=True)
                active_orig = np.arange(0)
                break

            if done_local.size:
                harvest(done_local, active_orig[done_local], states)
                keep = np.where(status == RUNNING)[0]
                active_orig = active_orig[keep]
                if active_orig.size:
                    keep_dev = jnp.asarray(keep)
                    states = {
                        k: v[keep_dev] for k, v in states.items()
                    }
            else:
                states = {k: v[:L] for k, v in states.items()}

        z = jnp.asarray(np.stack(final["z"], axis=0))
        xr, yr, dr = jax.device_get(self._post(z))

        return BatchedIntegrationResult(
            x=xr,
            y=yr,
            d=dr,
            status=np.asarray(final["status"], dtype=np.int32),
            iterations=np.asarray(final["iteration"], dtype=np.int32),
            rho=np.asarray(final["rho"]),
            num_integration_steps=np.asarray(final["steps"], dtype=np.int32),
            num_newton_steps=np.asarray(final["newtons"], dtype=np.int32),
        )
