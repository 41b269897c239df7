"""Batched instance sweeps: ``vmap`` over the whole solver loop.

The reference parallelizes instance sweeps with a ProcessPoolExecutor over
OS processes (``runners/runner.py:107-153``).  Here batching is a
*transform*: the entire homotopy loop (one ``SolveLoop.body``) is vmapped
over an instance batch, so one device advances every instance in
lockstep — factorizations become batched dense kernels.

Heterogeneous convergence is handled by per-lane status: ``body`` wraps the
iteration in ``lax.cond`` on the lane's status, which under vmap becomes a
``select`` — converged lanes' updates are computed but discarded, and the
chunk loop stops when every lane has a terminal status.

Large f64 batches are COMPUTE-bound (RESULTS.md: the B=16384 HS71 sweep
stops being latency-bound), so discarded lockstep updates are real cost:
with a median of ~20 iterations and stragglers at 2-3x that, full-width
lockstep pays ``B * max_iters`` lane-iterations for ``~B * median`` of
useful work.  ``compact=True`` (auto for large batches) harvests
terminated lanes at chunk boundaries and re-packs the active remainder
into power-of-four width tiers, so straggler iterations run at straggler
width.  Lane trajectories are unchanged — lanes are independent and
compaction only permutes them (equivalence tested in
``tests/test_batch.py``).

Per-instance *problem data* (a "scenario sweep": same structure, different
coefficients) is supported through :class:`ParametricProblem`: the data
pytree is an explicit vmapped argument, bound to the problem object at
trace time.
"""

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..jit import jit
from ..params import Params
from ..problem import Problem
from ..solver import SolveLoop
from ..status import RUNNING, SolverStatus
from ..timer import Timer
from ..transform import Transformation
from ..iterate import bounds_dual, cons_violation, stat_res, total_res


class ParametricProblem(Problem):
    """Problem with per-instance data.

    Subclasses implement ``p_obj(x, data)`` (and optionally
    ``p_cons(x, data)``) instead of ``obj``/``cons``; ``data`` is any
    pytree of arrays.  A batch of instances is then a batch of data
    pytrees, swept by :class:`BatchedSolver`.
    """

    _parametric = True

    def __init__(self, var_lb, var_ub, example_data, **args):
        self.data = example_data
        super().__init__(var_lb, var_ub, **args)

    def p_obj(self, x, data):
        raise NotImplementedError()

    def p_cons(self, x, data):
        raise NotImplementedError()

    def obj(self, x):
        return self.p_obj(x, self.data)

    def cons(self, x):
        return self.p_cons(x, self.data)


class BatchResult(NamedTuple):
    """Structure-of-arrays result of a batched solve (leading dim = batch)."""

    x: Any
    y: Any
    d: Any
    status: Any  # int32 (B,), SolverStatus values
    iterations: Any
    accepted_steps: Any
    total_res: Any
    cons_violation: Any
    stat_res: Any

    @property
    def success(self):
        return np.asarray(self.status) == int(SolverStatus.Optimal)


class BatchedSolver:
    """Solves a batch of instances of one problem structure in lockstep.

    ``problem`` may be a plain :class:`Problem` (batch over initial points
    only) or a :class:`ParametricProblem` (additionally batch over a data
    pytree).
    """

    def __init__(
        self,
        problem: Problem,
        params: Optional[Params] = None,
        compact: Optional[bool] = None,
        harvest_chunk: Optional[int] = None,
        min_tier: int = 64,
    ):
        """``compact``: harvest terminated lanes at chunk boundaries and
        shrink the running batch to power-of-four width tiers (None =
        auto: enabled when the batch is at least ``4 * min_tier`` wide —
        free for tight iteration distributions, which simply never
        shrink).  ``harvest_chunk`` sets the iterations between shrink
        checks (None = ``params.jit_chunk``: no extra dispatches at all;
        smaller values find the shrink point earlier on long-tailed
        batches at one host round trip per extra chunk).  ``min_tier``
        is the smallest width tiers shrink to (each tier is one extra XLA
        compilation of the chunk loop)."""
        if params is None:
            params = Params()
        # display/callbacks are host side effects — meaningless per-lane
        assert not params.display, "display is not supported in batched mode"
        assert not params.collect_path, "collect_path is not supported in batched mode"

        self.orig_problem = problem
        self.params = params
        self.transform = Transformation(problem, params)
        self.loop = SolveLoop(self.transform, params, callbacks=None)
        self.parametric = isinstance(problem, ParametricProblem)
        self.compact = compact
        self.harvest_chunk = None if harvest_chunk is None else int(harvest_chunk)
        self.min_tier = int(min_tier)

        self._run = jit(self._run_chunk, static_argnums=(2,))

        # compaction helpers built ONCE for the same reason as
        # _init_jit/_finalize_jit below: fresh @jax.jit closures per
        # solve() would re-trace on every call (jit caches on function
        # identity)
        def _archive_scatter(archive, states, orig_idx):
            return jax.tree_util.tree_map(
                lambda a, c: a.at[orig_idx].set(c, mode="drop"), archive, states
            )

        def _shrink(states, cur_data, orig_idx, gather):
            states = jax.tree_util.tree_map(lambda a: a[gather], states)
            if cur_data is not None:
                cur_data = jax.tree_util.tree_map(lambda a: a[gather], cur_data)
            return states, cur_data, orig_idx[gather]

        self._archive_scatter_jit = jit(_archive_scatter)
        self._shrink_jit = jit(_shrink)

        # jitted init/finalize are built ONCE: constructing a fresh
        # closure per solve() defeats jax's jit cache and re-traces and
        # re-lowers on every call (the same bug once hit the sharded
        # sweep, parallel/shard.py)
        if self.parametric:

            def _init_vm(x, y, d):
                xt, yt = self._transform_initial(x, y, d)
                return self._init_one(xt, yt, d)

            self._init_jit = jit(jax.vmap(_init_vm))
            self._finalize_jit = jit(jax.vmap(self._finalize_one))
        else:

            def _init_vm(x, y):
                xt, yt = self._transform_initial(x, y, None)
                return self._init_one(xt, yt, None)

            self._init_jit = jit(jax.vmap(_init_vm))
            self._finalize_jit = jit(
                jax.vmap(lambda s: self._finalize_one(s, None))
            )

    # ------------------------------------------------------------------

    def _bind(self, data):
        """Bind a (possibly traced) data pytree to the parametric problem.

        Assignment at trace time routes the vmapped tracer through the
        problem's evaluation closures; the jitted computation that results
        takes ``data`` as an explicit argument.
        """
        if data is not None:
            self.orig_problem.data = data

    def _init_one(self, x0, y0, data):
        self._bind(data)
        return self.loop.init_state(x0, y0)

    def _body_one(self, state, data):
        self._bind(data)
        return self.loop.body(state)

    def _run_chunk(self, states, datas, chunk: int):
        def cond(carry):
            states, i = carry
            return jnp.logical_and(
                i < chunk, jnp.any(states.status == RUNNING)
            )

        def body(carry):
            states, i = carry
            if self.parametric:
                states = jax.vmap(self._body_one)(states, datas)
            else:
                states = jax.vmap(lambda s: self._body_one(s, None))(states)
            return (states, i + 1)

        (states, _) = jax.lax.while_loop(
            cond, body, (states, jnp.zeros((), jnp.int32))
        )
        return states

    # ------------------------------------------------------------------

    def solve(self, x0, y0=None, data=None) -> BatchResult:
        """Solve the batch.  ``x0``: (B, n_orig); ``y0``: (B, m_orig) or
        None; ``data``: batched pytree for parametric problems."""
        params = self.params
        loop = self.loop

        x0 = jnp.asarray(x0, dtype=params.dtype)
        B = x0.shape[0]
        if y0 is None:
            y0 = jnp.zeros((B, self.orig_problem.num_cons), dtype=params.dtype)
        else:
            y0 = jnp.asarray(y0, dtype=params.dtype)

        if self.parametric:
            assert data is not None, "ParametricProblem requires batched data"
            states = self._init_jit(x0, y0, data)
        else:
            states = self._init_jit(x0, y0)

        timer = Timer(params.time_limit)
        compact = self.compact
        if compact is None:
            compact = B >= 4 * self.min_tier
        if compact:
            return self._solve_compacting(states, data, B, timer)

        chunk = params.jit_chunk
        while True:
            states = self._run(states, data, chunk)
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

        return self._collect(states, data)

    # ------------------------------------------------------------------

    def _solve_compacting(self, states, data, B: int, timer) -> BatchResult:
        """Chunked solve with device-resident lane harvesting + width
        compaction.

        Invariants: ``states`` has width ``W``; its first ``L`` lanes are
        still-running instances, the rest padding (copies of done lanes —
        non-RUNNING status, so ``body``'s status cond freezes them).
        ``orig_idx`` (device, width ``W``) maps each lane to its original
        batch row, with ``B`` (out of range) for pads.  ``archive`` is a
        full-width device buffer; lanes are scattered back into it (pads
        dropped via ``mode='drop'``) whenever the active set shrinks to a
        smaller power-of-four tier and once at the end — everything stays
        on device, and the per-harvest cost is ONE fused jit dispatch.
        The only host traffic is the per-chunk status vector."""
        params = self.params
        chunk = (
            params.jit_chunk
            if self.harvest_chunk is None
            else min(params.jit_chunk, self.harvest_chunk)
        )

        cur_data = (
            jax.tree_util.tree_map(jnp.asarray, data) if self.parametric else None
        )

        _archive_scatter = self._archive_scatter_jit
        _shrink = self._shrink_jit

        archive = states  # full-B buffer, overwritten by scatters
        orig_idx = jnp.arange(B)
        active = np.arange(B)  # host mirror of orig_idx[:L]
        L = B
        timed_out = False
        shrunk = False  # no shrink => states IS the full batch in order

        while True:
            states = self._run(states, cur_data, chunk)
            status = np.asarray(states.status[:L])
            running = status == RUNNING
            timed_out = timer.reached_time_limit()
            if timed_out or not running.any():
                break

            # shrink (and scatter the done lanes out) only when the
            # active set fits a smaller power-of-four tier — a tight
            # iteration distribution then pays zero compaction overhead
            keep = np.where(running)[0]
            W = int(states.status.shape[0])
            new_W = W
            while new_W // 4 >= max(keep.size, self.min_tier):
                new_W //= 4
            if new_W == W:
                continue
            archive = _archive_scatter(archive, states, orig_idx)
            # pad with done lanes (terminal status freezes them, and their
            # just-archived values make any re-scatter a harmless
            # overwrite); duplicates are fine when fewer dones than pads.
            # orig_idx pads are mapped out of range so scatters drop them
            done_rows = np.where(~running)[0]
            pad_n = new_W - keep.size
            pad_rows = np.resize(done_rows, pad_n) if pad_n else done_rows[:0]
            gather_np = np.concatenate([keep, pad_rows])
            gather = jnp.asarray(gather_np)
            states, cur_data, orig_idx = _shrink(
                states, cur_data, orig_idx, gather
            )
            orig_idx = orig_idx.at[keep.size:].set(B)
            active = active[keep]
            L = int(active.size)
            shrunk = True

        # a scatter at full width is not free — skip it entirely when
        # the width never changed (tight iteration distributions)
        archive = (
            _archive_scatter(archive, states, orig_idx) if shrunk else states
        )
        if timed_out:
            archive = archive._replace(
                status=jnp.where(
                    archive.status == RUNNING,
                    int(SolverStatus.TimeLimit),
                    archive.status,
                )
            )
        return self._collect(archive, data)

    def _transform_initial(self, x, y, data):
        """Traced equivalent of Transformation.create_transformed_initial."""
        self._bind(data)
        transform = self.transform
        if transform.scaling is not None:
            x = transform.scaling.scale_primal(x)
            y = transform.scaling.scale_dual(y)
        return transform.trans_problem.transform_sol(x, y)

    def _finalize_one(self, state, d):
        self._bind(d)
        loop = self.loop
        params = self.params
        it = state.it
        dual = bounds_dual(it, loop.lb, loop.ub, params.active_tol, loop.fns)
        (x, y, dd) = self.transform.restore_sol(it.x, it.y, dual)
        return (
            x,
            y,
            dd,
            total_res(it, loop.lb, loop.ub, params.active_tol, loop.fns),
            cons_violation(it),
            stat_res(it, loop.lb, loop.ub, params.active_tol, loop.fns),
        )

    def _collect(self, states, data) -> BatchResult:
        if self.parametric:
            outs = self._finalize_jit(states, data)
        else:
            outs = self._finalize_jit(states)

        (x, y, d, tres, cviol, sres) = outs
        return BatchResult(
            x=np.asarray(x),
            y=np.asarray(y),
            d=np.asarray(d),
            status=np.asarray(states.status),
            iterations=np.asarray(states.iteration),
            accepted_steps=np.asarray(states.accepted_steps),
            total_res=np.asarray(tres),
            cons_violation=np.asarray(cviol),
            stat_res=np.asarray(sres),
        )
