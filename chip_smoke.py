"""Smoke run of the solver's main paths on NVIDIA GPUs.

    python chip_smoke.py              # every one-GPU phase, in order
    python chip_smoke.py --four-gpus  # only the sharded paths, on four GPUs

Everything runs in one process, through the entry points a user calls
(``Solver``, ``BatchedSolver``, ``IntegrationSolver``, the sharded
drivers), at deployment widths, with data made from fixed seeds.  Each phase
checks its results against the repository's references and prints one line
of measurements tagged with the card's name and power limit.

The script refuses to run, with a non-zero exit and no result line, when
JAX finds no GPU (or fewer than four with ``--four-gpus``).  A phase that
fails prints its traceback; the remaining phases still run, and the script
then exits 1 without a result line.  On success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The phase functions take a size table so the tests can run them at tiny
sizes on the CPU (``tests/test_chip_smoke.py``).
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

FULL = dict(
    sweep_batch=16384,  # scenario/multistart sweep width
    parity_lanes=64,  # batched lanes re-solved one by one with Solver
    kkt_sizes=(1024, 4096),  # single KKT systems, n + m
    kkt_batched=(512, 128),  # (n + m, B) through jax.vmap
    control_n=4096,  # pendulum horizon of the large single NLP
    fleet=(256, 128),  # (horizon, B) of the MPC fleet
    integ_batch=64,  # continuous-engine sweep width
    timing_reps=5,
    sharded_per_device=16384,  # HS71 lanes per GPU in the sharded sweep
    sharded_integ_per_device=16,  # continuous-engine lanes per GPU
    schur_blocks_per_device=128,  # distributed Schur: 3x3 blocks per GPU
    schur_m=64,  # distributed Schur: dual rows
)

# reference parity anchors (iterations, accepted steps), identical to the
# reference PyGradFlow on the same problems and starts
ANCHORS = {"rosenbrock": (30, 25), "hs71": (19, 13), "tame": (7, 7)}

# the continuous engine's HS71 anchors.  TR-BDF2 (the default method)
# reproduces the reference's event sequence: 10 segments.  SDIRK4 takes at
# most 270 steps; its segment count is not a device-independent number:
# near the optimum the penalty criterion <rhs, grad L> tends to zero from
# below, so whether it crosses zero before the convergence event (one
# more penalty segment) is decided by rounding.  On the CPU it gives 10
# segments, on an H100 9.  The SDIRK4 check is therefore agreement of the
# device loop with the host driver on the same device.
TRBDF2_SEGMENTS, SDIRK4_MAX_STEPS = 10, 270

# KKT tier tolerances.  The tier factors in f32 and refines three times in
# f64; on these well-conditioned saddle systems (K = HH^T + nI, -0.1 I dual
# block) each pass gains about seven digits, so the normwise backward error
# reaches the f64 floor and the solution agrees with an f64 direct solve to
# far better than 1e-9.
KKT_BACKWARD_ERROR = 1e-12
KKT_RTOL = 1e-9


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def median_time(fn, reps):
    """Median wall time of ``fn()`` (which must block on its result)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _problems():
    sys.path.insert(0, REPO)
    from tests import problems

    return problems


def _rosenbrock_starts(batch):
    rng = np.random.default_rng(0)
    return rng.uniform(-1.5, 1.5, size=(batch, 2))


def _hs71_starts(batch, seed=1):
    rng = np.random.default_rng(seed)
    base = np.array([1.0, 5.0, 5.0, 1.0, 0.0])
    lb = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
    ub = np.array([5.0, 5.0, 5.0, 5.0, 10.0])
    pert = rng.uniform(-0.5, 0.5, size=(batch, 5))
    return np.clip(base[None, :] + pert, lb, ub)


def _hs71_integration_starts(batch, inst):
    rng = np.random.default_rng(7)
    lo = np.array([1.0, 1.0, 1.0, 1.0, 0.0])
    hi = np.array([5.0, 5.0, 5.0, 5.0, 2.0])
    return np.clip(
        inst.x_0[None, :] + rng.uniform(-0.1, 0.1, size=(batch, 5)), lo, hi
    )


# ----------------------------------------------------------------------
# one-GPU phases
# ----------------------------------------------------------------------


def phase_single(sizes):
    """Default f64 Symmetric+LU path on the three parity anchors."""
    from pygradflow_tpu import Params, Solver, SolverStatus

    problems = _problems()
    out = {}
    for name, make in (
        ("rosenbrock", problems.rosenbrock_instance),
        ("hs71", problems.hs71_instance),
        ("tame", problems.tame_instance),
    ):
        inst = make()
        t0 = time.perf_counter()
        res = Solver(inst.problem, Params()).solve(inst.x_0, inst.y_0)
        wall = time.perf_counter() - t0
        err = float(np.abs(np.asarray(res.x) - inst.x_opt).max())
        check(res.status == SolverStatus.Optimal, f"{name}: {res.status}")
        counts = (res.iterations, res.num_accepted_steps)
        check(counts == ANCHORS[name], f"{name}: counts {counts} != {ANCHORS[name]}")
        check(err <= 1e-6, f"{name}: |x - x_opt| = {err}")
        out[name] = dict(
            iterations=counts[0], accepted=counts[1], x_err=err, wall_s_with_compile=wall
        )
    return out


def _sweep(problem, x0s, y0s, sizes, label):
    from pygradflow_tpu import Params, Solver, SolverStatus
    from pygradflow_tpu.parallel import BatchedSolver

    params = Params(opt_tol=1e-6, validate_input=False)
    solver = BatchedSolver(problem, params)
    t0 = time.perf_counter()
    res = solver.solve(x0s, y0s)
    cold = time.perf_counter() - t0
    check(res.success.all(), f"{label}: {int((~res.success).sum())} lanes not Optimal")

    wall = median_time(lambda: solver.solve(x0s, y0s), sizes["timing_reps"])

    rng = np.random.default_rng(2)
    lanes = np.sort(rng.choice(x0s.shape[0], sizes["parity_lanes"], replace=False))
    single = Solver(problem, params)
    worst = 0.0
    for i in lanes:
        r = single.solve(x0s[i], y0s[i])
        check(
            int(r.status) == int(res.status[i]) == int(SolverStatus.Optimal),
            f"{label} lane {i}: single {r.status} vs batched {int(res.status[i])}",
        )
        check(
            r.iterations == int(res.iterations[i]),
            f"{label} lane {i}: single {r.iterations} vs batched "
            f"{int(res.iterations[i])} iterations",
        )
        x_b, x_s = np.asarray(res.x[i]), np.asarray(r.x)
        np.testing.assert_allclose(x_b, x_s, rtol=1e-10, err_msg=f"{label} lane {i}")
        worst = max(worst, float(np.abs(x_b - x_s).max()))
    return dict(
        batch=int(x0s.shape[0]),
        solves_per_s=x0s.shape[0] / wall,
        median_wall_s=wall,
        first_call_s=cold,
        max_iterations=int(np.max(res.iterations)),
        median_iterations=float(np.median(res.iterations)),
        parity_lanes=int(lanes.size),
        parity_max_abs_dx=worst,
    )


def phase_sweeps(sizes):
    """Scenario sweeps through BatchedSolver, f64, every lane Optimal, and
    sampled lanes identical to the single-instance Solver."""
    problems = _problems()
    B = sizes["sweep_batch"]
    x_r = _rosenbrock_starts(B)
    x_h = _hs71_starts(B)
    return {
        "rosenbrock": _sweep(
            problems.Rosenbrock(), x_r, np.zeros((B, 0)), sizes, "rosenbrock"
        ),
        "hs71": _sweep(problems.HS71(), x_h, np.zeros((B, 2)), sizes, "hs71"),
    }


def saddle(n, m, rng, batch=None):
    """Well-conditioned quasi-definite saddle matrices, as in the tier's
    tests: [[HH^T + nI, J^T], [J, -0.1 I]]."""
    shape = () if batch is None else (batch,)
    H = rng.standard_normal(shape + (n, n))
    K = H @ np.swapaxes(H, -1, -2) + n * np.eye(n)
    J = rng.standard_normal(shape + (m, n))
    top = np.concatenate([K, np.swapaxes(J, -1, -2)], axis=-1)
    bot = np.concatenate([J, np.broadcast_to(-0.1 * np.eye(m), shape + (m, m))], axis=-1)
    return np.concatenate([top, bot], axis=-2)


def _backward_error(A, x, b):
    r = np.einsum("...ij,...j->...i", A, x) - b
    return float(
        np.max(
            np.abs(r).max(-1)
            / (np.abs(A).sum(-1).max(-1) * np.abs(x).max(-1))
        )
    )


def phase_kkt(sizes):
    """The mixed-precision KKT tier (LinearSolverType.PallasLDLT) against
    the f64 LDL^T, the f64 LU and a host NumPy f64 solve; times
    factor+solve of each."""
    import jax
    import jax.numpy as jnp

    from pygradflow_tpu.linalg import linear_solver
    from pygradflow_tpu.params import LinearSolverType

    tiers = {
        "pallas_ldlt": LinearSolverType.PallasLDLT,
        "ldlt": LinearSolverType.LDLT,
        "lu": LinearSolverType.LU,
    }
    cases = [(size, None) for size in sizes["kkt_sizes"]]
    cases.append(tuple(sizes["kkt_batched"]))
    out = {}
    for size, batch in cases:
        n = (3 * size) // 4
        m = size - n
        rng = np.random.default_rng(size)
        A = saddle(n, m, rng, batch)
        b = rng.standard_normal(A.shape[:-1])
        x_host = np.linalg.solve(A, b[..., None])[..., 0]
        A_d, b_d = jnp.asarray(A), jnp.asarray(b)

        label = f"{size}" if batch is None else f"{size}x{batch}"
        row = {}
        xs = {}
        for name, kind in tiers.items():
            lin = linear_solver(kind, symmetric=True)

            def factor_solve(A, b, lin=lin):
                fact = lin.factor(A)
                neg = (
                    lin.num_neg_eigvals(fact)
                    if lin.num_neg_eigvals is not None
                    else jnp.zeros((), jnp.int32)
                )
                return lin.solve(fact, b), neg

            fn = jax.jit(factor_solve if batch is None else jax.vmap(factor_solve))
            x, neg = jax.block_until_ready(fn(A_d, b_d))
            ms = 1e3 * median_time(
                lambda: jax.block_until_ready(fn(A_d, b_d)), sizes["timing_reps"]
            )
            x = np.asarray(x)
            xs[name] = x
            dx = float(np.abs(x - x_host).max() / np.abs(x_host).max())
            row[name] = dict(ms=ms, backward_error=_backward_error(A, x, b), rel_dx_host=dx)
            check(dx <= KKT_RTOL, f"{label} {name}: |x - x_host| rel {dx}")
            if name != "lu":
                check(
                    bool(np.all(np.asarray(neg) == m)),
                    f"{label} {name}: inertia {np.unique(np.asarray(neg))} != {m}",
                )

        berr = row["pallas_ldlt"]["backward_error"]
        check(berr <= KKT_BACKWARD_ERROR, f"{label}: tier backward error {berr}")
        dx = float(
            np.abs(xs["pallas_ldlt"] - xs["ldlt"]).max() / np.abs(xs["ldlt"]).max()
        )
        check(dx <= KKT_RTOL, f"{label}: tier vs f64 LDL^T rel {dx}")
        out[label] = row
    return out


def _control_params(mixed):
    from pygradflow_tpu import LinearSolverType, Params, StepSolverType

    kwargs = dict(
        step_solver_type=StepSolverType.Schur,
        schur_block_size=3,
        schur_dual_block_size=2,
        matrix_free=True,
        iteration_limit=3000,
        validate_input=False,
    )
    if mixed:
        kwargs["linear_solver_type"] = LinearSolverType.PallasLDLT
    return Params(**kwargs)


def phase_control(sizes):
    """Pendulum swing-up: one long horizon through Solver and an MPC fleet
    through BatchedSolver, both on the matrix-free staged Schur path with
    the mixed-precision tier, against the pure f64 staged path."""
    import jax
    import jax.numpy as jnp

    from pygradflow_tpu import Solver, SolverStatus
    from pygradflow_tpu.parallel import BatchedSolver
    from pygradflow_tpu.runners.control import PendulumControlInterleaved

    out = {}

    N = sizes["control_n"]
    prob = PendulumControlInterleaved(N=N)
    x0 = prob.x0_trajectory()
    y0 = np.zeros(prob.num_cons)
    objs = {}
    for label, mixed in (("mixed", True), ("f64", False)):
        solver = Solver(prob, _control_params(mixed))
        t0 = time.perf_counter()
        res = solver.solve(x0, y0)
        cold = time.perf_counter() - t0
        check(res.status == SolverStatus.Optimal, f"N={N} {label}: {res.status}")
        t0 = time.perf_counter()
        solver.solve(x0, y0)
        warm = time.perf_counter() - t0
        objs[label] = float(prob.obj(jnp.asarray(res.x)))
        out[f"single_{label}"] = dict(
            N=N, iterations=res.iterations, objective=objs[label],
            first_call_s=cold, wall_s=warm,
        )
    rel = abs(objs["mixed"] - objs["f64"]) / abs(objs["f64"])
    check(rel <= 1e-6, f"N={N}: objective mixed vs f64 rel {rel}")
    out["single_objective_rel_diff"] = rel

    N, B = sizes["fleet"]
    prob = PendulumControlInterleaved(N=N)
    rng = np.random.default_rng(0)
    base = prob.x0_trajectory()
    x0s = base[None, :] + 0.02 * rng.standard_normal((B, base.size))
    obj = jax.jit(jax.vmap(prob.obj))
    fleet_objs = {}
    for label, mixed in (("mixed", True), ("f64", False)):
        solver = BatchedSolver(prob, _control_params(mixed))
        res = solver.solve(x0s)
        check(res.success.all(), f"fleet {label}: {int((~res.success).sum())} lanes not Optimal")
        wall = median_time(lambda: solver.solve(x0s), sizes["timing_reps"])
        fleet_objs[label] = np.asarray(obj(jnp.asarray(res.x)))
        out[f"fleet_{label}"] = dict(
            N=N, batch=B, solves_per_s=B / wall, median_wall_s=wall,
            max_iterations=int(np.max(res.iterations)),
        )
    rel = float(
        np.max(np.abs(fleet_objs["mixed"] - fleet_objs["f64"]) / np.abs(fleet_objs["f64"]))
    )
    check(rel <= 1e-6, f"fleet: objective mixed vs f64 rel {rel}")
    out["fleet_objective_rel_diff"] = rel
    return out


def phase_integration(sizes):
    """Continuous engine: the device loop's HS71 anchors (TR-BDF2 segment
    count; SDIRK4 step cap and agreement with the host driver), then a
    perturbed-HS71 sweep through BatchedIntegrationSolver."""
    from pygradflow_tpu import IntegrationMethod, Params, SolverStatus
    from pygradflow_tpu.integration import BatchedIntegrationSolver, IntegrationSolver

    problems = _problems()
    inst = problems.hs71_instance()
    out = {}
    for name, method in (
        ("trbdf2", IntegrationMethod.TRBDF2),
        ("sdirk4", IntegrationMethod.SDIRK4),
    ):
        params = Params(
            iteration_limit=1000,
            rho=1e-2,
            integration_device_loop=True,
            integration_method=method,
        )
        t0 = time.perf_counter()
        res = IntegrationSolver(inst.problem, params).solve(inst.x_0, inst.y_0)
        cold = time.perf_counter() - t0
        err = float(np.abs(np.asarray(res.x) - inst.x_opt).max())
        check(res.status == SolverStatus.Optimal, f"hs71 {name}: {res.status}")
        check(err <= 1e-6, f"hs71 {name}: |x - x_opt| = {err}")
        out[name] = dict(
            segments=res.iterations, steps=int(res.num_integration_steps),
            x_err=err, wall_s_with_compile=cold,
        )
    check(
        out["trbdf2"]["segments"] == TRBDF2_SEGMENTS,
        f"hs71 trbdf2: {out['trbdf2']['segments']} segments",
    )
    check(
        out["sdirk4"]["steps"] <= SDIRK4_MAX_STEPS,
        f"hs71 sdirk4: {out['sdirk4']['steps']} steps",
    )
    host = IntegrationSolver(
        inst.problem,
        Params(iteration_limit=1000, rho=1e-2, integration_method=IntegrationMethod.SDIRK4),
    ).solve(inst.x_0, inst.y_0)
    check(
        (host.iterations, host.num_integration_steps)
        == (out["sdirk4"]["segments"], out["sdirk4"]["steps"]),
        f"hs71 sdirk4: host driver {host.iterations} segments / "
        f"{host.num_integration_steps} steps vs device loop {out['sdirk4']}",
    )
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(host.x), rtol=1e-12)

    B = sizes["integ_batch"]
    x0s = _hs71_integration_starts(B, inst)
    y0s = np.tile(inst.y_0, (B, 1))
    bparams = Params(
        iteration_limit=1000,
        rho=1e-2,
        integration_max_steps=50_000,
        integration_method=IntegrationMethod.SDIRK4,
    )
    solver = BatchedIntegrationSolver(inst.problem, bparams)
    res = solver.solve(x0s, y0s)
    check(res.success.all(), f"integration sweep: {int((~res.success).sum())} lanes not Optimal")
    t0 = time.perf_counter()
    solver.solve(x0s, y0s)
    wall = time.perf_counter() - t0
    out["batched"] = dict(
        batch=B, solves_per_s=B / wall, wall_s=wall,
        max_steps=int(np.max(res.num_integration_steps)),
    )
    return out


def phase_single_precision(sizes):
    """Precision.Single Rosenbrock sweep: every lane converges."""
    from pygradflow_tpu import Params, Precision
    from pygradflow_tpu.parallel import BatchedSolver

    problems = _problems()
    B = sizes["sweep_batch"]
    x0s = _rosenbrock_starts(B)
    params = Params(
        validate_input=False, precision=Precision.Single, opt_tol=1e-4, lamb_min=1e-6
    )
    solver = BatchedSolver(problems.Rosenbrock(), params)
    res = solver.solve(x0s)
    check(res.success.all(), f"f32 sweep: {int((~res.success).sum())} lanes not Optimal")
    err = float(np.abs(np.asarray(res.x) - 1.0).max())
    check(err < 1e-2, f"f32 sweep: |x - 1| = {err}")
    wall = median_time(lambda: solver.solve(x0s), sizes["timing_reps"])
    return dict(batch=B, solves_per_s=B / wall, median_wall_s=wall, x_err=err)


PHASES = (
    ("single", phase_single),
    ("sweeps", phase_sweeps),
    ("kkt", phase_kkt),
    ("control", phase_control),
    ("integration", phase_integration),
    ("single_precision", phase_single_precision),
)


# ----------------------------------------------------------------------
# four-GPU phase
# ----------------------------------------------------------------------


def phase_four_gpus(sizes):
    """Sharded drivers on a 1-D mesh over four devices, each against its
    one-device or host counterpart."""
    import jax
    import jax.numpy as jnp
    import scipy.linalg as sla
    from jax.sharding import Mesh

    from pygradflow_tpu import IntegrationMethod, Params
    from pygradflow_tpu.integration import ShardedIntegrationSolver
    from pygradflow_tpu.parallel import BatchedSolver, ShardedSolver
    from pygradflow_tpu.parallel.schur import distributed_schur_solve

    problems = _problems()
    devices = jax.devices()[:4]
    check(len(devices) == 4, f"need 4 devices, found {len(devices)}")
    D = len(devices)
    out = {}

    # ShardedSolver vs BatchedSolver on one device
    B = D * sizes["sharded_per_device"]
    x0s = _hs71_starts(B)
    y0s = np.zeros((B, 2))
    params = Params(opt_tol=1e-6, validate_input=False)
    mesh = Mesh(np.array(devices), ("instances",))
    sharded = ShardedSolver(problems.HS71(), params, mesh=mesh)
    res = sharded.solve(x0s, y0s)
    # information only: three warm runs each, four cards vs one
    reps = min(3, sizes["timing_reps"])
    wall = median_time(lambda: sharded.solve(x0s, y0s), reps)
    with jax.default_device(devices[0]):
        batched = BatchedSolver(problems.HS71(), params)
        ref = batched.solve(x0s, y0s)
        ref_wall = median_time(lambda: batched.solve(x0s, y0s), reps)
    np.testing.assert_array_equal(np.asarray(res.status), np.asarray(ref.status))
    np.testing.assert_array_equal(np.asarray(res.iterations), np.asarray(ref.iterations))
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), rtol=1e-12)
    check(res.success.all(), f"sharded sweep: {int((~res.success).sum())} lanes not Optimal")
    out["sharded_sweep"] = dict(
        batch=B, devices=D, solves_per_s=B / wall, one_device_solves_per_s=B / ref_wall,
    )

    # distributed Schur solve vs the dense host solve
    rng = np.random.default_rng(1)
    nb, b, m = D * sizes["schur_blocks_per_device"], 3, sizes["schur_m"]
    hb = rng.standard_normal((nb, b, b))
    hb = hb @ np.swapaxes(hb, -1, -2) + 3.0 * np.eye(b)
    jac = rng.standard_normal((m, nb * b))
    m22 = -0.5 * np.eye(m)
    rx, ry = rng.standard_normal(nb * b), rng.standard_normal(m)
    smesh = Mesh(np.array(devices), ("blocks",))
    args = [jnp.asarray(v) for v in (hb, jac, m22, rx, ry)]
    sx, sy = distributed_schur_solve(*args, mesh=smesh)
    K = np.block([[sla.block_diag(*hb), jac.T], [jac, m22]])
    ref_xy = np.linalg.solve(K, np.concatenate([rx, ry]))
    got = np.concatenate([np.asarray(sx), np.asarray(sy)])
    np.testing.assert_allclose(got, ref_xy, rtol=1e-9, atol=1e-11)
    out["distributed_schur"] = dict(
        blocks=nb, m=m, max_abs_err=float(np.abs(got - ref_xy).max())
    )

    # continuous engine sharded over the same mesh
    inst = problems.hs71_instance()
    Bi = D * sizes["sharded_integ_per_device"]
    xi = _hs71_integration_starts(Bi, inst)
    iparams = Params(
        iteration_limit=1000,
        rho=1e-2,
        integration_max_steps=50_000,
        integration_method=IntegrationMethod.SDIRK4,
    )
    t0 = time.perf_counter()
    ires = ShardedIntegrationSolver(inst.problem, iparams, mesh=mesh).solve(
        xi, np.tile(inst.y_0, (Bi, 1))
    )
    check(ires.success.all(), f"sharded continuous: {int((~ires.success).sum())} lanes not Optimal")
    out["sharded_integration"] = dict(
        batch=Bi, wall_s_with_compile=time.perf_counter() - t0,
        x_err=float(np.abs(np.asarray(ires.x) - inst.x_opt[None, :]).max()),
    )
    return out


FOUR_GPU_PHASES = (("four_gpus", phase_four_gpus),)


# ----------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------


def require_gpus(count):
    """The JAX devices, or SystemExit when there are fewer than ``count``
    GPUs.  There is no CPU fallback."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}"
        )
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found {len(devices)}")
    return devices


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-gpus",
        action="store_true",
        help="run only the sharded paths, on a mesh over four GPUs",
    )
    args = parser.parse_args(argv)

    import jax

    devices = require_gpus(4 if args.four_gpus else 1)
    cards = card_lines()
    for line in cards:
        print(f"card: {line}")
    tag = cards[0]
    print(
        f"jax {jax.__version__}, device_kind {devices[0].device_kind}, "
        f"{len(devices)} device(s) [{tag}]",
        flush=True,
    )

    sys.path.insert(0, REPO)
    import pygradflow_tpu  # noqa: F401  (x64 + compile cache)

    failed = []
    for name, fn in FOUR_GPU_PHASES if args.four_gpus else PHASES:
        t0 = time.perf_counter()
        try:
            metrics = fn(FULL)
        except Exception:  # noqa: BLE001 — reported, and the exit code says so
            traceback.print_exc()
            print(f"{name}: FAILED [{tag}]", flush=True)
            failed.append(name)
            continue
        metrics["phase_s"] = time.perf_counter() - t0
        print(f"{name}: {json.dumps(metrics)} [{tag}]", flush=True)

    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
