"""Runner harness and adapters: HS suite solves, CSV output schema,
MPS parsing + LP solve."""

import csv
import os
import textwrap

import numpy as np
import pytest

from pygradflow_tpu import Params, Solver


HS_QUICK = [
    "hs3", "hs6", "hs8", "hs9", "hs10", "hs11", "hs12", "hs15", "hs16",
    "hs21", "hs22", "hs23", "hs24", "hs26", "hs27", "hs28", "hs29", "hs30",
    "hs31", "hs35", "hs36", "hs37", "hs41", "hs42", "hs43", "hs46", "hs47",
    "hs48", "hs49", "hs50", "hs51", "hs52", "hs53", "hs76", "hs77",
    # round-4 additions with clean convergence to the book optimum
    "hs19", "hs32", "hs61", "hs73", "hs80", "hs110", "hs111", "hs118",
    "hs83", "hs86", "hs108", "hs112",
    # hs20 is excluded: from the clipped start the flow converges to the
    # symmetric local KKT point at x1=-0.5 (f = book f_opt + 2);
    # hs13/hs25/hs72/hs81/hs106 are excluded here because their verified
    # behavior is REFERENCE PARITY rather than the book optimum (flat
    # plateau / rounded book value / secondary KKT point / joint failure
    # — see the spec comments in runners/hs.py); hs62 converges but
    # needs ~2400 iterations (covered by the sweep, not the quick test)
]


@pytest.mark.parametrize("name", HS_QUICK)
def test_hs_known_optimum(name):
    from pygradflow_tpu.runners.hs import HS_BY_NAME

    spec = HS_BY_NAME[name]
    result = Solver(spec.problem(), Params()).solve(spec.x0)
    assert result.success, f"{name}: {result.status}"
    if spec.x_opt is not None:
        # hs3 is nearly flat in x1 (1e-5 coefficient); hs26/46/47/49/50
        # have quartic/sextic-degenerate optima: the 1e-6 KKT tolerance
        # admits points ~1e-2 from the minimizer
        degenerate = ("hs3", "hs26", "hs46", "hs47", "hs49", "hs50")
        atol = 1e-1 if name in degenerate else 1e-4
        np.testing.assert_allclose(result.x, spec.x_opt, atol=atol)
    if spec.f_opt is not None:
        x_val = float(spec.problem().obj(np.asarray(result.x)))
        assert abs(x_val - spec.f_opt) < 1e-5


def test_runner_csv(tmp_path):
    from pygradflow_tpu.runners.hs_runner import HSRunner

    out = str(tmp_path / "out")
    HSRunner().main(["--output", out, "--name", "hs28", "--iteration_limit", "200"])

    with open(os.path.join(out, "output.csv")) as f:
        rows = list(csv.DictReader(f))

    assert len(rows) == 1
    row = rows[0]
    assert row["instance"] == "hs28"
    assert row["status"] == "optimal"
    assert float(row["final_stat_res"]) < 1e-6
    assert int(row["iterations"]) > 0

    assert os.path.exists(os.path.join(out, "params.yml"))
    assert os.path.exists(os.path.join(out, "hs28.log"))


MPS_SAMPLE = textwrap.dedent(
    """\
    NAME          SAMPLE
    ROWS
     N  COST
     L  LIM1
     G  LIM2
     E  EQ1
    COLUMNS
        X1        COST      1.0        LIM1      1.0
        X1        LIM2      1.0
        X2        COST      2.0        LIM1      1.0
        X2        EQ1       1.0
        X3        COST      -1.0       EQ1       1.0
    RHS
        RHS       LIM1      4.0        LIM2      1.0
        RHS       EQ1       7.0
    BOUNDS
     UP BND       X1        4.0
     LO BND       X2        -1.0
    ENDATA
    """
)


def test_mps_parse_and_solve(tmp_path):
    path = tmp_path / "sample.mps"
    path.write_text(MPS_SAMPLE)

    from pygradflow_tpu.runners.mps import parse_mps
    from pygradflow_tpu.runners.mps_runner import MPSProblem

    data = parse_mps(str(path))
    assert data.name == "SAMPLE"
    assert data.A.shape == (3, 3)
    np.testing.assert_allclose(data.c, [1.0, 2.0, -1.0])
    np.testing.assert_allclose(data.cons_ub, [4.0, np.inf, 7.0])
    np.testing.assert_allclose(data.cons_lb, [-np.inf, 1.0, 7.0])
    np.testing.assert_allclose(data.var_ub, [4.0, np.inf, np.inf])
    np.testing.assert_allclose(data.var_lb, [0.0, -1.0, 0.0])

    # LP: min x1 + 2 x2 - x3 s.t. x1+x2<=4, x1>=1, x2+x3=7, bounds
    # optimum: x1=1, x2=-1, x3=8 -> obj = 1 - 2 - 8 = -9
    result = Solver(MPSProblem(data), Params()).solve()
    assert result.success
    np.testing.assert_allclose(result.x, [1.0, -1.0, 8.0], atol=1e-5)


def test_qp_runner_instances():
    from pygradflow_tpu.runners.qp_runner import QPRunner, random_eq_qp

    problem = random_eq_qp(16, 4, seed=1)
    result = Solver(problem, Params()).solve()
    assert result.success

    # KKT check: Qx + c + A^T y = 0, Ax = b
    Q = np.asarray(problem.Q)
    c = np.asarray(problem.c)
    A = np.asarray(problem.A)
    np.testing.assert_allclose(
        Q @ result.x + c + A.T @ result.y, 0.0, atol=1e-6
    )
    np.testing.assert_allclose(A @ result.x, problem.cons_lb, atol=1e-6)


def test_mps_native_matches_python(tmp_path):
    """The C++ reader must produce identical data to the Python parser."""
    from pygradflow_tpu.native import available, parse_mps_native
    from pygradflow_tpu.runners.mps import parse_mps_py

    if not available():
        pytest.skip("native MPS reader not built")

    path = tmp_path / "sample.mps"
    path.write_text(MPS_SAMPLE)

    d_native = parse_mps_native(str(path))
    d_py = parse_mps_py(str(path))

    assert d_native.name == d_py.name
    np.testing.assert_array_equal(d_native.c, d_py.c)
    np.testing.assert_array_equal(d_native.A, d_py.A)
    np.testing.assert_array_equal(d_native.cons_lb, d_py.cons_lb)
    np.testing.assert_array_equal(d_native.cons_ub, d_py.cons_ub)
    np.testing.assert_array_equal(d_native.var_lb, d_py.var_lb)
    np.testing.assert_array_equal(d_native.var_ub, d_py.var_ub)
    assert d_native.obj_offset == d_py.obj_offset


def test_runner_fails_on_unavailable_backend(tmp_path):
    """A backend that cannot start fails the sweep before any output; the
    runner does not carry on on another device."""
    import subprocess
    import sys

    out = tmp_path / "out"
    code = (
        "from pygradflow_tpu.runners.hs_runner import HSRunner\n"
        f"HSRunner().main(['--output', {str(out)!r}, '--name', 'hs28'])\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=dict(os.environ, JAX_PLATFORMS="rocm"),  # a backend the CPU and CUDA builds lack
        capture_output=True,
        text=True,
        timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode != 0
    assert not out.exists()
