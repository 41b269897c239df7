"""``chip_smoke.py``: its phases at tiny sizes on the CPU, and its refusal
to run anywhere but on a GPU."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = dict(
    sweep_batch=8,
    parity_lanes=2,
    kkt_sizes=(64, 160),
    kkt_batched=(96, 3),
    control_n=16,
    fleet=(8, 2),
    integ_batch=2,
    timing_reps=1,
    sharded_per_device=2,
    sharded_integ_per_device=1,
    schur_blocks_per_device=2,
    schur_m=4,
)


@pytest.mark.parametrize(
    "phase", [fn for _, fn in chip_smoke.PHASES + chip_smoke.FOUR_GPU_PHASES],
    ids=[name for name, _ in chip_smoke.PHASES + chip_smoke.FOUR_GPU_PHASES],
)
def test_phase_runs_at_tiny_size(phase):
    metrics = phase(TINY)
    json.dumps(metrics)  # printable as one JSON line


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_fails_without_gpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True,
        text=True,
        timeout=300,
        cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_script_alone_fails(tmp_path):
    """Copied without the package, the script fails before any result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    proc = subprocess.run(
        [sys.executable, str(script)],
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True,
        text=True,
        timeout=300,
        cwd=tmp_path,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
