"""``bench.py`` measures on a GPU only: without one it exits non-zero and
prints no result."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_refuses_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=dict(os.environ, JAX_PLATFORMS="cpu", BENCH_BATCH="8"),
        capture_output=True,
        text=True,
        timeout=300,
        cwd=REPO,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs a GPU" in proc.stderr
