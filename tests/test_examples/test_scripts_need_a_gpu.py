"""chip_smoke.py and bench.py measure the GPU: without one they exit
nonzero and never print the smoke run's success line."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=240,
    )


def test_chip_smoke_refuses_the_cpu():
    out = _run("chip_smoke.py", REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "not a GPU" in out.stderr


def test_chip_smoke_four_cards_refuses_the_cpu():
    out = _run("chip_smoke.py", REPO, "--four-cards")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run("chip_smoke.py", str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_refuses_the_cpu():
    out = _run("bench.py", REPO)
    assert out.returncode != 0
    assert "measures the GPU" in out.stderr
