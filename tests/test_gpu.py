"""Tests that need the NVIDIA card (marker ``gpu``; skipped elsewhere).

Run on the card with ``JAX_PLATFORMS=cuda pytest -m gpu tests/``. Each test
runs the program in a child process, which then has the card to itself.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.gpu
def test_soak_on_gpu_backend(tmp_path):
    """The live topology (sender -> UDP capture -> shm ring -> compute on
    the card -> sink, paf-baseband2power.py:117-127) holds real time."""
    env = dict(os.environ, JAX_PLATFORMS="cuda",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu.cli.paf_soak",
         "--seconds", "8", "--rate", "1.0", "--ndf", "1024", "--nchk", "2",
         "--nports", "1", "--nblk", "8", "--fetch-every", "8",
         "--port-base", "29760", "-k", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["backend"] == "gpu", report
    assert report["pass"], report
    assert report["loss"] <= 0.05
