"""Test configuration: a virtual 8-device CPU mesh unless told otherwise.

The suite runs on the CPU backend with 8 virtual devices (the host-device
count XLA flag is set before any backend initializes), so the mesh tests
see a multi-device backend. ``JAX_PLATFORMS``, when set, is honoured —
``JAX_PLATFORMS=cuda pytest -m gpu tests/`` runs the card's tests on the
card — and when unset the CPU is pinned.

Tests marked ``gpu`` need an NVIDIA card. Whether one is present is
decided inside a fixture at run time (never while a module is imported,
which would let pytest-xdist workers collect different tests), and
without touching JAX: a JAX process reserves most of the card's memory
when it first uses it, and the ``gpu`` tests run the program in child
processes that need the card to themselves.
"""

import os
import shutil
import subprocess
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")


def gpu_present() -> bool:
    """Whether ``nvidia-smi`` lists a card and JAX may use it."""
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and not {"cuda", "gpu"} & set(plat.split(",")):
        return False
    if shutil.which("nvidia-smi") is None:
        return False
    r = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    return r.returncode == 0 and "GPU" in r.stdout


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") and not gpu_present():
        pytest.skip("needs an NVIDIA GPU: run `JAX_PLATFORMS=cuda pytest "
                    "-m gpu tests/` on the card")
