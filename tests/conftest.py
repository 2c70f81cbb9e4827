import os
import shutil
import subprocess
import sys

import pytest

# The suite runs on the CPU backend with 8 virtual devices, so the mesh code
# paths run without a card.  The live config is set as well as the
# environment because jax may already be imported; its CPU client is
# created lazily at the first jax op, so XLA_FLAGS still takes effect.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one (run: pytest -m gpu tests/)"
    )
    config.addinivalue_line("markers", "slow: long-running; the tier-1 run deselects it")


@pytest.fixture
def gpu():
    """Skip unless nvidia-smi lists a card.  Asked here, at run time, so
    every worker collects the same tests."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    out = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no NVIDIA GPU listed by nvidia-smi")
    return out.stdout
