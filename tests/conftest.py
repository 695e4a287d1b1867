"""Shared test fixtures.

NOTE: XLA_FLAGS / device-count forcing is deliberately NOT set here —
smoke tests and benches must see the single real device.  Multi-device
tests spawn subprocesses with their own XLA_FLAGS (see _subproc helper).
"""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_multidevice(code: str, n_devices: int = 8) -> str:
    """Run ``code`` in a fresh python with n virtual devices; returns
    stdout.  Raises on failure with combined output."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, env=env, timeout=560,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{proc.stdout}\n"
            f"STDERR:\n{proc.stderr[-3000:]}")
    return proc.stdout


@pytest.fixture(scope="session")
def multidevice():
    return run_multidevice


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one); run on the "
        "GPU machine with `python -m pytest -m gpu tests/test_torch_gpu.py`")
