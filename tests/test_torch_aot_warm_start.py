"""The port's persistent compile store across processes: a second process
pointed at the store restores the first one's compile (one pair of
subprocesses that import no JAX).  Kept apart from
``tests/test_torch_aot_store.py`` so that the suite's ``loadfile``
scheduler runs it beside ``tests/test_differential.py`` rather than
ahead of it.  The outputs of the two processes are equal exactly."""
import json
import os
import subprocess
import sys

from tests.test_torch_aot_store import (  # noqa: F401
    ROOT, _CHILD, _isolate_cache)


def test_cross_process_warm_start(tmp_path):
    """A second *process* pointed at the same store restores the first
    one's compile instead of planning it again."""
    env = dict(os.environ, REPRO_AOT_CACHE_DIR=str(tmp_path),
               PYTHONPATH=os.path.join(ROOT, "src"))
    runs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _CHILD, "2.5"],
                              env=env, capture_output=True, text=True,
                              cwd=ROOT, timeout=300)
        assert proc.returncode == 0, proc.stderr
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert cold["restored"] is False and cold["disk_hits"] == 0
    assert warm["restored"] is True and warm["disk_hits"] == 1
    assert warm["y"] == cold["y"]
    assert not cold["jax"] and not warm["jax"]
