"""Cases of ``tests/test_torch_master_worker.py`` in a file of at most 8
tests, so that pytest-xdist's ``loadfile`` scheduler (largest files
first) runs them beside ``tests/test_differential.py`` rather than ahead
of it.  Each test keeps its name and case ids; its body is the helper of
the same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_master_worker import (
    MASTER_WORKER_FAMILIES,
    MASTER_WORKER_P,
    every_family_matches_jax_reference_under_master_worker)


@pytest.mark.parametrize(
    "p", MASTER_WORKER_P)
@pytest.mark.parametrize("family", MASTER_WORKER_FAMILIES[0:2])
def test_every_family_matches_jax_reference_under_master_worker(family, p):
    """``every_family_matches_jax_reference_under_master_worker`` of
    ``tests/test_torch_master_worker.py``, its ``family`` cases 0 to 1
    (from 0)."""
    every_family_matches_jax_reference_under_master_worker(family=family, p=p)
