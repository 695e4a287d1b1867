"""Cases of ``tests/test_torch_polybench.py`` in a file of at most 8 tests,
so that pytest-xdist's ``loadfile`` scheduler (largest files first) runs
them beside ``tests/test_differential.py`` rather than ahead of it.
Each test keeps its name and case ids; its body is the helper of the
same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_polybench import (
    POLYBENCH_KERNEL_MATCHES_REFERENCE_NAME,
    polybench_kernel_matches_reference)


@pytest.mark.parametrize("name", POLYBENCH_KERNEL_MATCHES_REFERENCE_NAME[0:6])
def test_polybench_kernel_matches_reference(name):
    """``polybench_kernel_matches_reference`` of
    ``tests/test_torch_polybench.py``, its ``name`` cases 0 to 5 (from
    0)."""
    polybench_kernel_matches_reference(name=name)
