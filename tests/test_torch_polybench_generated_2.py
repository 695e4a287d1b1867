"""Cases of ``tests/test_torch_polybench.py`` in a file of at most 8 tests,
so that pytest-xdist's ``loadfile`` scheduler (largest files first) runs
them beside ``tests/test_differential.py`` rather than ahead of it.
Each test keeps its name and case ids; its body is the helper of the
same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_polybench import (
    POLYBENCH_GENERATED_KERNELS_NAME, polybench_generated_kernels)


@pytest.mark.parametrize("name", POLYBENCH_GENERATED_KERNELS_NAME[6:12])
def test_polybench_generated_kernels(name):
    """``polybench_generated_kernels`` of
    ``tests/test_torch_polybench.py``, its ``name`` cases 6 to 11 (from
    0)."""
    polybench_generated_kernels(name=name)
