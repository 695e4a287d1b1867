"""Cases of ``tests/test_torch_polybench.py`` in a file of at most 8 tests,
so that pytest-xdist's ``loadfile`` scheduler (largest files first) runs
them beside ``tests/test_differential.py`` rather than ahead of it.
Each test keeps its name and case ids; its body is the helper of the
same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_polybench import (
    JACOBI2D_PLAN_ARTIFACTS_EQUAL_REFERENCE_SHARD,
    POLYBENCH_VALUE_AXES_TILED_NAME,
    jacobi2d_plan_artifacts_equal_reference, polybench_value_axes_tiled)


@pytest.mark.parametrize("name", POLYBENCH_VALUE_AXES_TILED_NAME)
def test_polybench_value_axes_tiled(name, monkeypatch):
    """``polybench_value_axes_tiled`` of
    ``tests/test_torch_polybench.py``, every case."""
    polybench_value_axes_tiled(name=name, monkeypatch=monkeypatch)


@pytest.mark.parametrize(
    "shard", JACOBI2D_PLAN_ARTIFACTS_EQUAL_REFERENCE_SHARD)
def test_jacobi2d_plan_artifacts_equal_reference(shard):
    """``jacobi2d_plan_artifacts_equal_reference`` of
    ``tests/test_torch_polybench.py``, every case."""
    jacobi2d_plan_artifacts_equal_reference(shard=shard)
