"""Cases of ``tests/test_torch_region.py`` in a file of at most 8 tests, so
that pytest-xdist's ``loadfile`` scheduler (largest files first) runs
them beside ``tests/test_differential.py`` rather than ahead of it.
Each test keeps its name and case ids; its body is the helper of the
same name without ``test_`` in the source file, which holds the case
lists too.
"""
import pytest

from tests.test_torch_region import (
    REGION_FAMILY_OUTPUTS_MATCH_JAX_FAMILY,
    REGION_FAMILY_OUTPUTS_MATCH_JAX_P, region_family_outputs_match_jax)


@pytest.mark.parametrize("p", REGION_FAMILY_OUTPUTS_MATCH_JAX_P)
@pytest.mark.parametrize("family", REGION_FAMILY_OUTPUTS_MATCH_JAX_FAMILY[4:6])
def test_region_family_outputs_match_jax(family, p):
    """``region_family_outputs_match_jax`` of
    ``tests/test_torch_region.py``, its ``family`` cases 4 to 5 (from
    0)."""
    region_family_outputs_match_jax(family=family, p=p)
